"""Loss framework (port of losses/core.py): elementary losses with an
inclusive epoch window, and the master container summing them, whole or
over equal groups of frames (loss_chunk, MasterLoss.compute_chunked)."""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

Tensor = torch.Tensor


@dataclass
class LossInputs:
    """What the ported losses read (the JAX bundle's other fields belong
    to losses not ported yet); NHWC layout."""
    epoch: int = 0
    fcams: Optional[Tensor] = None           # (B, H, W, 2) decoder logits
    cl_logits: Optional[Tensor] = None       # (B, K) classifier logits
    glabel: Optional[Tensor] = None          # (B,) int class labels
    raw_img: Optional[Tensor] = None         # (B, H, W, 3) raw [0, 255]
    x_in: Optional[Tensor] = None            # (B, H, W, 3) the model input
    im_recon: Optional[Tensor] = None        # (B, h, w, 3) reconstruction
    seeds: Optional[Tensor] = None           # (B, H, W) int {1, 0, ignore}
    seq_iter: Optional[Tensor] = None        # (B,) clip/video id
    frm_iter: Optional[Tensor] = None        # (B,) frame order in clip
    fg_size: Optional[Tensor] = None         # (B,) fg size estimate
    msk_bbox: Optional[Tensor] = None        # (B, H, W) bbox mask


def softmax_fcams(fcams: Tensor) -> Tensor:
    """Softmax over the decoder's channels (a 1-channel head goes through
    a sigmoid into [1 - s, s])."""
    if fcams.shape[-1] > 1:
        return torch.softmax(fcams, dim=-1)
    s = torch.sigmoid(fcams)
    return torch.cat([1.0 - s, s], dim=-1)


class ElementaryLoss:
    """Base: subclasses implement compute(inputs, t) -> scalar."""

    def __init__(self, lambda_: float = 1.0, start_ep: int = 0,
                 end_ep: int = -1, seg_ignore_idx: int = -255):
        self.lambda_ = float(lambda_)
        self.start_ep = int(start_ep)
        self.end_ep = None if end_ep == -1 else int(end_ep)
        self.seg_ignore_idx = seg_ignore_idx

    def is_on(self, epoch: int) -> bool:
        # the window includes end_ep; -1 means never stop
        if epoch < self.start_ep:
            return False
        return self.end_ep is None or epoch <= self.end_ep

    @property
    def __name__(self) -> str:
        return re.sub(r"(?<!^)(?=[A-Z])", "_",
                      self.__class__.__name__).lower()

    def compute(self, inputs: LossInputs, t: float) -> Tensor:
        raise NotImplementedError

    def compute_numden(self, inputs: LossInputs, t: float
                       ) -> Tuple[Tensor, Tensor]:
        """(numerator, denominator) whose sums over equal chunks of the
        batch give the loss over the whole batch.  The default weight is
        the chunk's frame count, which is right for every loss that
        averages over frames (or over a count proportional to them: the
        CRFs, the ELB priors, the entropy, the reconstruction); a loss
        with a data-dependent denominator (the CE over seeded pixels, the
        masked ELB means of C_BOX) overrides it.  Summed over the ranks'
        shards the same way, they give the loss over the global batch
        (MasterLoss.compute_global)."""
        ref = next((x for x in (inputs.fcams, inputs.cl_logits,
                                inputs.glabel) if x is not None), None)
        b = float(ref.shape[0]) if ref is not None else 1.0
        v = self.compute(inputs, t).float()
        return v * b, torch.full((), b, dtype=torch.float32, device=v.device)


class MasterLoss:
    """Sum of elementary losses: total = sum_i switch_i * loss_i."""

    def __init__(self, losses: Optional[List[ElementaryLoss]] = None):
        self.losses: List[ElementaryLoss] = list(losses or [])

    def add(self, loss: ElementaryLoss) -> None:
        self.losses.append(loss)

    def switches(self, epoch: int) -> List[float]:
        return [1.0 if l.is_on(epoch) else 0.0 for l in self.losses]

    def compute(self, inputs: LossInputs, t: float,
                switches: Optional[List[float]] = None
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
        if not self.losses:
            raise ValueError("MasterLoss empty: add losses before calling")
        if switches is None:
            switches = self.switches(inputs.epoch)
        total = 0.0
        holder: Dict[str, Tensor] = {}
        for loss, on in zip(self.losses, switches):
            # fp32 terms, as JAX's float32 switches promote them
            v = loss.compute(inputs, t).float() * float(on)
            holder[loss.__name__] = v
            total = total + v
        return total, holder

    def compute_chunked(self, inputs: LossInputs, t: float,
                        switches: List[float], chunk: int
                        ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """The losses over equal groups of `chunk` frames (loss_chunk), each
        group's body checkpointed so that the backward holds one group's
        buffers at a time (JAX's lax.map of jax.checkpoint(body)).  Per
        loss: sum_c num_c / max(sum_c den_c, 1) (compute_numden), exact up
        to float association.  The batch must be a whole number of
        chunks, and a loss over clips (clip_len > 1) needs chunks of whole
        clips."""
        b = inputs.fcams.shape[0]
        self.compute_chunked_check(b, chunk)
        if b // chunk == 1:
            return self.compute(inputs, t, switches)
        num, den = self._numden_chunked(inputs, t, chunk)
        return self._combine(num / den.clamp_min(1.0), switches)

    def compute_global(self, inputs: LossInputs, t: float,
                       switches: List[float], group, chunk: int = 0
                       ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """This rank's share of the losses over the dp group's global
        batch (what JAX's global program computes): per loss, the local
        numerator over the denominator summed over the group
        (compute_numden, over groups of `chunk` frames when chunk > 0).
        The shares of the group's ranks sum to the global loss, and so do
        their gradients.  group: the dp group (parallel/mesh.py)."""
        from tcam_wsol_video_tpu_torch.parallel.mesh import all_reduce_
        b = inputs.fcams.shape[0] if inputs.fcams is not None else 0
        if chunk > 0 and b // chunk > 1:
            self.compute_chunked_check(b, chunk)
            num, den = self._numden_chunked(inputs, t, chunk)
        else:
            nums, dens = zip(*(loss.compute_numden(inputs, t)
                               for loss in self.losses))
            num = torch.stack([n.float() for n in nums])
            den = torch.stack([d.float() for d in dens])
        den = all_reduce_(den.detach().clone(), group)
        return self._combine(num / den.clamp_min(1.0), switches)

    def _combine(self, per_loss: Tensor, switches: List[float]
                 ) -> Tuple[Tensor, Dict[str, Tensor]]:
        holder = {loss.__name__: per_loss[i] * float(on)
                  for i, (loss, on) in enumerate(zip(self.losses, switches))}
        total = 0.0
        for v in holder.values():
            total = total + v
        return total, holder

    def compute_chunked_check(self, b: int, chunk: int) -> None:
        """loss_chunk's conditions: whole chunks, and whole clips in each."""
        if chunk < 1 or b % chunk:
            raise ValueError(f"loss_chunk {chunk} does not divide the batch "
                             f"of {b} frames")
        for loss in self.losses:
            clip = getattr(loss, "clip_len", 1)
            if clip > 1 and chunk % clip:
                raise ValueError(f"loss_chunk {chunk} splits clips of "
                                 f"{clip} frames ({loss.__name__})")

    def _numden_chunked(self, inputs: LossInputs, t: float, chunk: int
                        ) -> Tuple[Tensor, Tensor]:
        """(numerators, denominators) of every loss summed over the chunks,
        each chunk's body checkpointed."""
        from torch.utils.checkpoint import checkpoint
        b = inputs.fcams.shape[0]
        names = [f.name for f in dataclasses.fields(inputs)
                 if isinstance(getattr(inputs, f.name), torch.Tensor)
                 and getattr(inputs, f.name).dim() >= 1
                 and getattr(inputs, f.name).shape[0] == b]
        static = {f.name: getattr(inputs, f.name)
                  for f in dataclasses.fields(inputs) if f.name not in names}

        def body(*tensors):
            ci = LossInputs(**static, **dict(zip(names, tensors)))
            nums, dens = zip(*(loss.compute_numden(ci, t)
                               for loss in self.losses))
            return (torch.stack([n.float() for n in nums]),
                    torch.stack([d.float() for d in dens]))

        num = den = 0.0
        for c0 in range(0, b, chunk):
            n_c, d_c = checkpoint(
                body, *(getattr(inputs, k)[c0:c0 + chunk] for k in names),
                use_reentrant=False)
            num = num + n_c
            den = den + d_c
        return num, den
