"""The U-Net decoder keeps its activations channels-last (NCHW shape, NHWC
memory) from the encoder's features to fcams, on every encoder: every
decoder convolution and BatchNorm, the segmentation head and the
reconstruction head take channels-last input, and fcams and im_recon come
out as contiguous NHWC tensors.  ResNet-50 at its full widths (layer3
and layer4 at stride 1, so the first two blocks snap back to the skip's
size), VGG16 (the center block) and InceptionV3 (the nearest-then-bilinear
snap to odd skip sizes, and the final bilinear resize to the input size),
in training (bf16, with a backward) and in eval (fp32)."""
import pytest
import torch

from tcam_wsol_video_tpu_torch.models import unet
from tcam_wsol_video_tpu_torch.models.factory import create_model
from tcam_wsol_video_tpu_torch.models.resnet import BatchNorm2d, Conv2d

CL = torch.channels_last
# (encoder, input size, the resize matrices the decoder and head must use)
CASES = {
    "resnet50": (64, {"_nearest_matrix", "_snap_matrix"}),
    "vgg16": (64, {"_nearest_matrix"}),
    "inceptionv3": (75, {"_nearest_matrix", "_snap_matrix",
                         "_linear_matrix"}),
}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("encoder", list(CASES))
def test_decoder_and_heads_run_channels_last(encoder, train, monkeypatch):
    size, builds = CASES[encoder]
    torch.manual_seed(0)
    model = create_model("TCAM", encoder, 10, "WGAP", freeze_cl=True,
                         im_rec=True, device="cpu").train(train)
    seen, not_cl = [], []

    def check(name):
        def hook(_mod, inp):
            seen.append(name)
            if not inp[0].is_contiguous(memory_format=CL):
                not_cl.append((name, tuple(inp[0].shape), inp[0].stride()))
        return hook

    for name, mod in model.named_modules():
        if (name.split(".")[0] in ("decoder", "segmentation_head",
                                   "reconstruction_head")
                and isinstance(mod, (Conv2d, BatchNorm2d))):
            mod.register_forward_pre_hook(check(name))
    used = set()
    resize = unet._resize_cl

    def spy(x, build, *args):
        used.add(build.__name__)
        return resize(x, build, *args)

    monkeypatch.setattr(unet, "_resize_cl", spy)
    x = torch.randn(2, size, size, 3)
    dtype = torch.bfloat16 if train else torch.float32
    with torch.set_grad_enabled(train):
        out = model(x, dtype, generator=torch.Generator().manual_seed(1))
    n_dec = sum(1 for n in seen if n.startswith("decoder."))
    # conv and BN of two Conv2dReLU a block, center block included
    assert n_dec == 4 * (model.decoder.blocks
                         + (model.decoder.center is not None))
    assert "segmentation_head.conv" in seen
    assert "reconstruction_head.conv" in seen
    assert not not_cl, not_cl
    assert used == builds
    fcams, rec = out["fcams"], out["im_recon"]
    assert fcams.shape == (2, size, size, 2) and fcams.is_contiguous()
    assert rec.shape[-1] == 3 and rec.is_contiguous()
    assert fcams.dtype == rec.dtype == dtype
    if train:
        (fcams.float().square().mean() + rec.float().mean()).backward()
        grads = [p.grad for n, p in model.named_parameters()
                 if n.startswith("decoder.")]
        assert all(g is not None and bool(torch.isfinite(g).all())
                   for g in grads)
