"""Port parity: UnetTCAM on the WSOL ResNet (layers 1,1,1,1) at 32 px with
weights transplanted from flax — logits, fcams and BN running statistics
in inference and training mode, float32 on the CPU."""
import jax
import numpy as np
import pytest
import torch

from torch_port_fixtures import (assert_close, images, jax_model,
                                 jax_variables, torch_model)
from tcam_wsol_video_tpu_torch.models.transplant import flax_to_state_dict

torch.set_num_threads(1)

# conv/BN chains of ~20 layers in fp32, summed in another order
FWD_RTOL = 1e-4
# running statistics: one lerp of a batch mean/variance
BN_RTOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    """freeze_cl changes no parameter: one init serves both models."""
    variables = jax_variables(jax_model(True), seed=0)
    return {freeze: (jax_model(freeze), variables)
            for freeze in (True, False)}


def test_forward_inference_mode(setup):
    jm, variables = setup[True]
    x = images(np.random.default_rng(3), 2)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)
    tm = torch_model(variables).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert_close(got["cl_logits"].numpy(), want["cl_logits"], FWD_RTOL,
                 "cl_logits")
    assert_close(got["fcams"].numpy(), want["fcams"], FWD_RTOL, "fcams")
    for i, (g, w) in enumerate(zip(got["features"], want["features"])):
        assert_close(g.permute(0, 2, 3, 1).numpy(), w, FWD_RTOL,
                     f"feature {i}")


@pytest.mark.parametrize("freeze_cl", [True, False],
                         ids=["freeze_cl", "train_cl"])
def test_forward_training_mode_and_bn_stats(setup, freeze_cl):
    jm, variables = setup[freeze_cl]
    x = images(np.random.default_rng(4), 3)
    want, upd = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    tm = torch_model(variables, freeze_cl).train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert_close(got["cl_logits"].numpy(), want["cl_logits"], FWD_RTOL,
                 "cl_logits")
    assert_close(got["fcams"].numpy(), want["fcams"], FWD_RTOL, "fcams")

    new = flax_to_state_dict({"params": variables["params"],
                              "batch_stats": upd["batch_stats"]})
    sd = tm.state_dict()
    n_moved = 0
    for k, v in new.items():
        if "running_" not in k:
            continue
        assert_close(sd[k].numpy(), v, BN_RTOL, k)
        old = flax_to_state_dict(variables)[k]
        n_moved += int(not np.array_equal(v, old))
        # under freeze_cl the encoder keeps its statistics exactly
        if freeze_cl and k.startswith("encoder."):
            np.testing.assert_array_equal(sd[k].numpy(), old)
    assert n_moved > 0


def test_transplant_covers_every_tensor(setup):
    _, variables = setup[True]
    tm = torch_model(variables)
    sd = flax_to_state_dict(variables)
    own = {k for k in tm.state_dict() if not k.endswith("num_batches_tracked")}
    assert own == set(sd)
    w = variables["params"]["encoder"]["conv1"]["kernel"]        # HWIO
    np.testing.assert_array_equal(
        tm.encoder.conv1.weight.detach().numpy(), w.transpose(3, 2, 0, 1))
    fc = variables["params"]["classification_head"]["fc"]["kernel"]
    np.testing.assert_array_equal(
        tm.classification_head.fc.weight.detach().numpy(), fc.T)
