"""Port parity of the torchvision-checkpoint import (models/import_torch.py)
on the CPU: a torchvision-named state dict, built here and saved with
torch.save (nothing is downloaded), goes through JAX's import_torch into
JAX's STDClassifier and through the port's into the port's, for
ResNet-50, VGG16 and Inception-v3; the fp32 forwards agree within the
encoder tests' tolerance (tests/test_torch_encoders.py FWD_RTOL).  The
keys torchvision holds beyond the encoder (fc, classifier, AuxLogits,
Mixed_7*) are dropped on both sides."""
import jax
import numpy as np
import pytest
import torch

from torch_port_fixtures import (assert_close, images, jax_std_classifier,
                                 jax_variables, torch_std_classifier)
from tcam_wsol_video_tpu.models import import_torch as jimport
from tcam_wsol_video_tpu_torch.models import import_torch

torch.set_num_threads(1)

FWD_RTOL = 1e-4
_VGG_FEATURES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_MIXED = ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6b", "Mixed_6c",
          "Mixed_6d", "Mixed_6e")
# torchvision entries outside the encoders (at token shapes): both
# imports drop them
_EXTRA = {"resnet50": {"fc.weight": (10, 2048), "fc.bias": (10,)},
          "vgg16": {"classifier.0.weight": (4, 8),
                    "classifier.6.bias": (10,)},
          "inceptionv3": {"AuxLogits.fc.weight": (10, 768),
                          "Mixed_7a.branch3x3_1.conv.weight": (4, 8, 1, 1),
                          "fc.weight": (10, 2048)}}
_JAX_IMPORT = {"resnet50": jimport.resnet50_from_torch,
               "vgg16": jimport.vgg16_from_torch,
               "inceptionv3": jimport.inception3_from_torch}


def _torchvision_state_dict(name: str, encoder, seed: int) -> dict:
    """Random tensors under torchvision's names, at the encoder's shapes
    (running variances positive)."""
    probe = {"resnet50": {f"layer{i}.0.downsample.0.weight": 0
                          for i in range(1, 5)},
             "vgg16": {f"features.{k}.weight": 0 for k in _VGG_FEATURES},
             "inceptionv3": {**{f"{m}.branch1x1.conv.weight": 0
                                for m in _MIXED},
                             "Mixed_6a.branch3x3.conv.weight": 0}}[name]
    own = encoder.state_dict()
    rng = np.random.default_rng(seed)
    sd = {}
    for src, dst in import_torch.NAME_MAPS[name](probe):
        shape = tuple(own[dst].shape)
        if src.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif src.endswith(("running_mean", "bias")):
            v = rng.normal(0.0, 0.1, shape)
        else:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
            v = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
            if len(shape) == 1:
                v = 1.0 + 0.1 * v
        sd[src] = torch.from_numpy(v.astype(np.float32))
    for k, shape in _EXTRA[name].items():
        sd[k] = torch.zeros(shape)
    return sd


@pytest.mark.parametrize("name", ["resnet50", "vgg16", "inceptionv3"])
def test_import_matches_jax(tmp_path, name):
    jm = jax_std_classifier(name, "GAP")
    variables = jax_variables(jm, seed=4)
    model = torch_std_classifier(variables, name, "GAP").eval()
    sd = _torchvision_state_dict(name, model.encoder, seed=5)
    path = str(tmp_path / f"{name}.pth")
    torch.save({"state_dict": sd}, path)

    enc_params, enc_stats = _JAX_IMPORT[name](
        jimport.load_torch_state_dict(path))
    jv = jimport.merge_encoder_into_variables(variables, enc_params,
                                              enc_stats)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    import_torch.load_pretrained_encoder(model, path, name)
    changed = [k for k, v in model.state_dict().items()
               if not torch.equal(v, before[k])]
    assert len(changed) == len([k for k in sd if k not in _EXTRA[name]])

    x = images(np.random.default_rng(6), 2)
    want = jax.jit(lambda v, a: jm.apply(v, a, train=False))(jv, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.float32)
    assert_close(got["cl_logits"].double().numpy(),
                 np.asarray(want["cl_logits"], np.float64), FWD_RTOL,
                 f"{name} logits")
    last = got["features"][-1].permute(0, 2, 3, 1).double().numpy()
    assert_close(last, np.asarray(want["features"][-1], np.float64),
                 FWD_RTOL, f"{name} last feature")


def test_import_refuses_a_wrong_shape(tmp_path):
    from tcam_wsol_video_tpu_torch.models.resnet import ResNetWSOL
    enc = ResNetWSOL()
    with pytest.raises(ValueError):
        import_torch.load_into_encoder(
            enc, {"conv1.weight": torch.zeros(64, 3, 3, 3)})
    with pytest.raises(KeyError):
        import_torch.load_into_encoder(enc, {"fc.weight": torch.zeros(1)})
    with pytest.raises(ValueError):
        import_torch.encoder_state_from_torch({}, "resnet101")
