"""The port stands alone: importing every module of
tcam_wsol_video_tpu_torch and the chip scripts loads neither jax nor the JAX
package (checked in a fresh interpreter: the tests' own process has
imported both)."""
import os
import pkgutil
import subprocess
import sys

import tcam_wsol_video_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    prefix = tcam_wsol_video_tpu_torch.__name__ + "."
    return [m.name for m in pkgutil.walk_packages(
        tcam_wsol_video_tpu_torch.__path__, prefix)]


def test_port_and_chip_smoke_import_no_jax():
    mods = _modules()
    assert len(mods) > 40
    # the process mesh and the global BatchNorm among them
    assert {"tcam_wsol_video_tpu_torch.parallel.mesh",
            "tcam_wsol_video_tpu_torch.parallel.sync_bn"} <= set(mods)
    code = "\n".join([
        "import importlib, sys",
        f"sys.path.insert(0, {ROOT!r})",
        f"for m in {mods!r}: importlib.import_module(m)",
        "import chip_smoke, chip_dress_rehearsal, chip_nvjpeg_stress",
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'tcam_wsol_video_tpu'))",
        "print(len(sys.modules), bad)",
        "sys.exit(1 if bad else 0)"])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
