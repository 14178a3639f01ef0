"""The port stands alone: importing every module of
tcam_wsol_video_tpu_torch and the chip scripts loads neither jax nor the JAX
package, nor cv2, PIL, yaml or matplotlib, which the card's machine does
not have (checked in a fresh interpreter: the tests' own process has
imported them all)."""
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
    # the process mesh and the global BatchNorm among them, and the
    # modules of the visuals, the demo and the image datasets
    prefix = "tcam_wsol_video_tpu_torch."
    assert {prefix + m for m in (
        "parallel.mesh", "parallel.sync_bn", "ops.contours", "ops.native",
        "metrics.seeds_eval", "viz.wsol_viz", "engine.temporal_reuse",
        "cli.demo_video", "cli.build_dataset", "data.ilsvrc_buckets",
        "data.builders", "data.png", "models.import_torch")} <= set(mods)
    code = "\n".join([
        "import importlib, sys",
        f"sys.path.insert(0, {ROOT!r})",
        f"for m in {mods!r}: importlib.import_module(m)",
        "import chip_smoke, chip_dress_rehearsal, chip_nvjpeg_stress",
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'tcam_wsol_video_tpu', 'cv2', "
        "'PIL', 'yaml', 'matplotlib'))",
        "print(len(sys.modules), bad)",
        "sys.exit(1 if bad else 0)"])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
