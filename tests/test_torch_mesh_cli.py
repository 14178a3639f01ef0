"""cli.train and cli.evaluate under a 2-rank torch.distributed.run over
gloo on the CPU (STD_CL, 1 epoch at crop 32 on the synthetic set): rank 0
alone writes, the epoch counts the 12 train shots once, and the sharded
evaluation's counters equal the one-process evaluation's.  A launch that
does not finish within tests/torch_dist.JOIN_DEADLINE_S is killed with
its process group and fails."""
import json
import os
import signal
import subprocess
import sys

import pytest

from torch_dist import JOIN_DEADLINE_S, free_port
from tcam_wsol_video_tpu.data.synthetic import make_synthetic_dataset
from tcam_wsol_video_tpu_torch.cli import evaluate as cli_evaluate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("cli_synth")))


def _torchrun(module: str, flags, nproc: int = 2):
    """`module` under torch.distributed.run on nproc gloo ranks; past
    JOIN_DEADLINE_S its whole process group (the launcher and the ranks)
    is killed and the test fails."""
    cmd = [sys.executable, "-m", "torch.distributed.run",
           f"--nproc_per_node={nproc}", "--master_addr=127.0.0.1",
           f"--master_port={free_port()}", "-m", module, *flags]
    env = dict(os.environ, OMP_NUM_THREADS="1", TCAM_DIST_TIMEOUT_S="60")
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=JOIN_DEADLINE_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"{module} on {nproc} ranks hung: the group "
                             f"was killed\n{err[-4000:]}")
    assert proc.returncode == 0, err[-4000:]
    return out


def test_cli_train_and_evaluate_on_two_ranks(synth, tmp_path):
    common = ["--device", "cpu", "--task", "STD_CL",
              "--data_root", os.path.dirname(synth["data_root"]),
              "--metadata_root", synth["metadata_root"],
              "--crop_size", "32", "--resize_size", "40",
              "--eval_batch_size", "8", "--cam_curve_interval", "0.05",
              "--compute_dtype", "float32", "--mesh_dp", "2"]
    _torchrun("tcam_wsol_video_tpu_torch.cli.train", common + [
        "--batch_size", "3", "--max_epochs", "1", "--checkpoint_save", "1",
        "--outd", str(tmp_path), "--exp_id", "cli2"])
    exp = os.path.join(str(tmp_path), os.listdir(str(tmp_path))[0], "cli2")
    with open(os.path.join(exp, "log.json")) as f:
        recs = [json.loads(line) for line in f]
    # rank 0 alone writes: one mesh line, one record a pass
    assert sum("mesh: dp=2 mp=1" in str(r.get("msg")) for r in recs) == 1
    train = [r for r in recs if r.get("split") == "train"]
    assert len(train) == 1 and train[0]["n"] == 12
    assert train[0]["data_route"] == "stream"
    assert train[0]["mesh"] == {"dp": 2, "mp": 1}
    assert os.path.isfile(os.path.join(exp, "passed.txt"))
    # the rolling checkpoints of the 2 steps (keep_last_n 1)
    assert [f for f in os.listdir(exp) if f.endswith("_checkpoint.pt")] == [
        "2_checkpoint.pt"]

    out = _torchrun("tcam_wsol_video_tpu_torch.cli.evaluate", common + [
        "--exp_dir", exp])
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1           # rank 0 prints
    got = json.loads(lines[0])
    want = cli_evaluate.main([a for a in common if a not in (
        "--mesh_dp", "2")] + ["--exp_dir", exp])
    assert got["n_images"] == want["n_images"] == 24
    for k in ("classification", "localization", "maxboxacc_50"):
        assert got[k] == want[k], k
