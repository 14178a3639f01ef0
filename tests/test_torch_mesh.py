"""The port's process mesh on the CPU (parallel/mesh.py,
parallel/sync_bn.py): ranks are spawned processes over gloo on localhost
(tests/torch_dist.py), the JAX references run in this process.

- make_mesh's -1 rule and its refusals on 4 ranks, and the (dp, mp)
  groups;
- global-batch BatchNorm on 2 ranks against flax's BatchNorm on the
  concatenated batch: forward, the input's gradient, the weight's and
  bias's gradients summed over the ranks, the running statistics, and
  the statistics kept under frozen_statistics (remat's recompute);
  float64 (JAX under enable_x64) and float32, InceptionV3's eps 1e-3 as
  one case;
- the mesh keys through argv and yaml, and their checks; a head whose
  classes mp does not divide is refused, as JAX's device_put refuses it.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dist import Ranks
import torch_mesh_ranks as ranks
from tcam_wsol_video_tpu_torch.core.config import TCAMConfig, parse_args
from tcam_wsol_video_tpu_torch.models.poolings import WGAP
from tcam_wsol_video_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

# the ranks' pairwise-combined statistics against flax's one-pass ones on
# the whole batch: float64 to its rounding; float32 to the rounding of sums
# over 2 x 2 x 6 x 6 entries a channel
BN_RTOL = {"float64": 1e-10, "float32": 1e-5}
BN_CASES = [("float64", 1e-5), ("float32", 1e-5), ("float64", 1e-3),
            ("float32", 1e-3)]
B, C, HW = 4, 5, 6


def _bn_case(dtype: str, eps: float, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"dtype": dtype, "eps": eps,
            "x": (rng.standard_normal((B, C, HW, HW)) * 2.0 + 0.5
                  ).astype(dtype),
            "cot": rng.standard_normal((B, C, HW, HW)).astype(dtype),
            "w": rng.uniform(0.5, 1.5, C).astype(dtype),
            "b": rng.normal(0.0, 0.3, C).astype(dtype)}


def _flax_bn(case: dict) -> dict:
    """flax.linen.BatchNorm (momentum 0.9, the JAX package's) in training
    mode on the whole batch (NHWC), its vjp with the same cotangent."""
    dt = jnp.float64 if case["dtype"] == "float64" else jnp.float32
    with jax.enable_x64(case["dtype"] == "float64"):
        bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                           epsilon=case["eps"], dtype=dt, param_dtype=dt)
        x = jnp.asarray(case["x"].transpose(0, 2, 3, 1))
        cot = jnp.asarray(case["cot"].transpose(0, 2, 3, 1))
        stats = {"mean": jnp.zeros(C, dt), "var": jnp.ones(C, dt)}

        def f(x, scale, bias):
            return bn.apply({"params": {"scale": scale, "bias": bias},
                             "batch_stats": stats}, x,
                            mutable=["batch_stats"])

        (y, upd), vjp = jax.vjp(f, x, jnp.asarray(case["w"]),
                                jnp.asarray(case["b"]), has_aux=False)
        dx, dw, db = vjp((cot, jax.tree_util.tree_map(jnp.zeros_like, upd)))
        nchw = (0, 3, 1, 2)
        return {"y": np.asarray(y).transpose(nchw),
                "dx": np.asarray(dx).transpose(nchw), "dw": np.asarray(dw),
                "db": np.asarray(db),
                "mean": np.asarray(upd["batch_stats"]["mean"]),
                "var": np.asarray(upd["batch_stats"]["var"])}


@pytest.fixture(scope="module")
def bn_runs():
    cases = [_bn_case(d, e, i) for i, (d, e) in enumerate(BN_CASES)]
    group = Ranks(ranks.global_bn, 2, cases)
    want = [_flax_bn(c) for c in cases]
    return cases, group.join(), want


@pytest.mark.parametrize("i", range(len(BN_CASES)),
                         ids=[f"{d}-eps{e:g}" for d, e in BN_CASES])
def test_global_batch_norm_matches_flax_on_the_whole_batch(bn_runs, i):
    cases, got, want = bn_runs
    rtol = BN_RTOL[cases[i]["dtype"]]
    for key in ("y", "dx"):
        full = np.concatenate([got[r][i][key] for r in range(2)])
        np.testing.assert_allclose(full, want[i][key], rtol=0,
                                   atol=rtol * np.abs(want[i][key]).max(),
                                   err_msg=key)
    for key in ("dw", "db", "mean", "var"):
        for r in range(2):      # the same on both ranks
            np.testing.assert_allclose(
                got[r][i][key], want[i][key], rtol=0,
                atol=rtol * np.abs(want[i][key]).max(), err_msg=key)
        assert got[r][i][key].dtype == np.dtype(cases[i]["dtype"]), key
    for r in range(2):
        # the biased variance, folded once: remat's recompute keeps it
        assert got[r][i]["frozen_kept"] and got[r][i]["tracked"] == 1


def test_make_mesh_rules_on_four_ranks():
    out = Ranks(ranks.mesh_rules, 4).join()
    for r, o in enumerate(out):
        assert o["dp_mp"] == (2, 2, r // 2, r % 2)      # rank = d mp + m
        for bad in ((3, 1), (-1, 3), (2, 1)):
            assert "!= 4 ranks" in o[bad], bad
        assert "mesh_mp must be >= 1" in o[(1, 0)]
        # the dp group of m: ranks m and m + 2
        assert o["psum"] == [4.0, 6.0][r % 2]
        # the rank's rows of the global batch under use(mesh) only
        assert o["rows"] == (6, 3 * (r // 2)) and o["rows_after"] == (3, 0)


def test_make_mesh_on_one_process():
    mesh = pmesh.make_mesh(-1, 1)
    assert (mesh.dp, mesh.mp, mesh.dp_group, mesh.mp_group) == (1, 1, None,
                                                                None)
    assert pmesh.make_mesh(1, 1).world == 1
    for dp, mp in ((2, 1), (-1, 2), (1, 2)):
        with pytest.raises(ValueError, match="!= 1 ranks"):
            pmesh.make_mesh(dp, mp)
    # without a mesh in use the draws and sums are the single-device ones
    assert pmesh.global_rows(3) == (3, 0)
    assert pmesh.psum_across(5.0) == 5.0


def test_clis_refuse_a_mesh_that_does_not_fit_the_world():
    from tcam_wsol_video_tpu_torch.cli import evaluate as cli_evaluate
    from tcam_wsol_video_tpu_torch.cli import train as cli_train
    with pytest.raises(ValueError, match="2x1 != 1 ranks"):
        cli_train.main(["--device", "cpu", "--task", "STD_CL",
                        "--mesh_dp", "2"])
    with pytest.raises(ValueError, match="1x2 != 1 ranks"):
        cli_evaluate.main(["--device", "cpu", "--task", "STD_CL",
                           "--mesh_mp", "2", "--mesh_dp", "1",
                           "--exp_dir", "/nonexistent"])


def test_mesh_keys_through_argv_and_yaml(tmp_path):
    path = tmp_path / "mesh.yaml"
    path.write_text("mesh_dp: 2\nmesh_mp: 2\n")
    args, _ = parse_args(["--config", str(path), "--mesh_mp", "1"])
    assert (args.mesh_dp, args.mesh_mp) == (2, 1)
    assert (TCAMConfig().mesh_dp, TCAMConfig().mesh_mp) == (-1, 1)
    for bad in (["--mesh_mp", "0"], ["--mesh_dp", "0"],
                ["--mesh_dp", "-2"]):
        with pytest.raises(ValueError, match="mesh_dp"):
            parse_args(bad)


def test_uneven_class_shards_are_refused_as_in_jax():
    # JAX: device_put of the (C, 10) kernel over mp 4 raises ValueError
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    jmesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("dp", "mp"))
    with pytest.raises(ValueError, match="divisible"):
        jax.device_put(np.zeros((16, 10), np.float32),
                       NamedSharding(jmesh, P(None, "mp")))
    head = WGAP(16, 10)
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.ClassShardedLinear(head.fc, pmesh.Mesh(dp=2, mp=4, rank=1))
    # mp 2 divides 10: the rank keeps its five rows
    fc = pmesh.ClassShardedLinear(head.fc, pmesh.Mesh(dp=2, mp=2, rank=3))
    assert fc.weight.shape == (5, 16)
    torch.testing.assert_close(fc.weight, head.fc.weight[5:], rtol=0, atol=0)
