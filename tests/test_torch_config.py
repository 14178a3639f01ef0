"""Port parity: the command line of core/config.py against the JAX
package's core/hparams.py.

`parse_args(["--config", yaml, ...])` must give every key of the port's
config the value and the Python type that JAX's parse_args gives it, for
both recipe yamls, with flags on top, and for the production stage-2
script's flags and an F_CL command.  The port reads the yamls without
PyYAML: each scalar spelling must come out as `yaml.safe_load` types it
(YAML 1.1: `1e-5` is a string, `2.0e-9` a float, `yes`/`on` booleans,
`~` null).  The reference's argv spellings (the `--opt__*` aliases, the
runtime flags dropped with a warning) are normalized as in JAX.
"""
import dataclasses
import math
import os
import shlex
import warnings

import pytest
import yaml

from tcam_wsol_video_tpu.core import hparams as jhp
from tcam_wsol_video_tpu_torch.core import config as tconfig
from tcam_wsol_video_tpu_torch.core.config import (TCAMConfig, finalize,
                                                   parse_args)
from tcam_wsol_video_tpu_torch.data.folds import (parse_flat_mapping,
                                                  parse_scalar)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = {name: os.path.join(ROOT, "config_yaml", f"ytov1_{name}.yaml")
         for name in ("stage1_cam", "stage2_tcam")}
KEYS = [f.name for f in dataclasses.fields(TCAMConfig)]


def _same(got, want) -> bool:
    if isinstance(want, float) and math.isnan(want):
        return isinstance(got, float) and math.isnan(got)
    return type(got) is type(want) and got == want


def _assert_parse_equal(argv):
    """Every key of the port's config as JAX's parse_args has it."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jhp.parse_args(list(argv))
        got, _ = parse_args(list(argv))
    bad = [(k, getattr(got, k), want.get(k)) for k in KEYS
           if not _same(getattr(got, k), want.get(k))]
    assert not bad, bad
    return got


@pytest.mark.parametrize("name", sorted(YAMLS))
@pytest.mark.parametrize("extra", [
    [], ["--lr", "0.1", "--batch_size", "8", "--max_epochs", "3"],
    ["--sl_tc", "false", "--crf_impl", "landmarks", "--im_rec", "yes",
     "--sl_tc_epoch_switch_to_sl", "1", "--iou_threshold_list", "[30]"]],
    ids=["yaml", "yaml_then_flags", "yaml_then_slice_flags"])
def test_config_yaml_matches_jax(name, extra):
    got = _assert_parse_equal(["--config", YAMLS[name]] + extra)
    for k, v in yaml.safe_load(open(YAMLS[name])).items():
        if f"--{k}" not in extra:
            assert _same(getattr(got, k), v), k


# the spellings of a scalar, each read as yaml.safe_load reads it
SPELLINGS = ["1e-5", "2.0e-9", "1.0e5", "1e+5", "-.5", ".5", "1.", "0.5",
             "yes", "Yes", "on", "OFF", "no", "true", "False", "y", "n",
             "~", "null", "NULL", "", "010", "08", "0x1F", "0b101", "1_000",
             "1:30", "-7", "+4", "0", ".inf", "-.Inf", ".nan", "abc",
             "seed_weighted", "before-after", "-abc", "'1e-5'", '"yes"',
             "'it''s'"]


@pytest.mark.parametrize("tok", SPELLINGS)
def test_scalar_spellings_read_as_safe_load(tok):
    want = yaml.safe_load(f"key: {tok}")["key"]
    assert _same(parse_scalar(tok), want), (tok, parse_scalar(tok), want)
    assert _same(parse_flat_mapping(f"key: {tok}  # a comment\n")["key"],
                 want)


def test_flat_mapping_reads_the_yamls_as_safe_load():
    for path in list(YAMLS.values()) + [
            os.path.join(ROOT, "config_yaml", "ytov1_cbox.yaml")]:
        want = yaml.safe_load(open(path))
        got = parse_flat_mapping(open(path).read())
        assert got.keys() == want.keys()
        assert all(_same(got[k], want[k]) for k in want), path
    assert parse_flat_mapping("{a: 0, b: yes}") == {"a": 0, "b": True}


@pytest.mark.parametrize("text", [
    "a:\n  b: 1", "- 1\n- 2", "a: [1, 2]", "a: {b: 1}", "a: &x 1",
    "a: !!str 1", "a: |\n  x", "a 1", "a: 1\na: 2", "a: 2001-12-14",
    'a: "x\\ty"'], ids=["nested", "sequence", "flow_seq", "flow_map",
                        "anchor", "tag", "block", "no_colon", "duplicate",
                        "timestamp", "escape"])
def test_flat_mapping_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        parse_flat_mapping(text)


def test_yaml_values_keep_their_yaml_type(tmp_path):
    """A recipe value that YAML 1.1 reads as a string stays a string, and
    a flag over it is coerced to that type, on both sides."""
    path = tmp_path / "recipe.yaml"
    path.write_text("task: TCAM\narch: UnetTCAM\nlr: 1e-5\n"
                    "elb_init_t: 2\nfreeze_cl: on\nsl_tc_min_p: ~\n")
    got = _assert_parse_equal(["--config", str(path)])
    assert got.lr == "1e-5" and got.elb_init_t == 2 and got.freeze_cl
    assert got.sl_tc_min_p is None
    got = _assert_parse_equal(["--config", str(path), "--lr", "0.5",
                               "--sl_tc_min_p", "0.3"])
    assert got.lr == "0.5" and got.sl_tc_min_p == 0.3


def test_yaml_keys_of_unported_modules_are_refused(tmp_path):
    """Every JAX key is ported now: the image datasets' bucket keys parse
    from a yaml and from flags as JAX parses them; a key JAX lacks is
    still refused."""
    path = tmp_path / "buckets.yaml"
    path.write_text("task: TCAM\narch: UnetTCAM\nbucket_sz: 4\n"
                    "ds_chunkable: yes\nnbr_chunks: 6\n"
                    "bucket_stage_cmd: touch {bucket}\n")
    got = _assert_parse_equal(["--config", str(path)])
    assert (got.bucket_sz, got.ds_chunkable, got.nbr_chunks,
            got.nbr_buckets) == (4, True, 6, 2)
    got = _assert_parse_equal(["--config", str(path), "--bucket_sz", "3",
                               "--mask_root", "/m"])
    assert (got.bucket_sz, got.nbr_buckets, got.mask_root) == (3, 2, "/m")
    path.write_text("task: TCAM\narch: UnetTCAM\nbucket_size: 4\n")
    with pytest.raises(ValueError, match="unknown keys"):
        parse_args(["--config", str(path)])


def test_cbox_yaml_parses_as_jax():
    """config_yaml/ytov1_cbox.yaml, alone and under flags, key by key and
    type as JAX's parse_args reads it."""
    yaml = os.path.join(ROOT, "config_yaml", "ytov1_cbox.yaml")
    got = _assert_parse_equal(["--config", yaml])
    assert (got.task, got.arch, got.cb_seed_n, got.cb_cl_score_blur_ksize,
            got.cb_pp_box_min_size_type) == ("C_BOX", "DenseBoxNet", 10, 65,
                                             "size_data")
    got = _assert_parse_equal(["--config", yaml, "--cb_seed_n", "3",
                               "--freeze_encoder", "true",
                               "--cb_cl_score_blur_sigma", "30"])
    assert got.cb_seed_n == 3 and got.freeze_encoder
    assert got.cb_cl_score_blur_sigma == 30.0


REFERENCE_ARGV = [
    "--task", "TCAM", "--arch", "UnetTCAM", "--opt__name_optimizer", "sgd",
    "--opt__lr", "0.02", "--opt__momentum=0.8", "--opt__nesterov", "False",
    "--opt__weight_decay", "5e-4", "--opt__step_size", "7",
    "--opt__gamma=0.5", "--opt__lr_classifier_ratio", "3",
    "--cudaid", "0", "--local_rank=1", "--amp", "True", "--amp_eval",
    "--opt__beta1", "0.9", "--opt__last_epoch", "-1"]


@pytest.mark.parametrize("sched", [[], ["--opt__lr_scheduler", "False"],
                                   ["--opt__lr_scheduler=True"]],
                         ids=["none", "off", "on"])
def test_reference_argv_matches_jax(sched):
    argv = REFERENCE_ARGV + sched
    with pytest.warns(UserWarning, match="ignored") as rec_port:
        got = tconfig.normalize_reference_argv(argv)
    with pytest.warns(UserWarning) as rec_jax:
        want = jhp._normalize_reference_argv(argv)
    assert got == want
    assert (str(rec_port[0].message).split(": ")[-1]
            == str(rec_jax[0].message).split(": ")[-1])
    args = _assert_parse_equal(argv)
    assert args.lr == 0.02 and args.nesterov is False
    assert args.lr_scheduler == (
        "constant" if sched == ["--opt__lr_scheduler", "False"] else "mystep")


def _script_flags(path):
    text = open(path).read()
    main = text[text.index("python main.py"):]
    main = main[:main.index("--exp_id")].replace("\\\n", " ")
    return shlex.split(main.replace("${TAG}", "tag"))[2:]


def test_production_script_and_f_cl_flags_parse_as_jax():
    script = os.path.join(ROOT, "cmds", "train_stage2_tcam_ytov1.sh")
    args = _assert_parse_equal(_script_flags(script))
    assert args.crf_impl == "landmarks" and args.folder_pre_trained_cl
    f_cl = ["--task", "F_CL", "--arch", "UnetFCAM", "--sl_fc", "true",
            "--sl_fc_lambda", "0.5", "--sl_start_ep", "1", "--sl_min", "5",
            "--sl_max", "7", "--sl_ksz", "3", "--sl_min_p", "0.1",
            "--sl_fg_erode_k", "9", "--sl_fg_erode_iter", "2",
            "--crf_fc", "true", "--crf_lambda", "3e-9", "--crf_sigma_rgb",
            "10", "--crf_sigma_xy", "80", "--crf_scale", "0.5",
            "--crf_end_ep", "4", "--entropy_fc", "true",
            "--entropy_fc_lambda", "0.3", "--max_sizepos_fc", "true",
            "--max_sizepos_fc_lambda", "0.01", "--max_sizepos_fc_start_ep",
            "2", "--im_rec", "true", "--im_rec_lambda", "0.2",
            "--im_rec_elb", "true", "--img_range", "2.0"]
    args = _assert_parse_equal(f_cl)
    assert args.task == "F_CL" and args.crf_scale == 0.5


@pytest.mark.parametrize("bad,err", [
    (dict(task="F_CL", arch="UnetTCAM"), ValueError),
    # C_BOX is ported: its own arch check (JAX hparams.finalize) refuses
    (dict(task="C_BOX", arch="UnetTCAM"), ValueError),
    (dict(sl_block=2), ValueError), (dict(sl_tc_block=3), ValueError)],
    ids=["f_cl_arch", "c_box", "sl_block", "sl_tc_block"])
def test_finalize_checks_of_this_slice(bad, err):
    with pytest.raises(err):
        finalize(TCAMConfig().replace(**bad))
    assert finalize(TCAMConfig(task="F_CL", arch="UnetFCAM"))


def test_the_ported_keys():
    """The keys of the slices exist with JAX's defaults, and the port has
    all 216 of JAX's keys (their defaults:
    test_torch_step.py::test_config_defaults_match_hparams)."""
    ref = jhp.get_config("YouTube-Objects-v1.0")
    for k in ("sl_tc_epoch_switch_to_sl", "im_rec", "im_rec_lambda",
              "im_rec_elb", "img_range", "sl_fc", "sl_block", "sl_tc_block",
              "crf_fc", "crf_lambda", "entropy_fc", "max_sizepos_fc_end_ep"):
        assert _same(getattr(TCAMConfig(), k), ref[k]), k
    for k in ("plot_tr_cam_progress", "plot_tr_cam_progress_n",
              "alpha_visu", "mask_root", "ds_chunkable", "nbr_chunks",
              "bucket_sz", "bucket_stage_cmd", "bucket_cleanup_cmd"):
        assert _same(getattr(TCAMConfig(), k), ref[k]), k
    assert len(KEYS) == 216 and set(KEYS) == set(ref)


THROUGHPUT = {"train_dispatch_chunk": "4", "eval_transfer": "uint16",
              "eval_sweep": "device", "eval_pipeline_depth": "2",
              "eval_device_cache": "true", "eval_device_cache_mb": "64",
              "loss_chunk": "6", "remat": "yes", "on_device_eval": "true"}


def test_throughput_keys_parse_as_jax():
    """The 9 keys of the throughput layer: JAX's defaults, and each flag
    coerced to JAX's type and value."""
    ref = jhp.get_config("YouTube-Objects-v1.0")
    for k in THROUGHPUT:
        assert _same(getattr(TCAMConfig(), k), ref[k]), k
    got = _assert_parse_equal([a for k, v in THROUGHPUT.items()
                               for a in (f"--{k}", v)])
    assert (got.train_dispatch_chunk, got.remat, got.on_device_eval,
            got.eval_device_cache_mb) == (4, True, True, 64)


@pytest.mark.parametrize("bad", [dict(eval_transfer="uint4"),
                                 dict(eval_sweep="tpu")],
                         ids=["eval_transfer", "eval_sweep"])
def test_throughput_checks_raise_as_jax(bad):
    cfg = jhp.get_config("YouTube-Objects-v1.0")
    cfg.update(bad)
    with pytest.raises(AssertionError):
        jhp.finalize(jhp.HParams(cfg))
    with pytest.raises(ValueError):
        finalize(TCAMConfig().replace(**bad))
    for transfer in ("float32", "uint16", "uint8"):
        assert finalize(TCAMConfig(eval_transfer=transfer))
