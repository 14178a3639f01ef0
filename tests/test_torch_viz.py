"""Port parity of the visuals (viz/wsol_viz.py, without cv2 or matplotlib)
against the JAX package's on the CPU: the overlay and the boxes bit for
bit, the panels of each figure bit-equal to the arrays JAX hands to
matplotlib (intercepted at Axes.imshow), the ordered prediction sheets
(order, file names, YAML read by PyYAML, TXT), the curves' values, and
the demo AVI read back by cv2.VideoCapture within the JPEG bound."""
import os

import cv2
import matplotlib.axes
import numpy as np
import pytest
import yaml
from PIL import Image

from tcam_wsol_video_tpu.viz import wsol_viz as jviz
from tcam_wsol_video_tpu_torch.data import folds
from tcam_wsol_video_tpu_torch.viz import wsol_viz

# the JPEG bound of a demo frame at quality 95: PSNR of the luma (BT.601)
# against the overlay array.  The chroma is 4:2:0, as in the yuv420p of
# JAX's mp4v, so the 2-px saturated box lines lose chroma by design
# (their RGB PSNR falls to ~24 dB); a smooth overlay's luma lies at
# ~47 dB (measured)
MIN_LUMA_PSNR_DB = 40.0


@pytest.fixture
def shown(monkeypatch):
    """The arrays JAX's figures hand to matplotlib, in call order."""
    seen = []
    real = matplotlib.axes.Axes.imshow

    def imshow(self, x, *a, **k):
        seen.append(np.array(x))
        return real(self, x, *a, **k)

    monkeypatch.setattr(matplotlib.axes.Axes, "imshow", imshow)
    return seen


def _scene(seed: int, h: int = 40, w: int = 48):
    rng = np.random.default_rng(seed)
    raw = rng.uniform(-10, 270, (h, w, 3))
    yy, xx = np.mgrid[0:h, 0:w]
    cam = np.exp(-((yy - h / 2) ** 2 + (xx - w / 3) ** 2) / 90.0)
    cam = np.clip(cam + rng.normal(0, 0.05, (h, w)), 0, 1).astype(np.float32)
    gt = np.asarray([[5, 6, 30, 28], [-3, 20, 12, 50]], np.float32)
    return raw, cam, gt


def test_jet_table_is_cv2s():
    want = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                             cv2.COLORMAP_JET)[:, 0, ::-1]
    np.testing.assert_array_equal(wsol_viz.JET_RGB, want)


@pytest.mark.parametrize("alpha", [0.6, 100 / 255.0, 0.0, 1.0])
def test_cam_overlay_bit_equal(alpha):
    for seed in range(4):
        raw, cam, _ = _scene(seed)
        cam = cam * 1.4 - 0.2                     # values outside [0, 1]
        np.testing.assert_array_equal(wsol_viz.cam_overlay(raw, cam, alpha),
                                      jviz.cam_overlay(raw, cam, alpha))


def test_draw_boxes_bit_equal():
    """Random, clipped, reversed and degenerate boxes, fractional ones
    rounded as JAX rounds them."""
    rng = np.random.default_rng(0)
    for t in range(400):
        h, w = rng.integers(1, 40, 2)
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        boxes = rng.uniform(-10, 50, (int(rng.integers(0, 4)), 4))
        if t % 4 == 0:
            boxes[:, 2] = boxes[:, 0]             # zero width
        if t % 5 == 0:
            boxes[:, 3] = boxes[:, 1]             # zero height
        if t % 7 == 0:
            boxes = np.round(boxes) + 0.5         # round-half cases
        color = wsol_viz.GT_COLOR if t % 2 else wsol_viz.PRED_COLOR
        np.testing.assert_array_equal(wsol_viz.draw_boxes(img, boxes, color),
                                      jviz.draw_boxes(img, boxes, color))


def _read(path):
    return np.asarray(Image.open(path))


def test_single_and_multiple_panels_bit_equal(tmp_path, shown):
    raw, cam, gt = _scene(1)
    pred = [[8.0, 4.0, 33.0, 30.0]]
    tags = {"iou": 0.5, "tau": 0.25, "sigma": 50}
    jviz.plot_single(raw, cam, gt, pred, str(tmp_path / "j.png"), tags=tags)
    wsol_viz.plot_single(raw, cam, gt, pred, str(tmp_path / "p.png"),
                         tags=tags)
    (want,) = shown
    np.testing.assert_array_equal(_read(tmp_path / "p.png"), want)
    assert (tmp_path / "p.png.txt").read_text() == \
        "iou=0.5 tau=0.25 sigma=50\n"

    shown.clear()
    entries = [{"pred_boxes": pred, "tau": 0.3, "sigma": 30, "iou": 0.61},
               {"pred_boxes": [[0, 0, 10, 10]], "tau": 0.7, "sigma": 70}]
    jviz.plot_multiple(raw, cam, gt, entries, str(tmp_path / "jm.png"))
    wsol_viz.plot_multiple(raw, cam, gt, entries, str(tmp_path / "pm.png"))
    rows, titles = wsol_viz.multiple_panels(raw, cam, gt, entries)
    # JAX shows each entry's top panel, then its bottom one
    flat = [p for i in range(len(entries)) for p in (rows[0][i], rows[1][i])]
    assert len(shown) == len(flat)
    for got, want in zip(flat, shown):
        np.testing.assert_array_equal(got, want)
    h, w = raw.shape[:2]
    sheet = _read(tmp_path / "pm.png")
    for r in range(2):
        for i in range(len(entries)):
            np.testing.assert_array_equal(
                sheet[r * h:(r + 1) * h, i * w:(i + 1) * w], rows[r][i])
    assert titles == ["sigma=30 tau=0.300 iou=0.61", "sigma=70 tau=0.700"]


def test_progress_grid_panels_bit_equal(tmp_path, shown):
    scenes = [_scene(s) for s in range(3)]
    raws = [s[0] for s in scenes]
    cams = [s[1] for s in scenes]
    jviz.plot_progress_grid(raws, cams, str(tmp_path / "j.png"), 4)
    wsol_viz.plot_progress_grid(raws, cams, str(tmp_path / "p.png"), 4)
    np.testing.assert_array_equal(_read(tmp_path / "p.png"),
                                  np.concatenate(shown, axis=1))
    assert (tmp_path / "p.png.txt").read_text() == "epoch 4\n"


def test_curve_plots_write_their_values(tmp_path):
    hist = {"val_localization": [1.0, 2.5, 2.0], "train_loss": [3.0]}
    wsol_viz.plot_meter_curves(hist, str(tmp_path / "perf.png"))
    lines = (tmp_path / "perf.png.txt").read_text().splitlines()
    assert lines == ["val_localization (x: epoch): [1.0, 2.5, 2.0]",
                     "train_loss (x: epoch): [3.0]"]
    img = _read(tmp_path / "perf.png")
    assert img.shape[1] == 2 * img.shape[0] * 4 // 3
    assert (img != 255).any(axis=-1).sum() > 100      # frames and lines
    taus = np.arange(0, 1, 0.25)
    curves = {"x": taus, 30: np.asarray([0, 10, 20, 5.0]),
              50: np.asarray([0, 5, 10, 0.0]), "top1": {}}
    wsol_viz.plot_boxacc_curves(taus, curves, str(tmp_path / "acc.png"))
    lines = (tmp_path / "acc.png.txt").read_text().splitlines()
    assert lines[2:] == ["IoU 30: [0.0, 10.0, 20.0, 5.0]",
                         "IoU 50: [0.0, 5.0, 10.0, 0.0]"]


@pytest.mark.parametrize("multi", [False, True])
def test_ordered_prediction_sheets_match(tmp_path, multi):
    visuals = []
    for s in range(4):
        raw, cam, gt = _scene(s + 10)
        visuals.append((f"cls{s % 2}/data/v{s}/shots/0/frame{s}.jpg", raw,
                        cam, gt[:1]))
    taus = [0.3, 0.5, 0.71]
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    want = jviz.ordered_prediction_sheets(visuals, taus, [30, 50, 70],
                                          multi, str(jdir))
    got = wsol_viz.ordered_prediction_sheets(visuals, taus, [30, 50, 70],
                                             multi, str(pdir))
    assert got == want
    jfiles = sorted(os.path.relpath(os.path.join(d, f), jdir)
                    for d, _, fs in os.walk(jdir) for f in fs)
    pfiles = sorted(os.path.relpath(os.path.join(d, f), pdir)
                    for d, _, fs in os.walk(pdir) for f in fs)
    assert [f for f in pfiles if not f.endswith(".png.txt")] == jfiles
    for sigma in (30, 50, 70):
        for ext in ("yaml", "txt"):
            p = pdir / f"ordered_iou_{sigma}.{ext}"
            j = jdir / f"ordered_iou_{sigma}.{ext}"
            if ext == "yaml":
                assert yaml.safe_load(p.read_text()) == \
                    yaml.safe_load(j.read_text())
            else:
                assert p.read_text() == j.read_text()


def test_flat_yaml_reads_back_with_pyyaml():
    mapping = {"a/b.jpg": 0.5, "1e-05": 1e-05, "x: y": 2.0, "yes": 1,
               "iou_thresholds": [30, 50, 70], "best_tau": [0.1, 1e-7],
               "n": None, "flag": True, "inf": float("inf")}
    assert yaml.safe_load(folds.dump_flat_mapping(mapping)) == mapping


def luma_psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR (dB) of the BT.601 luma of two RGB images."""
    w = np.asarray([0.299, 0.587, 0.114])
    mse = (((a.astype(np.float64) - b.astype(np.float64)) @ w) ** 2).mean()
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def test_demo_avi_reads_back_with_cv2(tmp_path):
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:96, 0:128]
    frames = []
    for s in range(6):
        raw = cv2.GaussianBlur(rng.integers(0, 256, (96, 128, 3)).astype(
            np.uint8), (0, 0), 2)
        cam = np.exp(-((yy - 40 - s) ** 2 + (xx - 60) ** 2) / 800.0)
        f = wsol_viz.cam_overlay(raw, cam.astype(np.float32), 100 / 255.0)
        frames.append(wsol_viz.draw_boxes(
            f, [[20, 10 + s, 90, 70], [-4, 50, 30, 100]]))
    path = str(tmp_path / "v" / "demo.avi")
    wsol_viz.build_demo_video(frames, path, fps=8, device="cpu")
    cap = cv2.VideoCapture(path)
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == len(frames)
    n = 0
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        assert bgr.shape == frames[n].shape
        assert luma_psnr(bgr[..., ::-1], frames[n]) >= MIN_LUMA_PSNR_DB
        n += 1
    cap.release()
    assert n == len(frames)
