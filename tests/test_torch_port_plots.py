"""The training plots of the port (``s2anet_tpu_torch/utils/plots.py``,
drawn without cv2 or matplotlib) against the JAX package's
``s2anet_tpu/utils/plots.py`` and their wiring in the port's ``Trainer``,
on the CPU.

* ``plot_images_grid``: the port's mosaic (uint8 RGB batch in) against the
  JAX one's (the same batch as float ``u * float32(1/255)``, which its
  ``* 255`` cast gives back as ``u``). Without a resize the two are equal
  outside the strokes and the labels' text; with one (800^2 tiles to 640)
  within one level there (``augment.resize_bilinear`` against
  ``cv2.resize``); the strokes within one pixel of cv2's both ways (a 3 x 3
  dilation of each covers the other), outside both fonts' text boxes. The
  port's PNG decodes to the returned mosaic flipped to RGB.
* ``plot_label_stats``, ``plot_pr_curves``, ``plot_results_csv``: what the
  JAX functions hand matplotlib (``Axes.hist``' and ``Axes.hist2d``'
  counts and edges, ``Axes.plot``'s points and legend labels, recorded
  while they run) equals the port's ``*_data`` functions' output exactly;
  the port's PNG has the JAX PNG's size (``data/image.py`` reads both).
  A ``results.csv`` column with an empty cell (an epoch without
  validation) is skipped by both; no rows, no file from either.
* A Trainer run (R-18, 64^2, 2 epochs) writes ``labels.png``,
  ``train_batch{0,1,2}.png``, ``pr_curves.png`` and ``results.png`` at
  their sizes and records the plots' seconds; ``--noplots`` writes none.
"""

import csv
from unittest import mock

import cv2
import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")

from matplotlib.axes import Axes  # noqa: E402

from s2anet_tpu.utils import plots as jax_plots  # noqa: E402
from s2anet_tpu_torch.data import synth  # noqa: E402
from s2anet_tpu_torch.data.image import imread  # noqa: E402
from s2anet_tpu_torch.ops.polyiou import rbox_vertices_np  # noqa: E402
from s2anet_tpu_torch.train import __main__ as train_cli  # noqa: E402
from s2anet_tpu_torch.utils import loggers, plots  # noqa: E402

NAMES = [f"class{i}" for i in range(15)]


@pytest.fixture(autouse=True)
def _no_tensorboard():
    """The loggers without TensorBoard: where it is installed its writer
    imports TensorFlow, tens of seconds on a loaded machine, and writes
    nothing that these tests read."""
    with mock.patch.object(loggers, "_installed", lambda name: False):
        yield


def _batch(rng, b, side, n_boxes=4):
    """uint8 RGB images (dark noise) and per image rotated boxes inside it."""
    imgs = rng.integers(0, 50, (b, side, side, 3), dtype=np.uint8)
    targets = []
    for _ in range(b):
        boxes = np.stack([rng.uniform(0.25 * side, 0.75 * side, n_boxes),
                          rng.uniform(0.25 * side, 0.75 * side, n_boxes),
                          rng.uniform(0.1 * side, 0.3 * side, n_boxes),
                          rng.uniform(0.05 * side, 0.2 * side, n_boxes),
                          rng.uniform(-np.pi / 2, np.pi / 2, n_boxes)], 1).astype(np.float32)
        targets.append((boxes, rng.integers(0, 15, n_boxes)))
    return imgs, targets


def _cv2_text_box(label, org):
    (w, h), base = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, 0.45, 1)
    return org[0] - 1, org[1] - h - 2, org[0] + w + 2, org[1] + base + 2


@pytest.mark.parametrize("side, max_size", [(96, 640), (800, 640)], ids=["no-resize", "resize"])
def test_images_grid_matches_jax(tmp_path, side, max_size):
    rng = np.random.default_rng(side)
    imgs, targets = _batch(rng, 4, side)
    want = jax_plots.plot_images_grid(imgs.astype(np.float32) * np.float32(1 / 255), targets,
                                      tmp_path / "jax.png", names=NAMES, max_size=max_size)
    got = plots.plot_images_grid(imgs, targets, tmp_path / "port" / "train_batch0.png",
                                 names=NAMES, max_size=max_size)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(imread(tmp_path / "port" / "train_batch0.png"), got)

    scale = min(max_size / side, 1.0)
    ts = int(side * scale)
    n = 2
    # each drawing's tiles without boxes: the strokes are what the boxes changed
    none = [(np.zeros((0, 5)), np.zeros(0, int))] * 4
    plain_cv2 = jax_plots.plot_images_grid(imgs.astype(np.float32) * np.float32(1 / 255),
                                           none, tmp_path / "plain.png", max_size=max_size)
    plain_port = plots.plot_images_grid(imgs, none, tmp_path / "plain_port.png",
                                        max_size=max_size)
    strokes_cv2 = (want != plain_cv2).any(2)
    strokes_port = (got != plain_port).any(2)
    # the text of both fonts, per tile (drawn on the tile, clipped to it)
    text = np.zeros(got.shape[:2], bool)
    for k, (boxes, classes) in enumerate(targets):
        r, c = divmod(k, n)
        tile = np.zeros((ts, ts), bool)
        polys = rbox_vertices_np(_scaled(boxes, scale)).astype(np.int32)
        for p, cid in zip(polys, classes):
            org = plots.label_origin(p)
            for x0, y0, x1, y1 in (plots.text_box(NAMES[cid], org),
                                   _cv2_text_box(NAMES[cid], org)):
                tile[max(y0 - 1, 0):max(y1 + 1, 0), max(x0 - 1, 0):max(x1 + 1, 0)] = True
        text[r * ts:(r + 1) * ts, c * ts:(c + 1) * ts] = tile
    outside = ~(strokes_cv2 | strokes_port | text)
    diff = np.abs(got.astype(int) - want.astype(int)).max(2)
    assert diff[outside].max() <= (0 if scale == 1.0 else 1)
    if scale == 1.0:
        assert not diff[outside].any()
    # the strokes: each within one pixel of the other's, tile borders and
    # text apart
    judged = ~text
    for t in range(1, n):
        judged[t * ts - 2:t * ts + 2] = False
        judged[:, t * ts - 2:t * ts + 2] = False
    near = np.ones((3, 3), np.uint8)
    assert strokes_port[judged].sum() > 200 and strokes_cv2[judged].sum() > 100
    assert not (strokes_port & ~cv2.dilate(strokes_cv2.astype(np.uint8), near).astype(bool)
                & judged).any()
    assert not (strokes_cv2 & ~cv2.dilate(strokes_port.astype(np.uint8), near).astype(bool)
                & judged).any()


def _scaled(boxes, scale):
    b = np.asarray(boxes, np.float64).copy()
    if scale != 1.0:
        b[:, :4] *= scale
    return b


class _Recorder:
    """Records what the JAX functions hand matplotlib's ``Axes``."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self._patches = []
        for name in ("hist", "hist2d", "plot"):
            orig = getattr(Axes, name)

            def wrapped(ax, *args, _orig=orig, _name=name, **kw):
                out = _orig(ax, *args, **kw)
                self.calls.append((_name, args, kw, out))
                return out
            p = mock.patch.object(Axes, name, wrapped)
            p.start()
            self._patches.append(p)
        return self

    def __exit__(self, *a):
        for p in self._patches:
            p.stop()


@pytest.mark.parametrize("with_boxes", [True, False], ids=["boxes", "no-boxes"])
def test_label_stats_data_equal_matplotlib(tmp_path, with_boxes):
    rng = np.random.default_rng(5)
    n = 300 if with_boxes else 0
    boxes = np.stack([rng.uniform(0, 1024, n), rng.uniform(0, 1024, n),
                      rng.uniform(4, 300, n), rng.uniform(4, 120, n),
                      rng.uniform(-np.pi / 4, np.pi / 4, n)], 1).astype(np.float32)
    classes = rng.integers(0, 15, 40).astype(np.float32)
    with _Recorder() as rec:
        jax_plots.plot_label_stats(boxes, classes, tmp_path / "jax.png", num_classes=15)
    data = plots.label_stats_data(boxes, classes, 15)
    kinds = [c[0] for c in rec.calls]
    assert kinds == (["hist", "hist2d", "hist2d", "hist"] if with_boxes else ["hist"])
    assert list(data) == (["classes", "xy", "wh", "theta"] if with_boxes else ["classes"])
    for (kind, _, _, out), key in zip(rec.calls, data):
        arrays = out[:2] if kind == "hist" else out[:3]
        assert len(arrays) == len(data[key])
        for a, b in zip(arrays, data[key]):
            np.testing.assert_array_equal(np.asarray(a, np.float64), np.asarray(b, np.float64))
    plots.plot_label_stats(boxes, classes, tmp_path / "port.png", num_classes=15)
    assert imread(tmp_path / "port.png").shape == imread(tmp_path / "jax.png").shape == (
        960, 1200, 3)


def test_pr_curves_data_equal_matplotlib(tmp_path):
    rng = np.random.default_rng(6)
    per_class = {}
    for i, name in enumerate(NAMES[:5]):
        k = 0 if i == 2 else int(rng.integers(5, 60))
        rec = np.sort(rng.uniform(0, 1, k))
        per_class[name] = {"rec": rec, "prec": np.clip(1 - rec + rng.normal(0, .05, k), 0, 1),
                           "ap": float(rng.uniform())}
    with _Recorder() as rec:
        jax_plots.plot_pr_curves(per_class, tmp_path / "jax.png")
    data = plots.pr_curves_data(per_class)
    assert len(rec.calls) == len(data) == 4
    for (kind, args, kw, _), (r, p, label) in zip(rec.calls, data):
        assert kind == "plot" and kw["label"] == label
        np.testing.assert_array_equal(args[0], r)
        np.testing.assert_array_equal(args[1], p)
    plots.plot_pr_curves(per_class, tmp_path / "port.png")
    assert imread(tmp_path / "port.png").shape == imread(tmp_path / "jax.png").shape == (
        720, 960, 3)


def _results_csv(path, rows):
    """``results.csv`` as the port's logger writes it: the val metrics
    arrive with the second row, the first row's cells for them empty."""
    log = loggers.Loggers(path.parent)
    for step, row in enumerate(rows):
        log.log_metrics(row, step)
    log.close()
    return path.parent / "results.csv"


def test_results_csv_data_equal_matplotlib(tmp_path):
    rng = np.random.default_rng(7)
    train = [{"train/fam_cls_loss": float(rng.uniform()), "train/odm_reg_loss": 0.5 / (e + 1),
              "lr/0": 0.01, "time/epoch_s": float(rng.uniform(1, 2))} for e in range(5)]
    rows = [train[0]] + [{**t, "metrics/mAP_0.5": 0.1 * e, "val/odm_cls_loss": 1.0 / e}
                         for e, t in enumerate(train[1:], 1)]
    path = _results_csv(tmp_path / "run" / "results.csv", rows)
    with open(path, newline="") as f:
        assert list(csv.DictReader(f))[0]["metrics/mAP_0.5"] == ""
    with _Recorder() as rec:
        jax_plots.plot_results_csv(path, tmp_path / "jax.png")
    xs, cols = plots.results_csv_data(path)
    assert list(cols) == ["train/fam_cls_loss", "train/odm_reg_loss", "lr/0", "time/epoch_s",
                          "metrics/mAP_0.5", "val/odm_cls_loss"]
    assert cols["metrics/mAP_0.5"] is None and cols["val/odm_cls_loss"] is None
    drawn = [ys for ys in cols.values() if ys is not None]
    assert len(rec.calls) == len(drawn) == 4
    for (kind, args, kw, _), ys in zip(rec.calls, drawn):
        assert kind == "plot" and kw == {"marker": "."}
        assert args[0] == xs == [0.0, 1.0, 2.0, 3.0, 4.0] and args[1] == ys
    plots.plot_results_csv(path, tmp_path / "port.png")
    assert imread(tmp_path / "port.png").shape == imread(tmp_path / "jax.png").shape == (
        720, 1920, 3)

    # no rows: no file from either
    empty = tmp_path / "empty.csv"
    empty.write_text("epoch_or_step,train/fam_cls_loss\n")
    jax_plots.plot_results_csv(empty, tmp_path / "jax_empty.png")
    plots.plot_results_csv(empty, tmp_path / "port_empty.png")
    assert not (tmp_path / "jax_empty.png").exists()
    assert not (tmp_path / "port_empty.png").exists()


PLOTS = ("labels.png", "train_batch0.png", "train_batch1.png", "train_batch2.png",
         "pr_curves.png", "results.png")


def test_trainer_writes_the_plots(tmp_path):
    root = tmp_path / "data"
    rng = np.random.default_rng(2)
    synth.write_split(root / "train", 6, rng, 64, 3, 3)
    synth.write_split(root / "val", 2, rng, 64, 3, 3)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(
        "model: {backbone: resnet18, num_classes: 3, max_per_img: 20, pre_nms_cap: 64, "
        "max_before_nms_per_level: 50}\n"
        "data: {img_size: 64, max_gt: 4, names: [a, b, c], workers: 1}\n"
        "train: {warmup_iters: 0, dtype: float32}\n"
        "eval: {batch_size: 2}\n")
    common = ["--config", str(cfg), "--data-root", str(root / "train/images"), "--val-root",
              str(root / "val/images"), "--batch-size", "2", "--device", "cpu"]
    summary = train_cli.main(common + ["--epochs", "2", "--save-dir", str(tmp_path / "run")])
    run = tmp_path / "run"
    sizes = {"labels.png": (960, 1200), "pr_curves.png": (720, 960),
             "results.png": (1440, 1920)}
    for name in PLOTS:
        img = imread(run / name)
        assert img is not None, name
        assert img.shape[:2] == sizes.get(name, (128, 128)), (name, img.shape)
    assert summary["plots_seconds"] > summary["batch_plots_seconds"] > 0

    quiet = train_cli.main(common + ["--epochs", "1", "--noplots",
                                     "--save-dir", str(tmp_path / "quiet")])
    assert (tmp_path / "quiet" / "results.csv").exists()
    assert not any((tmp_path / "quiet" / name).exists() for name in PLOTS)
    assert quiet["plots_seconds"] == 0.0

