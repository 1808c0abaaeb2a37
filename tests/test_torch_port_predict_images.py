"""``python -m s2anet_tpu_torch.predict`` on image files against the
repository's ``predict.py``, on the CPU at a small size.

* The model input from a PNG with its fresh BGR ``.npy`` sidecar equals
  ``predict.py``'s (``cv2.imread(...)[:, :, ::-1].astype(float32) / 255``)
  bit for bit: the port once took the sidecar for RGB.
* Both CLIs on one seeded R-18 (15 classes, float32; the port's weights
  carried to the JAX variables by ``convert_reference_s2anet`` and saved
  as the deploy checkpoint ``predict.py``'s ``_load_state`` reads), on a
  300 x 200 scene tiled into 6 windows and a 90 x 100 scene with no
  detections: every ``<name>.txt`` equal line for line (the tolerance of
  the port's other predict-against-JAX comparison: the printed digits),
  the empty scene's a lone newline, and the ``dota_submission/Task1_*``
  files the same lines with each score within 1e-6 (one unit of its last
  printed place).
* Class names as ``predict.py`` writes them, on stubbed detections:
  ``--num-classes 2`` without ``--names`` writes ``0`` / ``1`` and
  ``--config configs/hrsc_r50.yaml`` writes ``0``; an image without
  detections gets a lone newline.
* ``--save-img`` writes a PNG whose box pixels lie within one pixel of
  those ``cv2.polylines`` colours for the same boxes, and the other way
  round, away from the label text and the image's border.
"""

import contextlib
import functools
import sys
from pathlib import Path
from unittest import mock

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

import s2anet_tpu.parallel.step as jax_step
import s2anet_tpu.utils.jax_cache as jax_cache
from s2anet_tpu.models.detector import S2ANet as JaxS2ANet
from s2anet_tpu.models.torch_import import convert_reference_s2anet
from s2anet_tpu_torch import predict
from s2anet_tpu_torch.config import ModelConfig
from s2anet_tpu_torch.data.image import imread
from s2anet_tpu_torch.models.detector import S2ANet
from s2anet_tpu_torch.ops.polyiou import rbox_vertices_np
from s2anet_tpu_torch.utils import plots

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import predict as jax_predict  # noqa: E402

SIZE = 128
HRSC_CONFIG = ROOT / "configs" / "hrsc_r50.yaml"


def _jit_init(self, rng, x, train=False):
    """``S2ANet.init`` compiled once instead of run op by op (its random
    values are replaced by the checkpoint's): 30 s less on the CPU."""
    return jax.jit(lambda r, x: _EAGER_INIT(self, r, x, train=train))(rng, x)


_EAGER_INIT = JaxS2ANet.init


def _run_jax(argv, float32=True):
    """``predict.py`` with ``argv``, its eval step in float32 (its default
    is bf16) and without its persistent compile cache."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(
            jax_cache, "enable_persistent_cache", lambda *a, **k: None))
        stack.enter_context(mock.patch.object(sys, "argv", ["predict.py", *argv]))
        if float32:
            stack.enter_context(mock.patch.object(jax_step, "make_eval_step", functools.partial(
                jax_step.make_eval_step, compute_dtype=jnp.float32)))
            stack.enter_context(mock.patch.object(JaxS2ANet, "init", _jit_init))
        jax_predict.main(jax_predict.parse_opt())


def _gap_threshold(pred, chip, lo=40, hi=120):
    """A score in the widest gap between the ``lo``-th and ``hi``-th
    highest (anchor, class) scores of ``chip``."""
    with torch.no_grad():
        out = pred.forward(pred.to_input(chip[None]))
    s = np.sort(np.concatenate([torch.sigmoid(c[0]).reshape(-1).numpy()
                                for c in out["odm_cls"]]))[::-1]
    i = lo + int(np.argmax(s[lo - 1:hi - 1] - s[lo:hi]))
    return float((s[i - 1] + s[i]) / 2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs on ``src/{scene,blank}.png`` with one seeded model."""
    root = tmp_path_factory.mktemp("predict_images")
    sd = S2ANet("resnet18").init_weights(torch.Generator().manual_seed(5)).state_dict()
    torch.save(sd, root / "w.pt")
    jv = convert_reference_s2anet(sd, "resnet18")
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(root / "deploy", {"params": jv["params"], "batch_stats": jv["batch_stats"]})
    rng = np.random.default_rng(0)
    src = root / "src"
    src.mkdir()
    scene = rng.integers(0, 50, (300, 200, 3), dtype=np.uint8)
    cv2.imwrite(str(src / "scene.png"), scene)
    cv2.imwrite(str(src / "blank.png"), np.zeros((90, 100, 3), np.uint8))
    (src / "notes.txt").write_text("not an image")
    pred = predict.S2ANetPredictor(ModelConfig(backbone="resnet18"), str(root / "w.pt"),
                                   device="cpu", dtype=torch.float32, divide=True)
    thr = _gap_threshold(pred, np.ascontiguousarray(scene[:SIZE, :SIZE, ::-1]))
    common = ["--source", str(src), "--img-size", str(SIZE), "--gap", "32",
              "--batch-size", "2", "--backbone", "resnet18", "--conf", repr(thr)]
    recorded = []
    real_draw = predict.draw_rboxes

    def record(img, rboxes, **kw):
        recorded.append((img.copy(), np.asarray(rboxes), kw))
        return real_draw(img, rboxes, **kw)

    with mock.patch.object(predict, "draw_rboxes", record):
        summary = predict.main(common + ["--device", "cpu", "--dtype", "float32", "--save-img",
                                         "--weights", str(root / "w.pt"),
                                         "--save-dir", str(root / "port")])
    _run_jax(common + ["--weights", str(root / "deploy"), "--save-dir", str(root / "jax")])
    return root, summary, recorded


def test_txt_and_submission_match_predict_py(runs):
    root, summary, _ = runs
    assert summary["images"] == 2 and summary["chips"] == 7  # 6 windows + 1
    got = sorted(p.relative_to(root / "port") for p in (root / "port").rglob("*.txt"))
    want = sorted(p.relative_to(root / "jax") for p in (root / "jax").rglob("*.txt"))
    assert got == want and len(got) == 2 + 15
    scene = (root / "port" / "scene.txt").read_text()
    assert scene == (root / "jax" / "scene.txt").read_text()
    assert 50 < len(scene.splitlines()) == summary["detections"]
    assert (root / "port" / "blank.txt").read_text() == "\n"
    assert (root / "jax" / "blank.txt").read_text() == "\n"
    for f in sorted((root / "jax" / "dota_submission").glob("Task1_*.txt")):
        g = [line.split() for line in (root / "port" / "dota_submission" / f.name)
             .read_text().splitlines()]
        w = [line.split() for line in f.read_text().splitlines()]
        assert [(a[0], a[2:]) for a in g] == [(b[0], b[2:]) for b in w], f.name
        assert all(abs(float(a[1]) - float(b[1])) <= 1e-6 for a, b in zip(g, w)), f.name


def test_save_img_draws_the_boxes_cv2_draws(runs):
    """The ``scene.png`` drawing: a PNG of the scene's size whose changed
    pixels (the noise is below 50, every palette colour has a channel
    above it) lie within one pixel of ``cv2.polylines``' pixels for the
    same rotated boxes at thickness 2 and the other way round, outside the
    labels' text boxes and the 3 border pixels."""
    root, _, recorded = runs
    assert (root / "port" / "blank.png").exists()
    png = root / "port" / "scene.png"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    drawn = cv2.imread(str(png))
    [(img, rboxes, kw)] = [r for r in recorded if r[0].shape[:2] == (300, 200)]
    np.testing.assert_array_equal(drawn, plots.draw_rboxes(img, rboxes, **kw))
    np.testing.assert_array_equal(imread(png), drawn)
    polys = rbox_vertices_np(rboxes).astype(np.int32)
    ref = np.zeros(img.shape[:2], np.uint8)
    cv2.polylines(ref, [p.reshape(-1, 1, 2) for p in polys], True, 1, 2)
    mine = (drawn != img).any(2)
    judged = np.zeros(mine.shape, bool)
    judged[3:-3, 3:-3] = True
    for k, p in enumerate(polys):
        label = kw["names"][int(kw["classes"][k])] + f" {float(kw['scores'][k]):.2f}"
        x0, y0, x1, y1 = plots.text_box(label, plots.label_origin(p))
        judged[max(y0 - 1, 0):max(y1 + 1, 0), max(x0 - 1, 0):max(x1 + 1, 0)] = False
    near = np.ones((3, 3), np.uint8)
    assert mine[judged].sum() > 500 and ref.astype(bool)[judged].sum() > 500
    assert not (mine & ~cv2.dilate(ref, near).astype(bool) & judged).any()
    assert not (ref.astype(bool) & ~cv2.dilate(mine.astype(np.uint8), near).astype(bool)
                & judged).any()


def test_model_input_from_png_and_sidecar_is_predict_py_s(tmp_path):
    """The fault: a PNG beside its fresh BGR sidecar gives the model
    ``predict.py``'s input, ``cv2.imread`` flipped to RGB over 255."""
    src = tmp_path / "src"
    src.mkdir()
    bgr = np.random.default_rng(1).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    cv2.imwrite(str(src / "chip.png"), bgr)
    np.save(src / "chip.npy", cv2.imread(str(src / "chip.png")))  # newer than the PNG
    seen = []
    real = predict.S2ANetPredictor.forward

    def forward(self, x):
        seen.append(x.clone())
        return real(self, x)

    with mock.patch.object(predict.S2ANetPredictor, "forward", forward):
        predict.main(["--source", str(src), "--img-size", str(SIZE), "--batch-size", "1",
                      "--backbone", "resnet18", "--device", "cpu", "--dtype", "float32",
                      "--save-dir", str(tmp_path / "out")])
    want = cv2.imread(str(src / "chip.png"))[:, :, ::-1].astype(np.float32) / 255.0
    np.testing.assert_array_equal(seen[0][0].permute(1, 2, 0).numpy(), want)
    # --npy refuses the sidecar and takes an RGB array alone
    with pytest.raises(SystemExit, match="BGR sidecar"):
        predict.main(["--source", str(src), "--npy", "--device", "cpu",
                      "--save-dir", str(tmp_path / "npy")])


def test_npy_source_without_npy_is_refused(tmp_path):
    """A ``.npy`` file given as ``--source`` without ``--npy`` is refused:
    it is no sidecar of itself, and its channels are not taken as BGR."""
    rgb = tmp_path / "one.npy"
    np.save(rgb, np.random.default_rng(2).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8))
    with pytest.raises(SystemExit, match="--npy"):
        predict.main(["--source", str(rgb), "--img-size", str(SIZE), "--backbone", "resnet18",
                      "--device", "cpu", "--dtype", "float32",
                      "--save-dir", str(tmp_path / "out")])


class _State:
    """The fields ``predict.py``'s ``main`` reads of a train state."""
    params = ema_params = batch_stats = ema_batch_stats = None

    def replace(self, **kw):
        return self


@pytest.mark.parametrize("argv,names", [
    (["--num-classes", "2"], ["0", "1"]),
    (["--config", str(HRSC_CONFIG)], ["0"]),
    (["--num-classes", "1", "--names", "hrsc"], ["ship"]),
    ([], ["plane", "baseball-diamond"]),
    ([], []),  # no detections: a lone newline
])
def test_class_names_as_predict_py(tmp_path, argv, names):
    """One detection of each class (or none), stubbed in both CLIs, on an
    image of one name (``predict.py`` reads it from a PNG, the port makes
    it with ``--synthetic 1``): the same ``<name>.txt`` and ``Task1_*``
    files."""
    src = tmp_path / "src"
    src.mkdir()
    cv2.imwrite(str(src / "synthetic_0000.png"), np.zeros((64, 64, 3), np.uint8))
    poly = np.array([10, 10, 30, 10, 30, 20, 10, 20], np.float64)
    dets = [(c, 0.5 + 0.1 * c, poly + c) for c in range(len(names))]

    def serve(pred, inputs, img_size, gap, batch_size, iou_thr, timing):
        timing.update(model=0.0, merge=0.0)
        for name, _ in inputs:
            yield name, 1, dets

    common = ["--backbone", "resnet18", "--img-size", "64", *argv]
    with mock.patch.object(predict, "serve_chips", serve):
        predict.main(["--synthetic", "1", *common, "--device", "cpu",
                      "--save-dir", str(tmp_path / "port")])
    with mock.patch.object(jax_predict, "_load_state", lambda *a: _State()), \
            mock.patch("s2anet_tpu.models.fold.fold_bn_for_eval", lambda m, v: (m, v)), \
            mock.patch.object(jax_step, "make_eval_step", lambda *a, **k: None), \
            mock.patch.object(jax_predict, "_predict_chips", lambda *a: dets):
        _run_jax(["--source", str(src), *common, "--save-dir", str(tmp_path / "jax")],
                 float32=False)
    got = (tmp_path / "port" / "synthetic_0000.txt").read_text()
    assert got == (tmp_path / "jax" / "synthetic_0000.txt").read_text()
    assert [line.split()[0] for line in got.splitlines() if line] == names
    assert names or got == "\n"
    files = sorted(p.name for p in (tmp_path / "jax" / "dota_submission").iterdir())
    assert sorted(p.name for p in (tmp_path / "port" / "dota_submission").iterdir()) == files
    for f in files:
        assert ((tmp_path / "port" / "dota_submission" / f).read_text()
                == (tmp_path / "jax" / "dota_submission" / f).read_text())
