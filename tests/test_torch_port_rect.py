"""The port's rect batching against the JAX package's, on the CPU.

* ``BatchLoader._batch_plan`` (shape-ordered batches, per-batch targets)
  and ``_img_capacity`` equal the JAX loader's, on the JAX test's fake
  dataset and on random mixes of portrait, landscape and square shapes.
* ``DotaDataset.shapes()`` equals the JAX one on PNGs with sidecars (no PIL
  needed), on a pack the JAX package built, and through the shared
  ``shapes.cache.npz``, written by either package and read by the other.
* Rect batches (workers 1 and 3): targets, paths and shapes bit for bit;
  uint8 images times float32(1/255) equal to the JAX loader's float32
  images where the letterbox only pads, within one level where it resizes.
* ``evaluate_on_chips`` with ``eval.rect`` on five non-square images, R-18
  at 256, float32, against the JAX ``evaluate_on_chips`` with the same
  weights (crossed as a JAX ``.npz``): detections matched 1:1 at least 95%,
  mAP50 within 0.02; a box-finding stub step gives mAP 1.0 at more than one
  batch shape and fewer pixels than square batches; rect with the val
  losses raises.
"""

import dataclasses

import cv2
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from s2anet_tpu.data import dota as jax_dota
from s2anet_tpu.eval import runner as jax_runner
from s2anet_tpu.models.fold import fold_bn_for_eval
from s2anet_tpu.parallel.step import make_eval_step
from s2anet_tpu.train.optim import build_optimizer
from s2anet_tpu.train.state import create_train_state
from s2anet_tpu.utils import config as jax_config
from s2anet_tpu_torch import config
from s2anet_tpu_torch.data import dota, image
from s2anet_tpu_torch.eval import runner
from s2anet_tpu_torch.models.convert import save_jax_npz
from s2anet_tpu_torch.predict import S2ANetPredictor
from test_torch_port_val import _chip_lines, _matched, _variables

SIZE = 256
STRIDE = 32


class FakeDS:
    """The JAX test's dataset of shapes (tests/test_round3_features.py)."""

    def __init__(self, shapes, img_size):
        self._s, self.img_size, self.max_gt = np.asarray(shapes), img_size, 4

    def __len__(self):
        return len(self._s)

    def shapes(self):
        return self._s


def _mix(seed, n):
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 3, n)  # portrait, landscape, square
    long = rng.integers(100, 1200, n)
    short = (long * rng.uniform(0.3, 1.0, n)).astype(int)
    h = np.where(kind == 0, long, np.where(kind == 1, short, long))
    w = np.where(kind == 0, short, long)
    return np.stack([h, w], 1)


PLANS = {  # name: (shapes, img_size, batch, drop_last, stride)
    "jax_fake": ([[512, 1024]] * 4 + [[768, 1024]] * 4, 1024, 4, True, 32),
    "mix_b3": (_mix(0, 17), 800, 3, False, 32),
    "mix_b4_drop": (_mix(1, 23), 1024, 4, True, 32),
    "mix_b2_s64": (_mix(2, 9), 512, 2, False, 64),
    "ties": ([[300, 600]] * 3 + [[600, 300]] * 3 + [[400, 400]] * 3, 256, 2, False, 32),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_batch_plan_matches_jax(name):
    shapes, size, bs, drop, stride = PLANS[name]
    ds = FakeDS(shapes, size)
    kw = dict(shuffle=False, drop_last=drop, rect=True, rect_stride=stride)
    port = dota.BatchLoader(ds, bs, **kw)
    ref = jax_dota.BatchLoader(ds, bs, **kw)
    got, want = port._batch_plan(), ref._batch_plan()
    assert len(got) == len(want) == len(ref)
    for (gi, gt), (wi, wt) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        assert gt == wt and all(v % stride == 0 for v in gt)
    assert port._img_capacity() == ref._img_capacity()
    if name == "jax_fake":
        assert [t for _, t in got] == [(544, 1056), (800, 1056)]
    else:
        assert len({t for _, t in got}) > 1
    assert all(t is None for _, t in dota.BatchLoader(ds, bs)._batch_plan())
    with pytest.raises(ValueError, match="shuffle"):
        dota.BatchLoader(ds, bs, shuffle=True, rect=True)


RECT_SHAPES = [(96, 256), (128, 256), (256, 160), (256, 256), (192, 256)]


def _png_set(root, shapes, sidecars=True, seed=0):
    """``root/images/*.png`` (cv2), their newer BGR sidecars, and one
    YOLO-rotated box per image."""
    from test_torch_port_data import _rect

    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for i, (h, w) in enumerate(shapes):
        img = rng.integers(0, 80, (h, w, 3), dtype=np.uint8)
        pts = _rect(rng, h, w)
        cv2.fillPoly(img, [pts.round().astype(np.int32)], (200, 220, 240))
        png = root / "images" / f"im_{i:02d}.png"
        cv2.imwrite(str(png), img)
        if sidecars:
            np.save(png.with_suffix(".npy"), img)
        norm = (pts / [w, h]).clip(0, 1).reshape(-1)
        (root / "labels" / f"im_{i:02d}.txt").write_text(
            f"{i % 3} " + " ".join(f"{v:.6f}" for v in norm) + "\n")
    return root / "images"


@pytest.mark.parametrize("source", ["sidecar", "pack", "jax_cache"])
def test_shapes_match_jax(tmp_path, source, monkeypatch):
    """A file that is not an image gets ``(img_size, img_size)``, the JAX
    package's shape for an image it cannot read, with PIL and without; the
    PNGs' shapes come from their headers, or their sidecars."""
    images = _png_set(tmp_path, RECT_SHAPES + [(300, 90)], sidecars=source != "pack")
    (images / "broken.png").write_bytes(b"not an image")
    cache = images / "shapes.cache.npz"
    want = jax_dota.DotaDataset(images, img_size=SIZE, cache_labels=False).shapes()
    # sorted: broken.png first
    assert want.tolist() == [[SIZE, SIZE]] + [list(s) for s in RECT_SHAPES + [(300, 90)]]
    if source == "jax_cache":
        # the port reads the JAX package's cache and reads no image
        monkeypatch.setattr(dota.DotaDataset, "_header_shape", lambda *a: 1 / 0)
        got = dota.DotaDataset(images, img_size=SIZE).shapes()
        np.testing.assert_array_equal(got, want)
        return
    cache.unlink()
    if source == "sidecar":
        np.testing.assert_array_equal(dota.DotaDataset(images, img_size=SIZE).shapes(), want)
        cache.unlink()
    monkeypatch.setattr(image, "HAVE_PIL", False)  # the card's machine may have no PIL
    if source == "pack":
        (images / "broken.png").unlink()
        want = want[1:]
        jax_dota.DotaDataset(images, img_size=SIZE, cache_images="packed")
        cache.unlink(missing_ok=True)
        ds = dota.DotaDataset(images, img_size=SIZE, cache_images="packed")
    else:
        ds = dota.DotaDataset(images, img_size=SIZE)
    got = ds.shapes()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # the JAX package reads the port's cache: with every image unreadable it
    # would fall back to (img_size, img_size)
    assert cache.exists()
    monkeypatch.setattr(PIL.Image, "open", lambda *a, **k: 1 / 0)
    again = jax_dota.DotaDataset(images, img_size=SIZE, cache_labels=False).shapes()
    np.testing.assert_array_equal(again, want)


@pytest.mark.parametrize("kind,workers", [("pad", 1), ("pad", 3), ("resize", 2)])
def test_rect_batches_match_jax(tmp_path, kind, workers):
    """Pad-only letterboxes: the long side of each image is the largest rect
    side, ``ceil(S / stride + 0.5) * stride`` (288 at 256), so every
    target holds its images unscaled; otherwise they are resized."""
    shapes = ([(108, 288), (144, 288), (288, 160), (288, 288), (200, 288), (288, 130)]
              if kind == "pad" else RECT_SHAPES)
    images = _png_set(tmp_path, shapes)
    kw = dict(shuffle=False, drop_last=False, num_workers=workers, rect=True,
              rect_stride=STRIDE)
    port = dota.BatchLoader(dota.DotaDataset(images, img_size=SIZE, max_gt=4), 2, **kw)
    ref = jax_dota.BatchLoader(jax_dota.DotaDataset(images, img_size=SIZE, max_gt=4,
                                                    cache_images="disk"), 2, **kw)
    got, want = list(port), list(ref)
    assert len(got) == len(want) == 3
    targets = set()
    for g, w in zip(got, want):
        for key in ("gt_boxes", "gt_classes", "gt_mask"):
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        for key in ("paths", "orig_shapes", "img_shapes"):
            assert g[key] == w[key], key
        assert g["imgs"].dtype == np.uint8 and g["imgs"].shape == w["imgs"].shape
        assert g["imgs"].flags["C_CONTIGUOUS"]
        targets.add(g["imgs"].shape[1:3])
        scaled = g["imgs"].astype(np.float32) * np.float32(1 / 255)
        if kind == "pad":
            np.testing.assert_array_equal(scaled, w["imgs"])
        else:
            level = np.abs(g["imgs"].astype(int) - np.rint(w["imgs"] * 255).astype(int))
            assert level.max() <= 1  # the letterbox's bound (test_torch_port_data.py)
    assert len(targets) > 1 and max(h * w for h, w in targets) > SIZE * SIZE


# ------------------------------------------------------- the runner


def _box_set(root, shapes):
    """Non-square images with one white axis-aligned box at a fixed
    relative position, and its YOLO label (the JAX test's set)."""
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for i, (h, w) in enumerate(shapes):
        img = np.full((h, w, 3), 20, np.uint8)
        x0, y0, x1, y1 = int(0.25 * w), int(0.25 * h), int(0.625 * w), int(0.5 * h)
        img[y0:y1, x0:x1] = 255
        png = root / "images" / f"im{i:02d}.png"
        cv2.imwrite(str(png), img)
        np.save(png.with_suffix(".npy"), img)
        fx0, fy0, fx1, fy1 = x0 / w, y0 / h, x1 / w, y1 / h
        (root / "labels" / f"im{i:02d}.txt").write_text(
            f"0 {fx0} {fy0} {fx1} {fy0} {fx1} {fy1} {fx0} {fy1}\n")
    return root / "images"


def _box_finder(imgs):
    """The white box found in each letterboxed uint8 RGB image."""
    imgs = np.asarray(imgs)
    b, k = imgs.shape[0], 8
    boxes = np.zeros((b, k, 6), np.float32)
    valid = np.zeros((b, k), bool)
    for n in range(b):
        ys, xs = np.where(imgs[n].astype(int).sum(-1) > 1.5 * 255)
        if len(xs):
            x0, x1, y0, y1 = xs.min(), xs.max(), ys.min(), ys.max()
            boxes[n, 0] = [(x0 + x1 + 1) / 2, (y0 + y1 + 1) / 2, x1 - x0 + 1, y1 - y0 + 1,
                           0.0, 0.9]
            valid[n, 0] = True
    return boxes, np.zeros((b, k), np.int32), valid


def test_rect_eval_box_finder_map_one(tmp_path):
    images = _box_set(tmp_path, [(96, 256), (128, 256), (96, 256), (192, 256), (256, 256)])
    seen, out = {}, {}
    for rect in (False, True):
        cfg = config.load_config(None, {"data": {"img_size": SIZE, "max_gt": 8, "names": ["a"]},
                                        "eval": {"batch_size": 2, "rect": rect}})
        seen[rect] = []

        def step(imgs, _seen=seen[rect]):
            _seen.append(tuple(np.asarray(imgs).shape[1:3]))
            return _box_finder(imgs)

        out[rect] = runner.evaluate_on_chips(step, cfg, dataset=dota.DotaDataset(
            images, img_size=SIZE, max_gt=8))
    assert out[False]["map50"] == pytest.approx(1.0)
    assert out[True]["map50"] == pytest.approx(1.0)
    assert set(seen[False]) == {(SIZE, SIZE)}
    assert len(set(seen[True])) >= 2 and min(h for h, _ in seen[True]) < SIZE
    assert sum(h * w for h, w in seen[True]) < sum(h * w for h, w in seen[False])
    with pytest.raises(ValueError, match="rect"):
        runner.evaluate_on_chips(step, cfg, dataset=dota.DotaDataset(images, img_size=SIZE),
                                 with_loss=True)


N_GT = 15  # per image: the JAX model's top detections inside the frame


def test_rect_eval_matches_jax(tmp_path):
    images = _png_set(tmp_path / "set", [(96, 256), (100, 256), (110, 256), (104, 256),
                                         (256, 176)], seed=3)
    jmodel, variables = _variables(1)
    save_jax_npz(tmp_path / "w.npz", variables)
    port = S2ANetPredictor(config.ModelConfig(backbone="resnet18"), str(tmp_path / "w.npz"),
                           device="cpu", dtype=torch.float32)
    plan = dota.BatchLoader(dota.DotaDataset(images, img_size=SIZE), 2, rect=True)
    first = next(iter(plan))["imgs"]
    out = port.forward(port.to_input(first))
    scores = torch.cat([torch.sigmoid(c[0].reshape(-1)) for c in out["odm_cls"]])
    thr = float(scores.sort(descending=True).values[300])
    port.cfg = dataclasses.replace(port.cfg, score_thr=thr)

    jcfg = jax_config.load_config(None, {
        "model": {"backbone": "resnet18", "score_thr": thr},
        "data": {"img_size": SIZE}, "eval": {"batch_size": 2, "rect": True},
        "train": {"dtype": "float32"}})
    fmodel, folded = fold_bn_for_eval(jmodel, variables)
    tx = build_optimizer(lambda _: 0.0, params_example=folded["params"])
    state = create_train_state(folded["params"], folded["batch_stats"], tx)
    step = make_eval_step(fmodel, model_cfg=jcfg.model, compute_dtype=jnp.float32)

    def jax_eval(save_dir=None):
        return jax_runner.evaluate_on_chips(
            fmodel, state, jcfg, eval_step=step, save_dir=save_dir,
            dataset=jax_dota.DotaDataset(images, img_size=SIZE, cache_images="disk"))

    # labels: the JAX model's own top detections (original frame, from its
    # Task1 files) inside each image
    jax_eval(tmp_path / "jax_unlabelled")
    dets = {}
    for c, cname in enumerate(jcfg.data.names):
        for line in (tmp_path / "jax_unlabelled" / "chip_results" /
                     f"Task1_{cname}.txt").read_text().splitlines():
            img, score, *coords = line.split()
            dets.setdefault(img, []).append((c, float(score), np.array(coords, float)))
    assert len(dets) == 5
    for name, dets in dets.items():
        h, w = cv2.imread(str(images / f"{name}.png")).shape[:2]
        rows = [(c, p) for c, s, p in sorted(dets, key=lambda d: -d[1])
                if (p[0::2] >= 0).all() and (p[0::2] <= w).all()
                and (p[1::2] >= 0).all() and (p[1::2] <= h).all()][:N_GT]
        assert len(rows) == N_GT
        (images.parent / "labels" / f"{name}.txt").write_text("".join(
            f"{c} " + " ".join(f"{v:.6f}" for v in p / np.tile([w, h], 4)) + "\n"
            for c, p in rows))
    want = jax_eval(tmp_path / "jax")
    pcfg = config.load_config(None, {
        "model": {"backbone": "resnet18", "score_thr": thr},
        "data": {"img_size": SIZE}, "eval": {"batch_size": 2, "rect": True}})
    shapes = []
    real = port.predict

    def record(imgs, **kw):
        shapes.append(tuple(np.asarray(imgs).shape[1:3]))
        return real(imgs, **kw)

    port.predict = record
    got = runner.evaluate_on_chips(port, pcfg, dataset=dota.DotaDataset(images, img_size=SIZE),
                                   save_dir=tmp_path / "port")
    assert len(set(shapes)) == 2 and all(h % STRIDE == 0 and w % STRIDE == 0
                                         for h, w in shapes)
    assert sum(h * w for h, w in shapes) < len(shapes) * SIZE * SIZE
    with_gt = [r for r in want["per_class"].values() if r["npos"]]
    assert with_gt and want["map50"] > 0.1
    assert abs(got["map50"] - want["map50"]) <= 0.02
    assert got["n_images"] == want["n_images"] == 5
    p, r = _chip_lines(tmp_path / "port"), _chip_lines(tmp_path / "jax")
    assert p.keys() == r.keys() and len(p) == 5
    for chip in r:
        assert len(r[chip]) > 50
        assert _matched(p[chip], r[chip]) >= 0.95 * max(len(p[chip]), len(r[chip]))
