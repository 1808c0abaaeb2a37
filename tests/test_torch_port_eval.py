"""The port's evaluation path against the JAX package's, on the CPU.

Seeded inputs go through ``s2anet_tpu`` and ``s2anet_tpu_torch``: the
double-precision polygon IoU (the port's C++ copy and its NumPy loops
against ``polyiou_ref``, within 1e-12), polygon NMS and the cross-chip
merge, VOC AP and the per-class evaluation, and the whole evaluation runner
fed by one stub step with fixed detection buffers (a partial last batch
included), in chip mode and in merge mode, down to the bytes of the
``Task1_*.txt`` files it saves.
"""

import dataclasses
import itertools
from pathlib import Path

import cv2
import numpy as np
import pytest

from s2anet_tpu import native as jax_native
from s2anet_tpu.data import merge as jax_merge
from s2anet_tpu.data.dota import DotaDataset as JaxDataset
from s2anet_tpu.eval import runner as jax_runner
from s2anet_tpu.eval import voc_eval as jax_voc
from s2anet_tpu.ops import polyiou_ref
from s2anet_tpu.utils import config as jax_config
from s2anet_tpu_torch import native
from s2anet_tpu_torch.config import Config, DataConfig, EvalConfig
from s2anet_tpu_torch.data import merge
from s2anet_tpu_torch.data.dota import BatchLoader, DotaDataset
from s2anet_tpu_torch.eval import runner, voc_eval
from s2anet_tpu_torch.ops import polyiou
from test_torch_port_data import SIZE, make_dota_set


def _boxes(rng, n, spread=60.0):
    return np.stack([rng.uniform(0, spread, n), rng.uniform(0, spread, n),
                     rng.uniform(4, 40, n), rng.uniform(2, 20, n),
                     rng.uniform(-np.pi, np.pi, n)], 1)


def _degenerate():
    return np.array([[10, 10, 0, 5, 0.3], [10, 10, 5, 0, 0.0], [10, 10, 0, 0, 0],
                     [10, 10, 8, 4, 0.0], [10, 10, 8, 4, 0.0],        # identical
                     [18, 10, 8, 4, 0.0], [10, 14, 8, 4, 0.0],        # touching
                     [10, 10, 8, 4, np.pi / 2], [10, 10, 1e-9, 4, 0.1]])


def test_native_is_built():
    assert native.AVAILABLE  # this machine has a host compiler
    src = Path(native.SRC).read_text()
    ref = (Path(jax_native.__file__).parent / "polyiou.cpp").read_text()
    cut = "#include <algorithm>"
    assert src[src.index(cut):] == ref[ref.index(cut):]


def test_polygon_iou_matches_oracle(rng, monkeypatch):
    """Within 1e-12 of the NumPy oracle where both polygons have an area;
    a polygon of (near) zero area makes IoU 0/0, where the C++ and NumPy
    paths round apart in both packages: there each port path equals its
    JAX counterpart exactly."""
    boxes = np.concatenate([_boxes(rng, 40), _degenerate()])
    verts = polyiou.rbox_vertices_np(boxes)
    np.testing.assert_array_equal(verts, polyiou_ref.rbox_vertices_np(boxes))
    areas = boxes[:, 2] * boxes[:, 3]
    jax_c = {(i, j): jax_native.iou_poly_native(verts[i], verts[j])
             for i, j in itertools.product(range(len(boxes)), repeat=2)}
    want_m = jax_native.rbox_iou_matrix_native(boxes, boxes)
    for name in ("iou_poly_native", "rbox_iou_matrix_native"):
        monkeypatch.setattr(jax_native, name, lambda *a, **k: None)
    for (i, j), c in jax_c.items():
        want = polyiou_ref.iou_poly(verts[i], verts[j])
        got_np = polyiou.iou_poly_np(verts[i], verts[j])
        got_c = polyiou.iou_poly(verts[i].ravel(), verts[j])
        assert got_np == want and got_c == c
        if min(areas[i], areas[j]) > 1e-6:
            assert abs(got_c - want) <= 1e-12
        clip = polyiou.clip_polygon(verts[i], verts[j])
        np.testing.assert_array_equal(clip, polyiou_ref.clip_polygon(verts[i], verts[j]))
    want = polyiou_ref.box_iou_rotated_np(boxes, boxes)
    np.testing.assert_array_equal(polyiou.box_iou_rotated_loops(boxes, boxes), want)
    np.testing.assert_array_equal(polyiou.box_iou_rotated_np(boxes, boxes), want_m)
    real = np.minimum(areas[:, None], areas[None]) > 1e-6
    assert np.abs(want_m - want)[real].max() <= 1e-12
    assert (want > 0).sum() > 100


def _polys_scores(rng, n):
    polys = polyiou.rbox_vertices_np(_boxes(rng, n, 120.0)).reshape(-1, 8)
    scores = rng.choice([0.9, 0.7, 0.5], n) + rng.uniform(0, 1e-3, n) * (rng.uniform(size=n) < 0.5)
    return polys, scores  # many tied scores


@pytest.mark.parametrize("thr", [0.5, 0.1])
def test_poly_nms_matches_jax(rng, thr, monkeypatch):
    polys, scores = _polys_scores(rng, 300)
    want = jax_merge.poly_nms_np(polys, scores, thr)
    assert merge.poly_nms_np(polys, scores, thr) == want
    assert merge.poly_nms_loops(polys, scores, thr) == want
    monkeypatch.setattr(jax_native, "poly_nms_native", lambda *a: None)
    assert jax_merge.poly_nms_np(polys, scores, thr) == want
    assert 20 < len(want) < 300
    assert merge.poly_nms_np(polys[:0], scores[:0], thr) == []


def _chip_dets(rng, scene_hw=(300, 200), size=128, gap=32):
    """Detections of objects seen by overlapping windows: each object in
    scene coordinates, reported (jittered) by every window holding its
    centre, plus clutter."""
    from s2anet_tpu_torch.data.split import window_origins

    h, w = scene_hw
    objs = _boxes(rng, 40)
    objs[:, 0] = rng.uniform(0, w, 40)
    objs[:, 1] = rng.uniform(0, h, 40)
    cls = rng.integers(0, 4, 40)
    dets = {}
    for left, up in window_origins(h, w, size, size - gap):
        name = f"P0007__1.0__{left}___{up}"
        inside = ((objs[:, 0] >= left) & (objs[:, 0] < left + size)
                  & (objs[:, 1] >= up) & (objs[:, 1] < up + size))
        local = objs[inside] - [left, up, 0, 0, 0]
        local = local + rng.normal(size=local.shape) * [0.5, 0.5, 0.3, 0.3, 0.01]
        clutter = _boxes(rng, 5, size)
        rb = np.concatenate([local, clutter])
        labels = np.concatenate([cls[inside], rng.integers(0, 4, 5)])
        scores = rng.uniform(0.05, 1, len(rb))
        polys = polyiou.rbox_vertices_np(rb).reshape(-1, 8)
        dets[name] = [(int(c), float(s), p) for c, s, p in zip(labels, scores, polys)]
    return dets, objs, cls


def test_merge_chip_detections_matches_jax(rng):
    dets, _, _ = _chip_dets(rng)
    assert merge.parse_chip_name("P0007__1.0__72___96") == jax_merge.parse_chip_name(
        "P0007__1.0__72___96")
    assert merge.parse_chip_name("plain") == jax_merge.parse_chip_name("plain")
    name, (_, _, poly) = "P0007__1.0__72___96", dets["P0007__1.0__72___96"][0]
    np.testing.assert_array_equal(merge.chip_to_image_coords(poly, name),
                                  jax_merge.chip_to_image_coords(poly, name))
    for thr in (0.5, 0.2):
        got = merge.merge_chip_detections(dets, thr)
        want = jax_merge.merge_chip_detections(dets, thr)
        assert got.keys() == want.keys() == {"P0007"}
        assert len(got["P0007"]) == len(want["P0007"])
        assert len(got["P0007"]) < sum(len(d) for d in dets.values())
        for (c1, s1, p1), (c2, s2, p2) in zip(got["P0007"], want["P0007"]):
            assert (c1, s1) == (c2, s2)
            np.testing.assert_array_equal(p1, p2)


@pytest.mark.parametrize("use_07", [True, False])
def test_voc_ap_matches_jax(rng, use_07):
    for n in (0, 1, 7, 50):
        rec = np.sort(rng.uniform(0, 1, n))
        prec = rng.uniform(0, 1, n)
        assert voc_eval.voc_ap(rec, prec, use_07) == jax_voc.voc_ap(rec, prec, use_07)


def _class_case(rng, n_img=4):
    """Detections and GT of one class: matches, duplicates, difficult GT,
    misses and false positives."""
    gt, dets = {}, []
    for i in range(n_img):
        img = f"img{i}"
        boxes = _boxes(rng, 6, 200.0)
        polys = polyiou.rbox_vertices_np(boxes).reshape(-1, 8)
        gt[img] = [(p, bool(rng.uniform() < 0.25)) for p in polys]
        for k, b in enumerate(boxes[:5]):
            jit = polyiou.rbox_vertices_np(b + rng.normal(size=5) * [1, 1, 1, 1, 0.05])
            dets.append((img, float(rng.uniform()), jit.reshape(8)))
            if k < 2:  # a duplicate
                dets.append((img, float(rng.uniform()), jit.reshape(8) + 0.5))
        dets.append((img, float(rng.uniform()),
                     polyiou.rbox_vertices_np(_boxes(rng, 1, 200.0)).reshape(8)))
    dets.append(("unseen", 0.5, dets[0][2]))
    return dets, gt


@pytest.mark.parametrize("task,use_07", [(1, True), (1, False), (2, True)])
def test_voc_eval_class_matches_jax(rng, task, use_07):
    dets, gt = _class_case(rng)
    got = voc_eval.voc_eval_class(dets, gt, 0.5, use_07, task=task)
    want = jax_voc.voc_eval_class(dets, gt, 0.5, use_07, task=task)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert 0 < got["ap"] < 1 and got["npos"] < 24


def test_evaluate_detections_matches_jax(rng):
    names = ("plane", "ship", "harbor")
    dets_by_class, gt_by_class = {}, {}
    for c in range(2):  # the third class has neither detections nor GT
        dets_by_class[c], gt_by_class[c] = _class_case(rng)
    got = voc_eval.evaluate_detections(dets_by_class, gt_by_class, names)
    want = jax_voc.evaluate_detections(dets_by_class, gt_by_class, names)
    for key in ("map50", "mp", "mr"):
        assert got[key] == want[key]
    for name in names:
        for key in ("ap", "precision", "recall", "f1", "conf", "npos"):
            assert got["per_class"][name][key] == want["per_class"][name][key]


# ---------------------------------------------------------------- runner


def _stub_buffers(loader, rng, k=24):
    """Per batch of ``loader``: detection buffers in the letterboxed frame,
    near the batch's gt (some with the wrong class) plus random boxes; the
    padded slots of the last batch hold noise."""
    out = []
    for batch in loader:
        bs = loader.batch_size
        boxes = np.zeros((bs, k, 6), np.float32)
        labels = rng.integers(0, 15, (bs, k))
        valid = rng.uniform(size=(bs, k)) < 0.9
        boxes[:, :, :5] = _boxes(rng, bs * k, SIZE).reshape(bs, k, 5)
        boxes[:, :, 5] = rng.uniform(0.05, 1, (bs, k))
        for i in range(len(batch["paths"])):
            n = int(batch["gt_mask"][i].sum())
            boxes[i, :n, :5] = batch["gt_boxes"][i, :n] + rng.normal(size=(n, 5)) * [
                0.7, 0.7, 0.5, 0.5, 0.02]
            labels[i, :n] = np.where(rng.uniform(size=n) < 0.8,
                                     batch["gt_classes"][i, :n], labels[i, :n])
        out.append((boxes, labels, valid))
    return out


class _Stub:
    def __init__(self, buffers):
        self.buffers, self.calls = buffers, 0

    def __call__(self, *args):
        imgs = args[-1]
        assert imgs.shape[0] == self.buffers[0][0].shape[0]
        self.calls += 1
        return self.buffers[self.calls - 1]


def _scene_set(root, rng):
    """Chips of one scene under ``name__1.0__left___up`` names, and the
    scene's DOTA labelTxt with its objects (difficult flags included)."""
    from s2anet_tpu_torch.data.split import split_image

    scene = rng.integers(0, 80, (300, 200, 3), dtype=np.uint8)
    dets, objs, cls = _chip_dets(rng)
    names = ("plane", "ship", "harbor", "bridge")
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    (root / "gt").mkdir()
    lines = []
    for j, (b, c) in enumerate(zip(objs, cls)):
        poly = polyiou.rbox_vertices_np(b).reshape(8)
        lines.append(" ".join(f"{v:.1f}" for v in poly) + f" {names[c]} {int(j % 7 == 0)}")
    (root / "gt" / "P0007.txt").write_text("imagesource:x\ngsd:0.1\n" + "\n".join(lines))
    for chip_name, chip, _ in split_image(scene, [], "P0007", SIZE, 32):
        png = root / "images" / f"{chip_name}.png"
        cv2.imwrite(str(png), np.ascontiguousarray(chip[:, :, ::-1]))
        np.save(png.with_suffix(".npy"), np.ascontiguousarray(chip[:, :, ::-1]))
        # chip labels of the objects centred in the window: they place the
        # stub's detections
        _, _, left, up = merge.parse_chip_name(chip_name)
        rows = []
        for b, c in zip(objs, cls):
            if left <= b[0] < left + SIZE and up <= b[1] < up + SIZE:
                local = polyiou.rbox_vertices_np(b - [left, up, 0, 0, 0]).reshape(8)
                rows.append(f"{c} " + " ".join(f"{v:.6f}" for v in (local / SIZE).clip(0, 1)))
        (root / "labels" / f"{chip_name}.txt").write_text("\n".join(rows))
    return root, names


@pytest.mark.parametrize("mode,bs", [("chips", 2), ("merge", 4)])
def test_runner_matches_jax(tmp_path, rng, mode, bs):
    if mode == "chips":
        root, names = make_dota_set(tmp_path / "val", rng), jax_config.DOTA10_CLASSES
        gt_dir, use_07 = "", True
    else:
        (root, names), use_07 = _scene_set(tmp_path / "val", rng), False
        gt_dir = str(root / "gt")
    port_ds = DotaDataset(root / "images", img_size=SIZE, max_gt=16)
    jax_ds = JaxDataset(root / "images", img_size=SIZE, max_gt=16, cache_images="disk")
    buffers = _stub_buffers(BatchLoader(port_ds, bs), rng)
    assert len(port_ds) % bs  # a partial last batch

    jcfg = jax_config.load_config(None, {
        "model": {"num_classes": len(names)},
        "data": {"img_size": SIZE, "val_gt_dir": gt_dir, "names": names},
        "eval": {"batch_size": bs, "is_map_split": mode == "chips", "use_07_metric": use_07}})
    pcfg = Config(data=DataConfig(img_size=SIZE, val_gt_dir=gt_dir, names=names),
                  eval=EvalConfig(batch_size=bs, is_map_split=mode == "chips",
                                  use_07_metric=use_07))
    pcfg = dataclasses.replace(pcfg, model=dataclasses.replace(
        pcfg.model, num_classes=len(names)))
    want = jax_runner.evaluate_on_chips(None, None, jcfg, dataset=jax_ds,
                                        eval_step=_Stub(buffers), save_dir=tmp_path / "jax")
    stub = _Stub(buffers)
    got = runner.evaluate_on_chips(stub, pcfg, dataset=port_ds, save_dir=tmp_path / "port")
    assert stub.calls == len(buffers)
    assert got["n_images"] == want["n_images"] == len(port_ds)
    for key in ("map50", "mp", "mr"):
        assert got[key] == want[key], key
    assert 0.05 < got["map50"] < 1
    for name in names:
        for key in ("ap", "precision", "recall", "npos"):
            assert got["per_class"][name][key] == want["per_class"][name][key], (name, key)
    subdirs = ["chip_results"] + ([] if mode == "chips" else ["merged_results"])
    for sub in subdirs:
        files = sorted((tmp_path / "jax" / sub).glob("Task1_*.txt"))
        assert len(files) == len(names)
        for f in files:
            assert (tmp_path / "port" / sub / f.name).read_bytes() == f.read_bytes(), f.name
