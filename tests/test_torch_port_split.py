"""DOTA preparation and the single-class NMS entry points against the JAX
package and the repository's tools, on the CPU at small sizes.

* ``data/split.py``: ``split_image`` with objects and ``split_dataset`` on
  synthetic labelled scenes (a PNG and a BMP) at rates 1.0, 0.5 and 1.5
  give the JAX splitter's chip names, chip pixels equal at rate 1 and
  within one level elsewhere (cv2's bicubic), and byte-equal label files,
  with polygons cut by window edges, 5-vertex clips and zero-area
  polygons among them.
* ``tools/convert_dota_to_yolo``, ``convert_hrsc_to_yolo`` and
  ``prepare_dota`` (``python -m``, with a process pool) write the label and
  list files the repository's ``tools/`` scripts write, paths compared
  relative to the output root.
* ``ops/nms_rotated.py::nms_rotated`` / ``ml_nms_rotated`` give the JAX
  keep masks on clustered boxes with tied scores, with ``valid`` given,
  absent and all false.
"""

import importlib
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2anet_tpu.data import split as jax_split
from s2anet_tpu_torch.data import split
from s2anet_tpu_torch.ops import nms_rotated
from s2anet_tpu_torch.ops.polyiou import rbox_vertices_np
from s2anet_tpu_torch.tools import convert_dota_to_yolo, convert_hrsc_to_yolo

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import convert_dota_to_yolo as jax_convert  # noqa: E402
import convert_hrsc_to_yolo as jax_hrsc_tool  # noqa: E402
import prepare_dota as jax_prepare  # noqa: E402

# the module: the package's ``nms_rotated`` attribute is the function
jax_nms = importlib.import_module("s2anet_tpu.ops.nms_rotated")

SUB, GAP = 128, 32
RATES = (1.0, 0.5, 1.5)
NAMES = ("plane", "ship", "harbor", "small-vehicle")


def _scene(rng, h, w, n=14):
    """A BGR scene and its DOTA labelTxt lines: rotated rectangles (some
    across window edges and corners), a zero-area polygon, a difficult
    object and an unknown class."""
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    lines = ["imagesource:synthetic", "gsd:0.5"]
    for k in range(n):
        box = np.array([[rng.uniform(10, w - 10), rng.uniform(10, h - 10),
                         rng.uniform(12, 60), rng.uniform(8, 30), rng.uniform(-1.5, 1.5)]])
        poly = rbox_vertices_np(box)[0].reshape(8)
        name = NAMES[k % len(NAMES)] if k != 3 else "container-crane"
        lines.append(" ".join(f"{v:.1f}" for v in poly) + f" {name} {int(k % 5 == 0)}")
    lines.append("50 50 50 50 50 50 50 50 plane 0")  # zero area
    return img, lines


@pytest.fixture(scope="module")
def dota_tree(tmp_path_factory):
    """``src/{train,val}/{images,labelTxt}``: a PNG and a BMP scene in each."""
    root = tmp_path_factory.mktemp("dota")
    rng = np.random.default_rng(0)
    for s, shapes in (("train", ((300, 260), (150, 200))), ("val", ((260, 330),))):
        (root / "src" / s / "images").mkdir(parents=True)
        (root / "src" / s / "labelTxt").mkdir()
        for i, (h, w) in enumerate(shapes):
            img, lines = _scene(rng, h, w)
            ext = ".bmp" if i == 1 else ".png"
            cv2.imwrite(str(root / "src" / s / "images" / f"P{i:04d}{ext}"), img)
            (root / "src" / s / "labelTxt" / f"P{i:04d}.txt").write_text("\n".join(lines))
    return root


def _lines(objs):
    return [" ".join(f"{v}" for v in o["poly"]) + f" {o['name']} {o['difficult']}"
            for o in objs]


def test_split_image_with_objects_matches_jax(dota_tree):
    img = cv2.imread(str(dota_tree / "src" / "train" / "images" / "P0000.png"))
    objects = split.parse_dota_label(dota_tree / "src" / "train" / "labelTxt" / "P0000.txt")
    calls = {"repair": 0, "cut": 0}
    real = split._repair_poly5

    def repair(poly):
        calls["repair"] += 1
        return real(poly)

    with mock.patch.object(split, "_repair_poly5", repair):
        for rate in RATES:
            got = list(split.split_image(img, objects, "P0000", SUB, GAP, rate))
            want = list(jax_split.split_image(img, objects, "P0000", SUB, GAP, rate))
            assert [g[0] for g in got] == [w[0] for w in want]
            for (_, a, oa), (_, b, ob) in zip(got, want):
                diff = np.abs(a.astype(np.int16) - b)
                assert diff.max() <= (0 if rate == 1.0 else 1)
                assert _lines(oa) == _lines(ob)
                # clipped polygons are clamped to [1, SUB]
                calls["cut"] += sum(bool(np.isin(o["poly"], (1.0, SUB)).any()) for o in oa)
    assert calls["repair"] > 0 and calls["cut"] > 0


def test_split_dataset_matches_jax(dota_tree, tmp_path):
    for s in ("train", "val"):
        src = dota_tree / "src" / s
        n = split.split_dataset(src / "images", src / "labelTxt", tmp_path / "port" / s,
                                SUB, GAP, RATES, num_workers=1)
        m = jax_split.split_dataset(src / "images", src / "labelTxt", tmp_path / "jax" / s,
                                    SUB, GAP, RATES, num_workers=1)
        assert n == m > 0
        chips = sorted(p.name for p in (tmp_path / "jax" / s / "images").iterdir())
        assert sorted(p.name for p in (tmp_path / "port" / s / "images").iterdir()) == chips
        for c in chips:
            a = cv2.imread(str(tmp_path / "port" / s / "images" / c))
            b = cv2.imread(str(tmp_path / "jax" / s / "images" / c))
            assert np.abs(a.astype(np.int16) - b).max() <= (0 if "__1.0__" in c else 1), c
            lbl = Path(c).stem + ".txt"
            assert ((tmp_path / "port" / s / "labelTxt" / lbl).read_text()
                    == (tmp_path / "jax" / s / "labelTxt" / lbl).read_text()), lbl
    with pytest.raises(ValueError, match="PNG"):
        split.split_dataset(src / "images", None, tmp_path / "jpg", ext=".jpg")


def test_convert_dota_to_yolo_matches_jax(dota_tree, tmp_path):
    src = dota_tree / "src" / "train"
    split.split_dataset(src / "images", src / "labelTxt", tmp_path / "chips", SUB, GAP,
                        (1.0,), num_workers=1)
    (tmp_path / "chips" / "images" / "notes.png").write_text("not an image")
    for keep in (False, True):
        out = {}
        for name, fn in (("port", convert_dota_to_yolo.convert), ("jax", jax_convert.convert)):
            out[name] = fn(tmp_path / "chips" / "images", tmp_path / "chips" / "labelTxt",
                           tmp_path / f"{name}{keep}", max_difficult=0, keep_empty=keep)
        assert out["port"] == out["jax"] and out["port"][1] > 0
        files = sorted(p.name for p in (tmp_path / f"jax{keep}").iterdir())
        assert sorted(p.name for p in (tmp_path / f"port{keep}").iterdir()) == files
        for f in files:
            assert ((tmp_path / f"port{keep}" / f).read_text()
                    == (tmp_path / f"jax{keep}" / f).read_text())


def test_prepare_dota_cli_matches_jax(dota_tree, tmp_path):
    jax_prepare.prepare(dota_tree / "src", tmp_path / "jax", SUB, GAP, (0.5, 1.0), workers=1)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "s2anet_tpu_torch.tools.prepare_dota", "--src",
         str(dota_tree / "src"), "--out", str(tmp_path / "port"), "--subsize", str(SUB),
         "--gap", str(GAP), "--rates", "0.5", "1.0", "--workers", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for s in ("train", "val"):
        for sub in ("labels", "labelTxt"):
            d = f"{s}_split/{sub}"
            files = sorted(p.name for p in (tmp_path / "jax" / d).iterdir())
            assert files and sorted(p.name for p in (tmp_path / "port" / d).iterdir()) == files
            for f in files:
                assert (tmp_path / "port" / d / f).read_text() == (
                    tmp_path / "jax" / d / f).read_text(), f"{d}/{f}"
        rel = {}
        for name in ("port", "jax"):
            lines = (tmp_path / name / f"{s}_split.txt").read_text().splitlines()
            rel[name] = [str(Path(x).relative_to(tmp_path / name)) for x in lines]
        assert rel["port"] == rel["jax"] and rel["port"]
        assert f"{s}: " in proc.stdout


def _hrsc_tree(root, rng):
    """AllImages (BMP), Annotations (one without the size fields, one
    object past the frame, difficult ones), ImageSets."""
    import xml.etree.ElementTree as ET

    (root / "AllImages").mkdir(parents=True)
    (root / "Annotations").mkdir()
    (root / "ImageSets").mkdir()
    ids = [f"1000{i:02d}" for i in range(4)]
    for k, i in enumerate(ids):
        h, w = int(rng.integers(60, 90)), int(rng.integers(80, 120))
        cv2.imwrite(str(root / "AllImages" / f"{i}.bmp"),
                    rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        img = ET.Element("HRSC_Image")
        if k != 1:
            ET.SubElement(img, "Img_SizeWidth").text = str(w)
            ET.SubElement(img, "Img_SizeHeight").text = str(h)
        objs = ET.SubElement(img, "HRSC_Objects")
        for j in range(3):
            o = ET.SubElement(objs, "HRSC_Object")
            cx = w + 30 if j == 2 and k == 0 else rng.uniform(20, w - 20)
            for tag, v in (("mbox_cx", cx), ("mbox_cy", rng.uniform(20, h - 20)),
                           ("mbox_w", rng.uniform(10, 30)), ("mbox_h", rng.uniform(5, 10)),
                           ("mbox_ang", rng.uniform(-1.5, 1.5)), ("difficult", int(j == 1))):
                ET.SubElement(o, tag).text = str(v)
        ET.ElementTree(img).write(root / "Annotations" / f"{i}.xml")
    (root / "ImageSets" / "trainval.txt").write_text("\n".join(ids[:3]) + "\n")
    (root / "ImageSets" / "test.txt").write_text(ids[3] + "\nmissing\n")


@pytest.mark.parametrize("flags", [[], ["--keep-difficult", "--copy-images"]])
def test_convert_hrsc_to_yolo_matches_jax(tmp_path, flags):
    _hrsc_tree(tmp_path / "hrsc", np.random.default_rng(1))
    convert_hrsc_to_yolo.main(["--hrsc-root", str(tmp_path / "hrsc"),
                               "--out", str(tmp_path / "port"), *flags])
    with mock.patch.object(sys, "argv", ["convert_hrsc_to_yolo.py", "--hrsc-root",
                                         str(tmp_path / "hrsc"), "--out",
                                         str(tmp_path / "jax"), *flags]):
        jax_hrsc_tool.main()
    for name in ("train.txt", "val.txt"):
        rel = {k: [str(Path(x).relative_to(tmp_path / k)) for x in
                   (tmp_path / k / name).read_text().splitlines()] for k in ("port", "jax")}
        assert rel["port"] == rel["jax"] and rel["port"]
    files = sorted(p.name for p in (tmp_path / "jax" / "labels").iterdir())
    assert len(files) == 4
    for f in files:
        assert (tmp_path / "port" / "labels" / f).read_text() == (
            tmp_path / "jax" / "labels" / f).read_text()
    images = sorted(p.name for p in (tmp_path / "jax" / "images").iterdir())
    assert sorted(p.name for p in (tmp_path / "port" / "images").iterdir()) == images
    assert (tmp_path / "port" / "images" / images[0]).is_symlink() == (not flags)


def _candidates(rng, k=64):
    centres = rng.uniform(0, 80, (6, 2))
    boxes = np.column_stack([centres[rng.integers(0, 6, k)] + rng.normal(0, 3, (k, 2)),
                             rng.uniform(10, 30, (k, 2)), rng.uniform(-0.7, 2.3, k)])
    scores = np.round(rng.uniform(0, 1, k), 1)  # many ties
    return boxes.astype(np.float32), scores.astype(np.float32), rng.integers(0, 3, k)


@pytest.mark.parametrize("seed", [0, 1])
def test_single_class_nms_matches_jax(seed):
    rng = np.random.default_rng(seed)
    boxes, scores, labels = _candidates(rng)
    some = rng.uniform(size=len(scores)) < 0.7
    kept = []
    for valid in (None, some, np.zeros_like(some)):
        jv = None if valid is None else jnp.asarray(valid)
        tv = None if valid is None else torch.from_numpy(valid)
        tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
        want = np.asarray(jax_nms.nms_rotated(jnp.asarray(boxes), jnp.asarray(scores), 0.3, jv))
        got = nms_rotated.nms_rotated(tb, ts, 0.3, tv)
        assert got.dtype == torch.bool and got.shape == (len(scores),)
        np.testing.assert_array_equal(got.numpy(), want)
        want = np.asarray(jax_nms.ml_nms_rotated(jnp.asarray(boxes), jnp.asarray(scores),
                                                 jnp.asarray(labels), 0.3, jv))
        got = nms_rotated.ml_nms_rotated(tb, ts, torch.from_numpy(labels), 0.3, tv)
        np.testing.assert_array_equal(got.numpy(), want)
        kept.append(int(got.sum()))
    assert kept[0] > 0 and kept[1] > 0 and kept[2] == 0
    empty = nms_rotated.nms_rotated(torch.zeros(0, 5), torch.zeros(0))
    assert empty.shape == (0,)
