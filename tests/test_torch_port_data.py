"""The port's DOTA data path against the JAX package's, on the CPU.

A small DOTA-format set (PNGs written with cv2, their BGR ``.npy``
sidecars, YOLO-rotated labels with an out-of-range row and a degenerate
box) goes through ``s2anet_tpu.data`` and ``s2anet_tpu_torch.data``:
labels, dataset samples and loader batches (targets bit for bit, images
within 1 ulp of the JAX loader's host scaling), the packed shard read and
written across the two packages, the label geometry, the letterbox (exact
where it only pads, within one level where it resizes) and the chip tiling.
"""

import os
import time

import cv2
import numpy as np
import pytest

from s2anet_tpu.data import augment as jax_augment
from s2anet_tpu.data import dota as jax_dota
from s2anet_tpu.data import packed_cache as jax_packed
from s2anet_tpu.data import split as jax_split
from s2anet_tpu.ops import rbox as jax_rbox
from s2anet_tpu_torch.data import augment, dota, image, packed_cache, split
from s2anet_tpu_torch.ops import rbox

SIZE = 128
# (h, w): square at SIZE, and pad-only letterboxes (the long side is SIZE)
SHAPES = [(128, 128), (96, 128), (128, 80), (128, 128), (128, 128)]


def _rect(rng, h, w):
    cx, cy = rng.uniform(0.3, 0.7) * w, rng.uniform(0.3, 0.7) * h
    bw, bh, a = rng.uniform(10, 40), rng.uniform(6, 20), rng.uniform(0, np.pi)
    c, s = np.cos(a) / 2, np.sin(a) / 2
    pts = [(cx + c * bw * sx - s * bh * sy, cy + s * bw * sx + c * bh * sy)
           for sx, sy in ((-1, -1), (1, -1), (1, 1), (-1, 1))]
    return np.array(pts)


def make_dota_set(root, rng, shapes=SHAPES, n_obj=4):
    """``root/images/*.png`` (cv2) with newer BGR ``.npy`` sidecars and
    ``root/labels/*.txt``: per image ``n_obj`` rotated rectangles drawn
    filled, plus an out-of-range row, a degenerate box and a short row."""
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for i, (h, w) in enumerate(shapes):
        img = rng.integers(0, 80, (h, w, 3), dtype=np.uint8)
        lines = []
        for _ in range(n_obj):
            pts = _rect(rng, h, w)
            cls = int(rng.integers(0, 15))
            cv2.fillPoly(img, [pts.round().astype(np.int32)],
                         tuple(int(v) for v in rng.integers(120, 256, 3)))
            norm = (pts / [w, h]).clip(0, 1).reshape(-1)
            lines.append(f"{cls} " + " ".join(f"{v:.6f}" for v in norm))
        lines.append("2 0.5 0.5 1.2 0.5 1.2 0.8 0.5 0.8")   # out of range
        lines.append("4 0.3 0.3 0.3 0.3 0.3 0.3 0.3 0.3")   # degenerate
        lines.append("1 0.1 0.2")                            # malformed
        png = root / "images" / f"chip_{i:02d}.png"
        cv2.imwrite(str(png), img)
        np.save(png.with_suffix(".npy"), img)  # newer than the PNG
        (root / "labels" / f"chip_{i:02d}.txt").write_text("\n".join(lines) + "\n")
    return root


@pytest.fixture
def dota_set(tmp_path, rng):
    return make_dota_set(tmp_path / "val", rng)


def test_load_dota_label_matches_jax(dota_set):
    for p in sorted((dota_set / "labels").glob("*.txt")) + [dota_set / "none.txt"]:
        got, want = dota.load_dota_label(p), jax_dota.load_dota_label(p)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert len(dota.load_dota_label(dota_set / "labels" / "chip_00.txt")) == 5


def _jax_dataset(root, **kw):
    return jax_dota.DotaDataset(root / "images", img_size=SIZE, max_gt=8,
                                cache_images="disk", **kw)


@pytest.mark.parametrize("workers", [1, 3])
def test_loader_batches_match_jax(dota_set, workers):
    port = dota.BatchLoader(dota.DotaDataset(dota_set / "images", img_size=SIZE, max_gt=8),
                            2, num_workers=workers)
    ref = jax_dota.BatchLoader(_jax_dataset(dota_set), 2, shuffle=False,
                               drop_last=False, num_workers=workers)
    got, want = list(port), list(ref)
    assert len(port) == len(ref) == len(got) == len(want) == 3
    assert [len(b["paths"]) for b in got] == [len(b["paths"]) for b in want] == [2, 2, 1]
    for g, w in zip(got, want):
        for key in ("gt_boxes", "gt_classes", "gt_mask"):
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        for key in ("paths", "orig_shapes", "img_shapes"):
            assert g[key] == w[key], key
        assert g["imgs"].dtype == np.uint8 and g["imgs"].shape == w["imgs"].shape
        scaled = g["imgs"].astype(np.float32) / np.float32(255.0)
        np.testing.assert_array_max_ulp(scaled, w["imgs"], maxulp=1)
    assert got[0]["gt_mask"].sum(1).tolist() == [4, 4]


def test_sidecar_rules(dota_set, monkeypatch):
    """A sidecar older than its image is not served: the PNG is decoded
    (cv2's pixels), with PIL and without; without PIL and without a fresh
    sidecar, an image that is neither PNG nor BMP raises, naming the forms
    the port reads."""
    ds = dota.DotaDataset(dota_set / "images", img_size=SIZE)
    png = ds.img_files[0]
    want = cv2.imread(str(png))
    np.save(png.with_suffix(".npy"), np.zeros_like(want))
    t = time.time()
    os.utime(png.with_suffix(".npy"), (t - 100, t - 100))
    np.testing.assert_array_equal(ds.load_image(0), want)
    monkeypatch.setattr(image, "HAVE_PIL", False)
    np.testing.assert_array_equal(ds.load_image(0), want)
    jpg = png.with_name("photo.jpg")
    cv2.imwrite(str(jpg), want)
    ds.img_files[0] = jpg
    with pytest.raises(FileNotFoundError, match="PNG.*BMP.*sidecar.*packed"):
        ds.load_image(0)
    jpg.unlink()


def test_packed_shard_across_packages(dota_set):
    """The port reads a pack the JAX package built (cv2 decode), and the
    JAX package reads one the port built from a NumPy decode."""
    files = sorted((dota_set / "images").glob("*.png"))
    jax_packed.PackedImageCache(files).build()
    port = packed_cache.PackedImageCache(files)
    assert port.valid()
    for i, f in enumerate(files):
        np.testing.assert_array_equal(port.get(i), cv2.imread(str(f)))
    ds = dota.DotaDataset(dota_set / "images", img_size=SIZE, max_gt=8,
                          cache_images="packed")
    ref = dota.DotaDataset(dota_set / "images", img_size=SIZE, max_gt=8)
    for i in range(len(files)):
        a, b = ds.get_sample(i), ref.get_sample(i)
        for key in ("imgs", "gt_boxes", "gt_classes", "gt_mask"):
            np.testing.assert_array_equal(a[key], b[key])

    other = dota_set / "pack2"
    other.mkdir()
    built = packed_cache.PackedImageCache(files, other)
    built.build(lambda p: np.load(p.with_suffix(".npy")))
    reread = jax_packed.PackedImageCache(files, other)
    assert reread.valid()
    for i, f in enumerate(files):
        np.testing.assert_array_equal(reread.get(i), np.load(f.with_suffix(".npy")))
    assert (other / "images.pack.bin").read_bytes() == (
        dota_set / "images" / "images.pack.bin").read_bytes()
    assert not packed_cache.PackedImageCache(files, dota_set / "labels").valid()


def test_poly_to_rbox_np_matches_jax(rng):
    polys = [_rect(rng, 200, 300).reshape(-1) for _ in range(50)]
    polys += [rng.uniform(0, 100, 8) for _ in range(300)]         # any quadrilateral
    polys += [np.round(rng.uniform(0, 4, 8)) for _ in range(300)]  # repeated, collinear
    polys += [np.round(_rect(rng, 200, 300).reshape(-1)) for _ in range(300)]
    polys += [np.array([5, 5, 5, 5, 5, 5, 5, 5.0]),                # a point
              np.array([0, 0, 10, 0, 10, 0, 0, 0.0])]              # a segment
    polys = np.stack(polys)
    np.testing.assert_array_equal(rbox.poly_to_rbox_np(polys), jax_rbox.poly_to_rbox_np(polys))


@pytest.mark.parametrize("shape,new", [((128, 96, 3), (128, 128)), ((60, 128, 3), (128, 128)),
                                       ((128, 128, 3), (128, 128)), ((128, 100, 3), (128, 160))])
def test_letterbox_pad_only_is_exact(rng, shape, new):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    got, want = augment.letterbox(img, new), jax_augment.letterbox(img, new)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.parametrize("shape,new", [((100, 60, 3), (128, 128)), ((200, 300, 3), (128, 128)),
                                       ((64, 64, 3), (128, 160)), ((37, 129, 3), (96, 160))])
def test_letterbox_resize_within_one_level(rng, shape, new):
    """cv2 interpolates uint8 with 11-bit fixed-point weights; the port in
    float32 and rounds: one level apart at most."""
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    got, want = augment.letterbox(img, new, pad_value=0), jax_augment.letterbox(img, new, pad_value=0)
    assert got[0].shape == want[0].shape and got[1:] == want[1:]
    assert np.abs(got[0].astype(int) - want[0].astype(int)).max() <= 1


def test_scale_and_unletterbox_match_jax(rng):
    polys = rng.uniform(0, 100, (10, 8))
    boxes = rng.uniform(0, 100, (10, 5))
    for ratio, pad in ((1.0, (0, 16)), (0.75, (8.5, 3.0))):
        np.testing.assert_array_equal(augment.scale_polys(polys, ratio, pad),
                                      jax_augment.scale_polys(polys, ratio, pad))
        for orig in (None, (90, 70)):
            np.testing.assert_array_equal(
                augment.unletterbox_rboxes(boxes, ratio, pad, orig),
                jax_augment.unletterbox_rboxes(boxes, ratio, pad, orig))


def test_parse_dota_label_matches_jax(tmp_path):
    p = tmp_path / "P0001.txt"
    p.write_text("imagesource:GoogleEarth\ngsd:0.146343590398\n"
                 "10 20 30 20 30 40 10 40 plane 0\n"
                 "1.5 2.5 3.5 2.5 3.5 4.5 1.5 4.5 small-vehicle 1\n"
                 "1 2 3 4 5 6 7 8 ship\n"
                 "a b c d e f g h harbor 0\n"
                 "1e1 2 3 4 5 6 7 8 bridge x\n")
    got, want = split.parse_dota_label(p), jax_split.parse_dota_label(p)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["poly"], w["poly"])
        assert (g["name"], g["difficult"]) == (w["name"], w["difficult"])
    assert split.DOTA_CLASSES == jax_split.DOTA_CLASSES


@pytest.mark.parametrize("h,w,subsize,gap", [(3000, 4000, 1024, 200), (1024, 1024, 1024, 200),
                                             (300, 200, 128, 32), (100, 60, 128, 64),
                                             (1025, 2048, 1024, 512)])
def test_window_origins_match_jax(h, w, subsize, gap):
    got = split.window_origins(h, w, subsize, subsize - gap)
    assert got == jax_split.window_origins(h, w, subsize, subsize - gap)
    if (h, w) == (3000, 4000):
        assert len(got) == 20


@pytest.mark.parametrize("h,w", [(300, 200), (100, 60), (128, 128)])
def test_split_image_matches_jax(rng, h, w):
    """The same chip names at every rate; the chips equal at rate 1 and
    within one level of cv2's bicubic rescale elsewhere."""
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    for rate in (1.0, 0.5, 1.5):
        got = list(split.split_image(img, [], "scene", 128, 32, rate=rate))
        want = list(jax_split.split_image(img, [], "scene", 128, 32, rate=rate))
        assert [n for n, _, _ in got] == [n for n, _, _ in want]
        for (_, a, _), (_, b, _) in zip(got, want):
            diff = np.abs(a.astype(np.int16) - b)
            assert diff.max() <= (0 if rate == 1.0 else 1)
