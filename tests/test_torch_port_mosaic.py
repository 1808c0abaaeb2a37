"""Mosaic, the scale / translate warp and the process loader of the port
against the JAX package and cv2, on the CPU.

* ``warp_affine`` against ``cv2.warpAffine`` (INTER_LINEAR, border 114) on
  random images, sizes, scales and shifts: within one grey level (the
  bound the port holds; on this cv2 it has been equal).
* ``random_perspective_rotation``, ``mosaic4`` and ``mosaic_center_crop``
  against the JAX functions on the same inputs and generator states:
  polygons and classes exactly, the generator left in the same state,
  images within one grey level (mosaic's exactly: it only copies).
* Two epochs of the training loader with mosaic, mixup, translate, scale,
  the HSV jitter, rotations and flips against the JAX loader: boxes,
  classes, masks and paths exactly, images within one grey level.
* The process loader against the thread loader: the same batches, bit for
  bit; without ``fork`` it raises.
"""

import multiprocessing as mp

import cv2
import numpy as np
import pytest

from s2anet_tpu.data import augment as J
from s2anet_tpu.data import dota as jax_dota
from s2anet_tpu_torch.data import augment as P
from s2anet_tpu_torch.data import dota

from test_torch_port_data import make_dota_set

SIZE = 64
SHAPES = [(64, 64)] * 5 + [(40, 64)] + [(64, 64)] * 3 + [(64, 48)]
AUG = dict(augment=True, fliplr=0.5, flipud=0.5, rot90=True, hsv=(0.015, 0.7, 0.4),
           mixup=0.3, mosaic=0.5, translate=0.1, scale=0.5)


def _polys(rng, n, h, w):
    p = np.empty((n, 8), np.float64)
    p[:, 0::2] = rng.uniform(0, w, (n, 4))
    p[:, 1::2] = rng.uniform(0, h, (n, 4))
    return p


def _within_one_level(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


@pytest.mark.parametrize("seed", range(8))
def test_warp_affine_within_one_level_of_cv2(seed):
    rng = np.random.default_rng(seed)
    for _ in range(6):
        h, w = (int(v) for v in rng.integers(1, 300, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if seed % 2:
            img = cv2.GaussianBlur(img, (5, 5), 1.5)
        s = 1 + rng.uniform(-0.5, 0.5)
        tx, ty = rng.uniform(-0.2, 0.2) * w, rng.uniform(-0.2, 0.2) * h
        m = np.array([[s, 0, tx + (1 - s) * w / 2], [0, s, ty + (1 - s) * h / 2]])
        _within_one_level(P.warp_affine(img, m), cv2.warpAffine(
            img, m, (w, h), borderValue=(114, 114, 114)))


def test_warp_affine_refuses_rotation():
    with pytest.raises(ValueError, match="axis-aligned"):
        P.warp_affine(np.zeros((4, 4, 3), np.uint8), np.array([[1, 0.1, 0], [0, 1, 0]]))


@pytest.mark.parametrize("translate,scale,degrees", [(0.1, 0.0, 0.0), (0.0, 0.5, 0.0),
                                                     (0.2, 0.5, 0.0), (0.1, 0.5, 180.0),
                                                     (0.0, 0.0, 0.0)])
@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
def test_random_perspective_rotation_equals_jax(translate, scale, degrees, hw):
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    polys = _polys(rng, 5, *hw)
    for seed in range(4):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        got_img, got_polys = P.random_perspective_rotation(img, polys, degrees, translate,
                                                           scale, rng=r1)
        want_img, want_polys = J.random_perspective_rotation(img, polys, degrees,
                                                             translate, scale, rng=r2)
        np.testing.assert_array_equal(got_polys, want_polys)
        _within_one_level(np.ascontiguousarray(got_img), np.ascontiguousarray(want_img))
        assert r1.uniform() == r2.uniform()  # the same draws


@pytest.mark.parametrize("seed", range(4))
def test_mosaic_and_centre_crop_equal_jax(seed):
    rng = np.random.default_rng(seed + 20)
    shapes = [(64, 64), (40, 64), (64, 48), (64, 64)]
    samples = []
    for i, (h, w) in enumerate(shapes):
        n = 0 if i == 2 else 4  # one image without boxes
        samples.append((rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                        _polys(rng, n, h, w), rng.integers(0, 15, n).astype(np.int32)))
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    got = P.mosaic4(samples, SIZE, 114, r1)
    want = J.mosaic4(samples, SIZE, 114, r2)
    assert r1.uniform() == r2.uniform()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(P.mosaic_center_crop(*got, SIZE), J.mosaic_center_crop(*want, SIZE)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def train_set(tmp_path_factory):
    return make_dota_set(tmp_path_factory.mktemp("mosaic"), np.random.default_rng(9),
                         shapes=SHAPES, n_obj=3)


def _port_loader(root, **kw):
    ds = dota.DotaDataset(root / "images", img_size=SIZE, max_gt=16, **AUG)
    return dota.BatchLoader(ds, 2, shuffle=True, seed=3, drop_last=True, **kw)


def _epochs(loader, n=2):
    out = []
    for epoch in range(n):
        loader.set_epoch(epoch)
        out += list(loader)
    return out


def test_mosaic_warp_epochs_equal_jax(train_set):
    port = _port_loader(train_set, num_workers=2)
    ref = jax_dota.BatchLoader(
        jax_dota.DotaDataset(train_set / "images", img_size=SIZE, max_gt=16,
                             cache_images="disk", **AUG),
        2, shuffle=True, seed=3, drop_last=True, num_workers=2)
    got, want = _epochs(port), _epochs(ref)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        for key in ("gt_boxes", "gt_classes", "gt_mask"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        for key in ("paths", "orig_shapes", "img_shapes"):
            assert g[key] == w[key], key
        # the JAX loader's float32 RGB back to grey levels (exact: k/255)
        levels = np.rint(w["imgs"] * 255.0).astype(np.uint8)
        _within_one_level(g["imgs"], levels)
    assert sum(int(g["gt_mask"].sum()) for g in got) > 0


def test_process_loader_equals_thread_loader(train_set):
    thread = _epochs(_port_loader(train_set, num_workers=2))
    proc_loader = _port_loader(train_set, num_workers=3, mode="process")
    process = _epochs(proc_loader)
    assert len(process) == len(thread) == 10
    for p, t in zip(process, thread):
        assert p.keys() == t.keys()
        for key in ("imgs", "gt_boxes", "gt_classes", "gt_mask"):
            assert p[key].dtype == t[key].dtype
            np.testing.assert_array_equal(p[key], t[key], err_msg=key)
        for key in ("paths", "orig_shapes", "img_shapes"):
            assert p[key] == t[key], key
    # an epoch cut short leaves no worker behind
    proc_loader.set_epoch(0)
    next(iter(proc_loader))
    assert not mp.active_children()


def test_process_loader_fills_staging_slots(train_set):
    """With a staging provider the process loader hands each batch in the
    slot the provider gives for its index, as the thread loader does."""
    slots = {}

    class Staging:
        def slot(self, i, shape):
            slots[i] = np.zeros((2,) + tuple(shape) + (3,), np.uint8)
            return slots[i]

    loader = _port_loader(train_set, num_workers=2, mode="process", staging=Staging())
    batches = list(loader)
    assert len(batches) == 5 and sorted(slots) == list(range(5))
    for i, b in enumerate(batches):
        assert np.shares_memory(b["imgs"], slots[i]) and b["imgs"].any()


def test_process_loader_raises_without_fork(train_set, monkeypatch):
    monkeypatch.setattr(dota.mp, "get_all_start_methods", lambda: ["spawn"])
    with pytest.raises(RuntimeError, match="no fork"):
        _port_loader(train_set, mode="process")
    with pytest.raises(ValueError, match="loader mode"):
        _port_loader(train_set, mode="threads")


def test_process_worker_error_is_raised(train_set, monkeypatch):
    """A worker that raises exits; the loader raises and leaves no worker."""
    loader = _port_loader(train_set, num_workers=2, mode="process")

    def broken(*a, **k):
        raise OSError("unreadable image")

    monkeypatch.setattr(loader.ds, "load_image", broken)
    with pytest.raises(RuntimeError, match="loader worker process died"):
        list(loader)
    assert not mp.active_children()
