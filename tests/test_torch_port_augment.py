"""The port's training augmentations against the JAX package's on seeded
inputs: the flips, the 90-degree rotations (k = 0-3, non-square images),
the centre filter and mixup exactly; the HSV jitter bit for bit against
the cv2 version, and the colour conversions under it against cv2 on every
8-bit input (one pixel per row, and rows long enough for cv2's vector
loop); the trainer takes mosaic, the affine warp and process-mode loading
(once refused) into its train loader (their outputs against JAX and cv2:
tests/test_torch_port_mosaic.py)."""

import cv2
import numpy as np
import pytest

from s2anet_tpu.data import augment as J
from s2anet_tpu_torch import config
from s2anet_tpu_torch.data import augment as P
from s2anet_tpu_torch.train.trainer import Trainer


def _polys(rng, n, h, w):
    p = np.empty((n, 8), np.float32)
    p[:, 0::2] = rng.uniform(-10, w + 10, (n, 4))
    p[:, 1::2] = rng.uniform(-10, h + 10, (n, 4))
    return p


@pytest.mark.parametrize("k", range(4))
@pytest.mark.parametrize("hw", [(37, 53), (64, 64), (80, 31)])
def test_rot90_and_flips_equal_jax(k, hw, rng):
    img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    polys = _polys(rng, 7, *hw)
    ji, jp = J.rot90_image_and_polys(img, polys, k)
    pi, pp = P.rot90_image_and_polys(img, polys, k)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pp, jp)
    h, w = pi.shape[:2]
    np.testing.assert_array_equal(P.fliplr_polys(w, pp), J.fliplr_polys(w, jp))
    np.testing.assert_array_equal(P.flipud_polys(h, pp), J.flipud_polys(h, jp))
    np.testing.assert_array_equal(P.filter_polys_center_inside(pp, h, w),
                                  J.filter_polys_center_inside(jp, h, w))


@pytest.mark.parametrize("seed", range(3))
def test_mixup_equals_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = (rng.integers(0, 256, (40, 56, 3), dtype=np.uint8) for _ in range(2))
    pa, pb = _polys(rng, 3, 40, 56), _polys(rng, 2, 40, 56)
    ca, cb = np.array([0, 1, 2], np.int32), np.array([4, 5], np.int32)
    want = J.mixup(a, pa, ca, b, pb, cb, np.random.default_rng(seed))
    got = P.mixup(a, pa, ca, b, pb, cb, np.random.default_rng(seed))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("hw", [(97, 131), (64, 64), (33, 300), (256, 256)])
def test_hsv_augment_equals_cv2_bit_for_bit(seed, hw):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    gains = rng.uniform(0, 1, 3) * [0.1, 0.9, 0.6]
    r1, r2 = np.random.default_rng(seed + 100), np.random.default_rng(seed + 100)
    np.testing.assert_array_equal(P.hsv_augment(img, *gains, rng=r2),
                                  J.hsv_augment(img, *gains, rng=r1))
    assert r1.uniform() == r2.uniform()  # the same draws


def test_color_conversions_equal_cv2_everywhere():
    grid = np.stack(np.meshgrid(np.arange(256), np.arange(256), np.arange(256),
                                indexing="ij"), -1).astype(np.uint8)
    bgr = grid.reshape(-1, 1, 3)
    np.testing.assert_array_equal(P.bgr_to_hsv(bgr), cv2.cvtColor(bgr, cv2.COLOR_BGR2HSV))
    hsv = grid[:180].reshape(-1, 1, 3)  # hue in [0, 180)
    for rows in (hsv, hsv.reshape(-1, 8192, 3)[:, :8185]):  # 255 vector blocks + 25
        rows = np.ascontiguousarray(rows)
        np.testing.assert_array_equal(P.hsv_to_bgr(rows), cv2.cvtColor(rows, cv2.COLOR_HSV2BGR))


@pytest.mark.parametrize("data", [{"mosaic": 0.5}, {"translate": 0.1}, {"scale": 0.5},
                                  {"loader": "process"}])
def test_unported_training_settings_are_refused(data, tmp_path):
    """These settings were refused before they were ported; now the
    trainer builds and its train loader carries them."""
    (tmp_path / "images").mkdir()
    cfg = config.load_config(None, {"data": dict(data, root=str(tmp_path / "images")),
                                    "train": {"save_dir": str(tmp_path / "run")}})
    loader = Trainer(cfg, device="cpu")._train_loader()
    assert (tmp_path / "run" / "config.yaml").exists()
    got = {"mosaic": loader.ds.mosaic, "translate": loader.ds.translate,
           "scale": loader.ds.scale, "loader": loader.mode}
    want = {"mosaic": 0.0, "translate": 0.0, "scale": 0.0, "loader": "thread"}
    assert got == dict(want, **data)
