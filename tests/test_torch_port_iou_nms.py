"""The port's rotated IoU and multiclass NMS (plain versions) against the
JAX package: ``iou_pairs`` (XLA) and ``box_iou_rotated_pallas`` in
interpret mode at 1e-6, the float64 polygon oracle at 5e-4, and
``multiclass_nms_rotated`` with the same keeps on distinct scores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2anet_tpu.ops.iou_rotated import box_iou_rotated as jax_box_iou
from s2anet_tpu.ops.nms_rotated import multiclass_nms_rotated as jax_mc_nms
from s2anet_tpu.ops.pallas.iou_kernel import box_iou_rotated_pallas
from s2anet_tpu.ops.polyiou_ref import box_iou_rotated_np
from s2anet_tpu_torch.ops import iou_rotated, nms_rotated


def _rand(rng, n, span=300.0):
    return np.stack([
        rng.uniform(0, span, n), rng.uniform(0, span, n),
        rng.uniform(4, 80, n), rng.uniform(4, 40, n),
        rng.uniform(-np.pi / 4, 3 * np.pi / 4, n),
    ], axis=1).astype(np.float32)


def _degenerate():
    """Identical, grid-touching, stacked-touching, shared-edge, contained
    and zero-size boxes (tests/test_pallas_iou.py)."""
    s = 8.0
    grid = np.array([[x * s, y * s, 4 * s, 4 * s, 0.0]
                     for x in range(4) for y in range(4)], np.float32)
    stacked = np.array([[100.0, 100.0, 80.0, 40.0, 0.0],
                        [100.0, 130.0, 60.0, 20.0, 0.0]], np.float32)
    shared = np.array([[50.0, 50.0, 100.0, 40.0, 0.0],
                       [80.0, 50.0, 60.0, 40.0, 0.0]], np.float32)
    contained = np.array([[10.0, 10.0, 50.0, 30.0, 0.3],
                          [10.0, 10.0, 20.0, 10.0, 0.3]], np.float32)
    return np.concatenate([grid, stacked, shared, contained,
                           np.zeros((3, 5), np.float32)])


def _port_iou(b1, b2):
    return iou_rotated.box_iou_rotated(torch.from_numpy(b1),
                                       torch.from_numpy(b2)).numpy()


@pytest.mark.parametrize("n,m,span", [(70, 50, 300.0), (40, 90, 80.0)])
def test_iou_matches_jax_random(rng, n, m, span):
    b1, b2 = _rand(rng, n, span), _rand(rng, m, span)
    got = _port_iou(b1, b2)
    xla = np.asarray(jax_box_iou(jnp.asarray(b1), jnp.asarray(b2)))
    pallas = np.asarray(box_iou_rotated_pallas(jnp.asarray(b1), jnp.asarray(b2),
                                               interpret=True))
    np.testing.assert_allclose(got, xla, atol=1e-6)
    np.testing.assert_allclose(got, pallas, atol=1e-6)


def test_iou_degenerate_geometries():
    boxes = _degenerate()
    got = _port_iou(boxes, boxes)
    xla = np.asarray(jax_box_iou(jnp.asarray(boxes), jnp.asarray(boxes)))
    pallas = np.asarray(box_iou_rotated_pallas(
        jnp.asarray(boxes), jnp.asarray(boxes), interpret=True))
    np.testing.assert_allclose(got, xla, atol=1e-6)
    np.testing.assert_allclose(got, pallas, atol=1e-6)
    real = len(boxes) - 3
    np.testing.assert_allclose(np.diag(got)[:real], 1.0, atol=1e-6)
    assert (got[:, real:] == 0.0).all()


def test_iou_matches_float64_oracle(rng):
    b1, b2 = _rand(rng, 40), _rand(rng, 30)
    got = _port_iou(b1, b2)
    want = box_iou_rotated_np(b1.astype(np.float64), b2.astype(np.float64))
    np.testing.assert_allclose(got, want, atol=5e-4)


def _clustered(rng, n, n_ctr=12, classes=3):
    ctr = rng.uniform(50, 450, (n_ctr, 2))
    pick = rng.integers(0, n_ctr, n)
    boxes = np.concatenate([
        ctr[pick] + rng.normal(0, 4, (n, 2)),
        rng.uniform(20, 60, (n, 1)), rng.uniform(10, 30, (n, 1)),
        rng.uniform(-0.4, 0.4, (n, 1)),
    ], 1).astype(np.float32)
    scores = rng.uniform(0, 1, (n, classes)).astype(np.float32)
    return boxes, scores


@pytest.mark.parametrize("score_thr,cap,max_per_img", [
    (0.05, 4096, 2000), (0.3, 128, 100), (0.9, 64, 500)])
def test_multiclass_nms_matches_jax(rng, score_thr, cap, max_per_img):
    b, n = 2, 300
    data = [_clustered(rng, n) for _ in range(b)]
    boxes = np.stack([d[0] for d in data])
    scores = np.stack([d[1] for d in data])
    got = nms_rotated.multiclass_nms_rotated(
        torch.from_numpy(boxes), torch.from_numpy(scores), score_thr, 0.5,
        max_per_img=max_per_img, pre_nms_cap=cap)
    got = [t.numpy() for t in got]
    assert got[0].shape == (b, max_per_img, 6)
    for i in range(b):
        want = [np.asarray(t) for t in jax_mc_nms(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), score_thr, 0.5,
            max_per_img=max_per_img, pre_nms_cap=cap)]
        np.testing.assert_array_equal(got[2][i], want[2])
        v = want[2]
        assert 0 < v.sum() < min(cap, n * 3)  # NMS had real work
        np.testing.assert_array_equal(got[1][i][v], want[1][v])
        np.testing.assert_allclose(got[0][i][v], want[0][v], atol=1e-5)


def test_nms_keep_invalid_never_suppress(rng):
    """An invalid candidate on top of a valid one suppresses nothing; equal
    boxes of other labels never suppress each other."""
    box = np.array([100.0, 100.0, 40.0, 20.0, 0.1], np.float32)
    boxes = torch.from_numpy(np.stack([box] * 4)[None])
    labels = torch.tensor([[0, 0, 1, 0]])
    valid = torch.tensor([[False, True, True, True]])
    keep = nms_rotated.nms_keep(boxes, labels, valid, 0.5)
    assert keep.tolist() == [[False, True, True, False]]


@pytest.mark.parametrize("shared", [True, False])
def test_batched_iou_matches_pallas_per_image(rng, shared):
    """``[N, 5] or [B, N, 5] x [B, M, 5] -> [B, N, M]`` in one call equals
    the TPU kernel (interpret mode) image by image; padded gt slots (zero
    boxes) give 0."""
    b, n, m = 3, 70, 19
    b1 = _rand(rng, n, 120.0) if shared else np.stack([_rand(rng, n, 120.0) for _ in range(b)])
    b2 = np.stack([_rand(rng, m, 120.0) for _ in range(b)])
    b2[1, 12:] = 0.0
    got = iou_rotated.box_iou_rotated(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
    assert got.shape == (b, n, m)
    for i in range(b):
        rows = b1 if shared else b1[i]
        want = np.asarray(box_iou_rotated_pallas(jnp.asarray(rows), jnp.asarray(b2[i]),
                                                 interpret=True))
        np.testing.assert_allclose(got[i], want, atol=1e-6)
        # the batched call equals the unbatched one exactly
        np.testing.assert_array_equal(got[i], _port_iou(rows, b2[i]))
    assert (got[1, :, 12:] == 0).all() and (got > 0).sum() > 50
