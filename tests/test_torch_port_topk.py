"""Tied scores: the port's top-k and every place it picks candidates
against the JAX package, where ``lax.top_k`` puts the lower index first
among equal values.

Scores tie in serving: the ODM logits are bf16, so a sigmoid score comes
from a value with 8 significant bits. Inputs here are scores in eighths and
sigmoids of bf16-rounded logits, made with numpy from a seed. NMS runs on
both sides without the JAX small tier (``small_tier=0``); boxes, labels and
validity must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2anet_tpu.models.head import s2anet_get_bboxes as jax_get_bboxes
from s2anet_tpu.ops.nms_rotated import multiclass_nms_rotated as jax_mc_nms
from s2anet_tpu.ops.rbox import rboxes_decode as jax_rboxes_decode
from s2anet_tpu_torch.models.head import decode_levels, s2anet_get_bboxes
from s2anet_tpu_torch.ops import nms_rotated, topk


def _bf16(x):
    """float32 values rounded to bf16 (round to nearest even), as float32."""
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()


def _sigmoid_bf16(rng, shape, scale=2.0, shift=0.0):
    logits = _bf16(rng.normal(shift, scale, shape))
    return torch.sigmoid(torch.from_numpy(logits)).numpy()


def _scores(rng, kind, shape):
    if kind == "eighths":
        return (rng.integers(0, 9, shape) / 8).astype(np.float32)
    if kind == "bf16_sigmoid":
        return _sigmoid_bf16(rng, shape)
    if kind == "minus_one_fill":  # NMS's invalid candidates: many -1
        s = (rng.integers(0, 5, shape) / 4).astype(np.float32)
        return np.where(rng.uniform(size=shape) < 0.6, -1.0, s).astype(np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind,n,k", [
    ("eighths", 300, 100), ("bf16_sigmoid", 2000, 500), ("minus_one_fill", 257, 200),
    ("eighths", 64, 1), ("eighths", 64, 64), ("bf16_sigmoid", 4096, 4096),
    ("bf16_sigmoid", 80160, 4096)])
def test_top_k_matches_lax_top_k(rng, kind, n, k):
    x = _scores(rng, kind, (3, n))
    assert len(np.unique(x[0])) < n  # ties present
    vals, idx = topk.top_k(torch.from_numpy(x), k)
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))


def _boxes(rng, n, n_ctr=12):
    """Boxes crowded around a few centres, so that NMS has work."""
    ctr = rng.uniform(50, 450, (n_ctr, 2))
    pick = rng.integers(0, n_ctr, n)
    return np.concatenate([
        ctr[pick] + rng.normal(0, 4, (n, 2)),
        rng.uniform(20, 60, (n, 1)), rng.uniform(10, 30, (n, 1)),
        rng.uniform(-0.4, 0.4, (n, 1)),
    ], 1).astype(np.float32)


@pytest.mark.parametrize("kind,score_thr,cap,max_per_img", [
    ("eighths", 0.05, 512, 100), ("eighths", 0.3, 128, 300),
    ("bf16_sigmoid", 0.05, 512, 100), ("bf16_sigmoid", 0.6, 4096, 2000)])
def test_multiclass_nms_tied_scores_matches_jax(rng, kind, score_thr, cap, max_per_img):
    b, n, c = 2, 300, 3
    boxes = np.stack([_boxes(rng, n) for _ in range(b)])
    scores = _scores(rng, kind, (b, n, c))
    got = [t.numpy() for t in nms_rotated.multiclass_nms_rotated(
        torch.from_numpy(boxes), torch.from_numpy(scores), score_thr, 0.5,
        max_per_img=max_per_img, pre_nms_cap=cap)]
    for i in range(b):
        want = [np.asarray(t) for t in jax_mc_nms(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), score_thr, 0.5,
            max_per_img=max_per_img, pre_nms_cap=cap, small_tier=0)]
        np.testing.assert_array_equal(got[2][i], want[2])
        v = want[2]
        assert 0 < v.sum() < min(cap, n * c)  # NMS had real work
        np.testing.assert_array_equal(got[1][i], want[1])
        np.testing.assert_array_equal(got[0][i], want[0])


def _head_outputs(rng, kind):
    """ODM outputs of three levels (32^2, 16^2, 8^2 cells, 3 classes) whose
    best-class scores tie: logits rounded to bf16 or to halves."""
    b, nc = 2, 3
    out = {"odm_cls": [], "odm_bbox": [], "refine_anchors": []}
    for hw in (32, 16, 8):
        n = hw * hw
        if kind == "halves":
            logits = (rng.integers(-8, 4, (b, hw, hw, nc)) / 2).astype(np.float32)
        else:
            logits = _bf16(rng.normal(-2.0, 0.5, (b, hw, hw, nc)))
        anchors = np.concatenate([
            rng.uniform(0, 256, (b, n, 2)), rng.uniform(8, 40, (b, n, 2)),
            rng.uniform(-0.5, 0.5, (b, n, 1))], -1).astype(np.float32)
        out["odm_cls"].append(logits)
        out["odm_bbox"].append((rng.normal(0, 0.1, (b, hw, hw, 5))).astype(np.float32))
        out["refine_anchors"].append(anchors)
    return out


def _jax_decode(out, max_before):
    """The JAX head's decode (s2anet_tpu/models/head.py, s2anet_get_bboxes)
    up to the NMS: sigmoid, the per-level lax.top_k prefilter on the best
    class, decode."""
    b, nc = out["odm_cls"][0].shape[0], out["odm_cls"][0].shape[-1]
    scores_cat, deltas_cat, anchors_cat = [], [], []
    for cls, bbox, anc in zip(out["odm_cls"], out["odm_bbox"], out["refine_anchors"]):
        scores = jax.nn.sigmoid(jnp.asarray(cls).reshape(b, -1, nc))
        bbox = jnp.asarray(bbox).reshape(b, -1, 5)
        anc = jnp.asarray(anc)
        if 0 < max_before < scores.shape[1]:
            _, idx = jax.lax.top_k(scores.max(axis=-1), max_before)
            scores = jnp.take_along_axis(scores, idx[..., None], axis=1)
            bbox = jnp.take_along_axis(bbox, idx[..., None], axis=1)
            anc = jnp.take_along_axis(anc, idx[..., None], axis=1)
        scores_cat.append(scores)
        deltas_cat.append(bbox)
        anchors_cat.append(anc)
    boxes = jax_rboxes_decode(jnp.concatenate(anchors_cat, 1), jnp.concatenate(deltas_cat, 1))
    return np.asarray(boxes), np.asarray(jnp.concatenate(scores_cat, 1))


def _to_torch(out):
    return {k: [torch.from_numpy(v) for v in vs] for k, vs in out.items()}


@pytest.mark.parametrize("kind", ["halves", "bf16"])
def test_decode_prefilter_tied_scores_matches_jax(rng, kind):
    out = _head_outputs(rng, kind)
    best = 1 / (1 + np.exp(-out["odm_cls"][0].reshape(2, -1, 3).max(-1)))
    assert len(np.unique(best[0])) < 300  # the prefilter cuts through ties
    boxes, scores = decode_levels(_to_torch(out), 100)
    want_boxes, want_scores = _jax_decode(out, 100)
    assert boxes.shape == (2, 100 + 100 + 64, 5)
    # torch's and XLA's float32 sigmoids differ by an ulp on some logits;
    # a box picked from another anchor would differ by pixels
    np.testing.assert_allclose(scores.numpy(), want_scores, rtol=2e-7, atol=0)
    np.testing.assert_allclose(boxes.numpy(), want_boxes, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kind", ["halves", "bf16"])
def test_get_bboxes_tied_scores_matches_jax(rng, kind):
    out = _head_outputs(rng, kind)
    kw = dict(score_thr=0.05, iou_thr=0.5, max_before_nms_per_level=100,
              max_per_img=100, pre_nms_cap=512)
    got = [t.numpy() for t in s2anet_get_bboxes(_to_torch(out), **kw)]
    want = [np.asarray(t) for t in jax_get_bboxes(
        jax.tree_util.tree_map(jnp.asarray, out), **kw)]
    np.testing.assert_array_equal(got[2], want[2])
    assert 0 < want[2].sum()
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-4)
