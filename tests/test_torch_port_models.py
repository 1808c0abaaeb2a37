"""The port's head and whole serving slice against the JAX package, on the
same weights converted across (``models/convert.py``), in float32.

* ``S2ANetHead`` at ``feat_channels=32``: every output at 1e-4.
* ``S2ANet("resnet18")`` at 128x128, batch 2, BatchNorm folded on both
  sides: head outputs at 2e-3, and after ``s2anet_get_bboxes`` at a lowered
  score threshold at least 95% of detections match 1:1.
* The weight round trip through ``convert_reference_s2anet``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2anet_tpu.models.detector import S2ANet as JaxS2ANet
from s2anet_tpu.models.fold import fold_bn_for_eval
from s2anet_tpu.models.head import S2ANetHead as JaxHead
from s2anet_tpu.models.head import s2anet_get_bboxes as jax_get_bboxes
from s2anet_tpu.models.torch_import import convert_reference_s2anet
from s2anet_tpu.ops.rbox import norm_angle as jax_norm_angle
from s2anet_tpu_torch.models.convert import (head_state_dict_from_jax,
                                             load_jax_npz, save_jax_npz,
                                             state_dict_from_jax)
from s2anet_tpu_torch.models.detector import S2ANet
from s2anet_tpu_torch.models.fold import fold_bn
from s2anet_tpu_torch.models.head import S2ANetHead, s2anet_get_bboxes

STRIDES = (8, 16, 32, 64, 128)
KEYS = ("fam_cls", "fam_bbox", "odm_cls", "odm_bbox")


def _randomize(tree, rng, scale):
    """Same structure, leaves replaced by seeded normal noise."""
    return jax.tree_util.tree_map(
        lambda a: (rng.normal(size=np.shape(a)) * scale).astype(np.float32), tree)


def _angle_close(got, want, atol):
    d = np.asarray(jax_norm_angle(jnp.asarray(got - want) + 1.0)) - 1.0
    np.testing.assert_allclose(d, 0.0, atol=atol)


def _compare_outputs(got, want, tol):
    for key in KEYS:
        for lvl, (g, w) in enumerate(zip(got[key], want[key])):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       rtol=tol, atol=tol, err_msg=f"{key}[{lvl}]")
    for g, w in zip(got["init_anchors"], want["init_anchors"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got["refine_anchors"], want["refine_anchors"]):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_allclose(g[..., :4], w[..., :4], rtol=tol, atol=tol * 10)
        _angle_close(g[..., 4], w[..., 4], tol)


@pytest.mark.parametrize("clamp", [0.0, 1.5])
def test_head_matches_jax(rng, clamp):
    """``clamp`` > 0 clips the AlignConv offsets (``align_offset_clamp``)."""
    fc, nc, b = 32, 4, 2
    feats = [rng.normal(size=(b, s, s, fc)).astype(np.float32)
             for s in (16, 8, 4, 2, 1)]
    jhead = JaxHead(num_classes=nc, feat_channels=fc, featmap_strides=STRIDES,
                    deform_impl="gather", align_offset_clamp=clamp)
    shapes = jax.eval_shape(jhead.init, jax.random.PRNGKey(0),
                            [jnp.asarray(f) for f in feats])
    # weights large enough that anchor refinement moves the AlignConv
    # samples several cells
    params = _randomize(shapes["params"], rng, 0.05)
    want = jax.jit(jhead.apply)({"params": params},
                                [jnp.asarray(f) for f in feats])

    head = S2ANetHead(num_classes=nc, feat_channels=fc, featmap_strides=STRIDES,
                      align_offset_clamp=clamp)
    head.load_state_dict(head_state_dict_from_jax(params))
    with torch.no_grad():
        got = head([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    offs = np.abs(np.asarray(want["refine_anchors"][0])[..., 2:4]
                  - np.asarray(want["init_anchors"][0])[..., 2:4]).max()
    assert offs > 8.0  # refinement really moved the anchors
    _compare_outputs(got, want, 1e-4)


@pytest.fixture(scope="module")
def slice_models():
    """JAX and port R-18 detectors on the same folded random weights."""
    rng = np.random.default_rng(1)
    jmodel = JaxS2ANet(backbone_name="resnet18", num_classes=15,
                       deform_impl="gather")
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3), jnp.float32)))
    # non-trivial BatchNorm statistics so the fold does real work
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(0, 0.2, a.shape) if path[-1].key == "mean"
                         else rng.uniform(0.8, 1.2, a.shape)).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    port = S2ANet("resnet18", num_classes=15)
    port.load_state_dict(state_dict_from_jax(variables, "resnet18"))
    port.eval()
    assert fold_bn(port) == 1 + 8 * 2 + 3
    jmodel, jvars = fold_bn_for_eval(jmodel, variables)
    imgs = rng.uniform(size=(2, 128, 128, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jmodel.apply(v, x))(jvars, jnp.asarray(imgs))
    with torch.no_grad():
        got = port(torch.from_numpy(imgs).permute(0, 3, 1, 2))
    return got, jax.device_get(want)


def test_slice_head_outputs_match_jax(slice_models):
    got, want = slice_models
    _compare_outputs(got, want, 2e-3)


def _match_1to1(det_a, lab_a, det_b, lab_b):
    used = np.zeros(len(det_b), bool)
    matched = 0
    for i in range(len(det_a)):
        cand = np.nonzero(
            (~used) & (lab_b == lab_a[i])
            & (np.abs(det_b[:, 5] - det_a[i, 5]) < 1e-3)
            & (np.linalg.norm(det_b[:, :2] - det_a[i, :2], axis=1) < 1.0))[0]
        if len(cand):
            used[cand[0]] = True
            matched += 1
    return matched


def test_slice_detections_match_jax(slice_models):
    got, want = slice_models
    # random-weight ODM scores sit near sigmoid(bias) = 0.01: take the
    # threshold that lets ~300 (box, class) pairs per image through
    scores = np.concatenate([np.asarray(c).reshape(2, -1) for c in want["odm_cls"]], 1)
    thr = float(1 / (1 + np.exp(-np.sort(scores[0])[-300])))
    kw = dict(score_thr=thr, iou_thr=0.5, max_per_img=500, pre_nms_cap=1024)
    det_g, lab_g, val_g = (t.numpy() for t in s2anet_get_bboxes(got, **kw))
    det_w, lab_w, val_w = (np.asarray(t) for t in jax_get_bboxes(
        jax.tree_util.tree_map(jnp.asarray, want), **kw))
    for i in range(2):
        a, la = det_g[i][val_g[i]], lab_g[i][val_g[i]]
        b, lb = det_w[i][val_w[i]], lab_w[i][val_w[i]]
        assert len(b) > 50
        assert _match_1to1(a, la, b, lb) >= 0.95 * max(len(a), len(b))


def test_state_dict_round_trip_resnet18(tmp_path):
    """JAX variables -> port -> convert_reference_s2anet gives them back,
    also through the .npz file predict.py reads."""
    jmodel = JaxS2ANet(backbone_name="resnet18", num_classes=15)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    variables = _randomize(shapes, np.random.default_rng(2), 1.0)
    save_jax_npz(tmp_path / "w.npz", variables)
    port = S2ANet("resnet18", num_classes=15)
    port.load_state_dict(state_dict_from_jax(load_jax_npz(tmp_path / "w.npz"),
                                             "resnet18"))
    back = convert_reference_s2anet(port.state_dict(), "resnet18")
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))


def test_state_dict_round_trip_resnet50():
    """Port R-50 -> JAX variables (the tree the JAX R-50 detector declares)
    -> port gives the same state_dict."""
    port = S2ANet("resnet50", num_classes=15).init_weights(
        torch.Generator().manual_seed(0))
    sd = port.state_dict()
    variables = convert_reference_s2anet(sd, "resnet50")
    shapes = jax.eval_shape(JaxS2ANet(backbone_name="resnet50").init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    assert (jax.tree_util.tree_structure(variables)
            == jax.tree_util.tree_structure(jax.device_get(shapes)))
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(variables),
                                jax.tree_util.tree_leaves_with_path(shapes)):
        assert pa == pb and np.shape(a) == b.shape, pa
    again = state_dict_from_jax(variables, "resnet50")
    assert set(again) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(again[k], v, rtol=0, atol=0, msg=k)
