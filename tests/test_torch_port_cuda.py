"""Card-only tests of the port's CUDA kernels against their plain versions,
of their launch counts through the public functions, and of the wrappers'
input checks.

They need an NVIDIA GPU and ``nvcc``; here they skip. On the card:

    python -m pytest tests/test_torch_port_cuda.py -m cuda -q --noconftest

(``--noconftest``: tests/conftest.py imports JAX, which the machine with the
card does not have.) Float32 comparisons turn TF32 off for matmuls and cuDNN.
"""

import contextlib

import numpy as np
import pytest
import torch

from s2anet_tpu_torch.config import ModelConfig
from s2anet_tpu_torch.ops import deform_conv as dc
from s2anet_tpu_torch.ops import iou_rotated as iou
from s2anet_tpu_torch.ops import moments as mo
from s2anet_tpu_torch.ops import nms_rotated as nms
from s2anet_tpu_torch.ops import topk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def gen(dev):
    return torch.Generator(device=dev).manual_seed(0)


@pytest.mark.parametrize("shape,scale,dtype,tol", [
    ((2, 32, 32, 64, 32), 1.5, torch.float32, 1e-4),
    ((1, 19, 41, 40, 24), 6.0, torch.float32, 1e-4),
    ((2, 1, 1, 16, 16), 3.0, torch.float32, 1e-4),
    ((2, 16, 48, 256, 256), 1.5, torch.bfloat16, 2e-2),
    ((1, 19, 41, 40, 24), 6.0, torch.bfloat16, 2e-2),
    # bf16 tile edges: 779 cells (not a multiple of 128), C and Cout past
    # one 256 block, 1x1 maps, the P7 shape, offsets hundreds of px outside
    ((1, 19, 41, 256, 256), 3.0, torch.bfloat16, 2e-2),
    ((1, 19, 41, 264, 264), 3.0, torch.bfloat16, 2e-2),
    ((2, 1, 1, 256, 256), 3.0, torch.bfloat16, 2e-2),
    ((8, 8, 8, 256, 256), 1.5, torch.bfloat16, 2e-2),
    ((2, 16, 48, 256, 256), 500.0, torch.bfloat16, 2e-2),
])
def test_deform_kernel_matches_plain(dev, gen, shape, scale, dtype, tol):
    b, h, w, c, co = shape
    x = torch.randn(b, h, w, c, generator=gen, device=dev).to(dtype)
    off = (torch.randn(b, h, w, 9, 2, generator=gen, device=dev) * scale).to(dtype)
    wt = (torch.randn(3, 3, c, co, generator=gen, device=dev) * 0.05).to(dtype)
    before = dc.DEFORM_FWD.launches
    got = dc.deform_conv2d(x, off, wt)
    torch.cuda.synchronize()
    assert dc.DEFORM_FWD.launches == before + 1
    ref = dc.deform_conv2d_plain(x, off, wt)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


def test_deform_bf16_needs_channel_multiples_of_8(dev):
    x = torch.zeros(1, 4, 4, 12, device=dev, dtype=torch.bfloat16)
    off = torch.zeros(1, 4, 4, 9, 2, device=dev)
    with pytest.raises(ValueError):
        dc.deform_conv2d(x, off, torch.zeros(3, 3, 12, 16, device=dev,
                                             dtype=torch.bfloat16))


def test_iou_kernel_matches_plain(dev, gen):
    b1 = torch.cat([torch.rand(300, 2, generator=gen, device=dev) * 200,
                    torch.rand(300, 2, generator=gen, device=dev) * 60 + 4,
                    torch.rand(300, 1, generator=gen, device=dev) * 3 - 1], 1)
    b2 = b1[:200] + torch.randn(200, 5, generator=gen, device=dev) * 0.5
    b2[:, 2:4] = b2[:, 2:4].abs() + 1
    got = iou.box_iou_rotated(b1, b2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, iou.box_iou_rotated_plain(b1, b2),
                               rtol=0, atol=1e-6)


def _iou_boxes(gen, dev, shape, span):
    """Random rotated boxes ``shape + (5,)`` over ``span`` pixels."""
    xy = torch.rand(shape + (2,), generator=gen, device=dev) * span
    wh = torch.rand(shape + (2,), generator=gen, device=dev) * 60 + 4
    ang = torch.rand(shape + (1,), generator=gen, device=dev) * 3 - 1
    return torch.cat([xy, wh, ang], -1)


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("m", [1, 19, 64, 130])
def test_batched_iou_kernel_equals_plain(dev, gen, b, m):
    """One launch for [B, N, 5] x [B, M, 5]; N = 1000 is not a multiple of
    the 64-row tile, M = 130 takes three column passes; a padded gt slot
    (zero box) gives 0."""
    b1 = _iou_boxes(gen, dev, (b, 1000), 300.0)
    b2 = _iou_boxes(gen, dev, (b, m), 300.0)
    b2[:, -1] = 0.0
    before = iou.BOX_IOU.launches
    got = iou.box_iou_rotated(b1, b2)
    torch.cuda.synchronize()
    assert iou.BOX_IOU.launches == before + 1 and got.shape == (b, 1000, m)
    want = iou.box_iou_rotated_plain(b1, b2)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert (got[:, :, -1] == 0).all() and (m < 19 or (got > 0).sum() > 100)


@pytest.mark.parametrize("b", [3, 8])
def test_batched_iou_kernel_shared_anchors(dev, gen, b):
    """Anchors [A, 5] shared by the batch (read with a batch stride of 0)
    give what the batch of copies gives, and the plain version."""
    anc = _iou_boxes(gen, dev, (777,), 200.0)
    gts = _iou_boxes(gen, dev, (b, 64), 200.0)
    got = iou.box_iou_rotated(anc, gts)
    torch.cuda.synchronize()
    copies = iou.box_iou_rotated(anc[None].expand(b, -1, -1).contiguous(), gts)
    assert torch.equal(got, copies)
    torch.testing.assert_close(got, iou.box_iou_rotated_plain(anc, gts), rtol=0, atol=1e-6)


def test_batched_iou_kernel_degenerate_boxes(dev):
    """Identical, grid-touching, stacked-touching, shared-edge, contained
    and zero-size boxes, as rows and as a batch of gts."""
    s = 8.0
    rows = [[x * s, y * s, 4 * s, 4 * s, 0.0] for x in range(4) for y in range(4)]
    rows += [[100.0, 100.0, 80.0, 40.0, 0.0], [100.0, 130.0, 60.0, 20.0, 0.0],
             [50.0, 50.0, 100.0, 40.0, 0.0], [80.0, 50.0, 60.0, 40.0, 0.0],
             [10.0, 10.0, 50.0, 30.0, 0.3], [10.0, 10.0, 20.0, 10.0, 0.3]]
    rows += [[0.0] * 5] * 3
    deg = torch.tensor(rows, device=dev)
    got = iou.box_iou_rotated(deg, deg[None].repeat(2, 1, 1))
    torch.cuda.synchronize()
    torch.testing.assert_close(got[1], iou.box_iou_rotated_plain(deg, deg), rtol=0, atol=1e-6)
    assert torch.equal(got[0], got[1])


def test_nms_kernels_match_plain(dev, gen):
    b, k = 3, 1000
    ctr = torch.rand(b, 10, 2, generator=gen, device=dev) * 300
    pick = torch.randint(0, 10, (b, k), generator=gen, device=dev)
    xy = torch.gather(ctr, 1, pick[..., None].expand(-1, -1, 2))
    xy = xy + torch.randn(b, k, 2, generator=gen, device=dev) * 5
    wh = torch.rand(b, k, 2, generator=gen, device=dev) * 40 + 10
    ang = torch.rand(b, k, 1, generator=gen, device=dev) - 0.5
    boxes = torch.cat([xy, wh, ang], -1)
    labels = torch.randint(0, 4, (b, k), generator=gen, device=dev)
    valid = torch.arange(k, device=dev)[None] < torch.tensor([[k], [700], [0]], device=dev)
    got = nms.nms_keep(boxes, labels, valid, 0.5)
    torch.cuda.synchronize()
    want = nms.nms_keep_plain(boxes, labels, valid, 0.5)
    assert torch.equal(got, want)
    assert got.sum() < valid.sum()


def _candidates(gen, dev, b, k, valid_kind, one_label, large_labels=False):
    """Score-sorted-looking NMS candidates crowded around a few centres;
    labels 0-14, all 0, or 15 large values."""
    ctr = torch.rand(b, 12, 2, generator=gen, device=dev) * 400
    pick = torch.randint(0, 12, (b, k), generator=gen, device=dev)
    xy = torch.gather(ctr, 1, pick[..., None].expand(-1, -1, 2))
    xy = xy + torch.randn(b, k, 2, generator=gen, device=dev) * 6
    wh = torch.rand(b, k, 2, generator=gen, device=dev) * 40 + 8
    ang = torch.rand(b, k, 1, generator=gen, device=dev) * 1.6 - 0.8
    boxes = torch.cat([xy, wh, ang], -1)
    labels = (torch.zeros(b, k, dtype=torch.int64, device=dev) if one_label
              else torch.randint(0, 15, (b, k), generator=gen, device=dev))
    if large_labels:
        labels = labels * 1000003 + (1 << 30)
    idx = torch.arange(k, device=dev)[None]
    if valid_kind == "prefix":
        valid = idx < torch.tensor([[k], [max(1, (2 * k) // 3)]], device=dev)[:b]
    elif valid_kind == "scattered":  # not a prefix: the tiles' ballot decides
        valid = torch.rand(b, k, generator=gen, device=dev) < 0.6
        valid[:, -1] = True
    else:
        valid = torch.zeros(b, k, dtype=torch.bool, device=dev)
    return boxes, labels, valid


def _assert_mask_and_keep_equal_plain(boxes, labels, valid, thr):
    """The mask kernel's bits of valid rows, from each row's own word on
    (the words the sweep reads), and the keeps equal the plain versions."""
    b, k = valid.shape
    n_mask, n_sweep = nms.NMS_MASK.launches, nms.NMS_SWEEP.launches
    mask = nms.nms_mask_cuda(boxes, labels, valid, thr)
    keep = nms.nms_keep(boxes, labels, valid, thr)
    torch.cuda.synchronize()
    assert (nms.NMS_MASK.launches, nms.NMS_SWEEP.launches) == (n_mask + 2, n_sweep + 1)
    bits = ((mask[..., None] >> torch.arange(64, device=mask.device)) & 1).bool()
    bits = bits.reshape(b, k, -1)[:, :, :k]
    idx = torch.arange(k, device=mask.device)
    read = (idx[None, :] // 64) >= (idx[:, None] // 64)
    over = nms.overlap_plain(boxes, labels, valid, thr, k)
    assert torch.equal((bits & read)[valid], over[valid])
    assert torch.equal(keep, nms.nms_keep_plain(boxes, labels, valid, thr))
    return int(over.sum())


@pytest.mark.parametrize("k", [1, 63, 64, 65, 1000, 4096])
@pytest.mark.parametrize("valid_kind,one_label", [("prefix", False), ("scattered", True)])
def test_nms_mask_bits_and_keeps_equal_plain(dev, gen, k, valid_kind, one_label):
    boxes, labels, valid = _candidates(gen, dev, 2, k, valid_kind, one_label)
    pairs = _assert_mask_and_keep_equal_plain(boxes, labels, valid, 0.5)
    assert k < 1000 or pairs > 0


@pytest.mark.parametrize("k", [1, 63, 64, 65, 1000, 4096])
@pytest.mark.parametrize("labels", ["one", "fifteen", "large"])
def test_nms_sweep_keeps_equal_plain(dev, gen, k, labels):
    """The sweep reads only the mask and the valid flags, so its keeps must
    not depend on the labels behind the mask: one label, 15 labels and
    large label values; valid not a prefix, and an image with none valid."""
    boxes, lab, valid = _candidates(gen, dev, 3, k, "scattered", labels == "one",
                                    large_labels=labels == "large")
    valid[2] = False  # an image with no valid candidate
    before = nms.NMS_SWEEP.launches
    keep = nms.nms_keep(boxes, lab, valid, 0.5)
    torch.cuda.synchronize()
    assert nms.NMS_SWEEP.launches == before + 1
    assert torch.equal(keep, nms.nms_keep_plain(boxes, lab, valid, 0.5))
    assert not keep[2].any() and (k < 1000 or keep.sum() < valid.sum())


def test_top_k_cuda_equals_cpu_on_bf16_ties(dev, gen):
    """Sigmoids of bf16 logits tie; the card's order is the CPU's (and
    lax.top_k's): descending, the lower index first."""
    x = torch.sigmoid(torch.randn(4, 80160, generator=gen, device=dev).bfloat16().float())
    x[:, ::7] = -1.0
    vals, idx = topk.top_k(x, 4096)
    want_vals, want_idx = topk.top_k(x.cpu(), 4096)
    assert torch.equal(idx.cpu(), want_idx) and torch.equal(vals.cpu(), want_vals)
    assert len(torch.unique(vals[0])) < 4096


@pytest.mark.parametrize("k", [64, 1000])
def test_nms_mask_all_candidates_invalid(dev, gen, k):
    boxes, labels, valid = _candidates(gen, dev, 2, k, "none", False)
    _assert_mask_and_keep_equal_plain(boxes, labels, valid, 0.5)


@pytest.mark.parametrize("thr", [0.0, -0.1, 0.3])
def test_nms_mask_threshold_edges(dev, gen, thr):
    """At a negative threshold the pairs the cheap tests reject (IoU 0)
    suppress too, as in the plain version."""
    boxes, labels, valid = _candidates(gen, dev, 2, 130, "scattered", False)
    _assert_mask_and_keep_equal_plain(boxes, labels, valid, thr)


def test_nms_mask_degenerate_boxes(dev):
    """Identical, grid-touching, shared-edge, contained and zero-size boxes
    (tests/test_pallas_iou.py's cases), all one label."""
    s = 8.0
    rows = [[x * s, y * s, 4 * s, 4 * s, 0.0] for x in range(4) for y in range(4)]
    rows += [[100.0, 100.0, 80.0, 40.0, 0.0], [100.0, 130.0, 60.0, 20.0, 0.0],
             [50.0, 50.0, 100.0, 40.0, 0.0], [80.0, 50.0, 60.0, 40.0, 0.0],
             [10.0, 10.0, 50.0, 30.0, 0.3], [10.0, 10.0, 20.0, 10.0, 0.3],
             [10.0, 10.0, 50.0, 30.0, 0.3]]
    rows += [[0.0] * 5] * 3
    boxes = torch.tensor(rows, device=dev)[None].repeat(1, 3, 1)
    k = boxes.shape[1]
    labels = torch.zeros(1, k, dtype=torch.int64, device=dev)
    for thr in (0.0, 0.5):
        _assert_mask_and_keep_equal_plain(boxes, labels,
                                          torch.ones(1, k, dtype=torch.bool, device=dev), thr)


def test_small_predictor_kernel_path(dev):
    """R-18 at 256x256: the serving path runs both kernels and gives finite
    outputs of the configured shape."""
    from s2anet_tpu_torch.predict import S2ANetPredictor

    cfg = ModelConfig(backbone="resnet18", max_per_img=300, pre_nms_cap=512)
    pred = S2ANetPredictor(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    imgs = np.random.default_rng(0).integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    n_deform, n_mask = dc.DEFORM_FWD.launches, nms.NMS_MASK.launches
    boxes, labels, valid = pred.predict(imgs, score_thr=0.005)
    torch.cuda.synchronize()
    assert dc.DEFORM_FWD.launches == n_deform + len(cfg.strides)
    assert nms.NMS_MASK.launches == n_mask + 1
    assert boxes.shape == (2, 300, 6) and torch.isfinite(boxes).all()
    assert valid.any()


@pytest.mark.parametrize("shape,scale,dtype,tol", [
    ((2, 32, 32, 64, 32), 1.5, torch.float32, 1e-3),
    ((1, 19, 41, 40, 24), 6.0, torch.float32, 1e-3),
    ((2, 1, 1, 16, 16), 3.0, torch.float32, 1e-3),
    ((2, 16, 48, 256, 256), 1.5, torch.bfloat16, 2e-2),
    ((1, 19, 41, 40, 24), 6.0, torch.bfloat16, 2e-2),
    ((1, 19, 41, 256, 256), 3.0, torch.bfloat16, 2e-2),
    ((1, 19, 41, 264, 264), 3.0, torch.bfloat16, 2e-2),
    ((2, 1, 1, 256, 256), 3.0, torch.bfloat16, 2e-2),
    ((8, 8, 8, 256, 256), 1.5, torch.bfloat16, 2e-2),
    ((2, 16, 48, 256, 256), 500.0, torch.bfloat16, 2e-2),
])
def test_deform_bwd_kernel_matches_plain(dev, gen, shape, scale, dtype, tol):
    """dx and dW against autograd of the plain forward: float32 at 1e-3,
    bfloat16 at 2e-2 of the largest reference value."""
    b, h, w, c, co = shape
    x = torch.randn(b, h, w, c, generator=gen, device=dev).to(dtype)
    off = (torch.randn(b, h, w, 9, 2, generator=gen, device=dev) * scale).to(dtype)
    wt = (torch.randn(3, 3, c, co, generator=gen, device=dev) * 0.05).to(dtype)
    g = torch.randn(b, h, w, co, generator=gen, device=dev).to(dtype)
    xk = x.clone().requires_grad_(True)
    wk = wt.clone().requires_grad_(True)
    n_fwd, n_bwd = dc.DEFORM_FWD.launches, dc.DEFORM_BWD.launches
    dc.deform_conv2d(xk, off, wk).backward(g)
    torch.cuda.synchronize()
    assert (dc.DEFORM_FWD.launches, dc.DEFORM_BWD.launches) == (n_fwd + 1, n_bwd + 1)
    dx, dw = dc.deform_conv2d_bwd_plain(x, off, wt, g)
    for got, ref in ((xk.grad, dx), (wk.grad, dw)):
        assert got.dtype == dtype
        scale = 1.0 if dtype == torch.float32 else ref.float().abs().max().item()
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                   atol=tol * scale)


def test_deform_bwd_bf16_weight_gradient_is_deterministic(dev, gen):
    """dW adds its chunks in a fixed order: two runs agree bit for bit."""
    x = torch.randn(2, 32, 32, 256, generator=gen, device=dev).bfloat16()
    off = (torch.randn(2, 32, 32, 9, 2, generator=gen, device=dev) * 1.5).bfloat16()
    wt = (torch.randn(3, 3, 256, 256, generator=gen, device=dev) * 0.05).bfloat16()
    g = torch.randn(2, 32, 32, 256, generator=gen, device=dev).bfloat16()
    dw = [dc.deform_conv2d_bwd_cuda(x, off, wt, g)[1] for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(dw[0], dw[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 64, 64, 64), (2, 8, 8, 2048), (3, 5, 7, 24)])
def test_moment_kernels_match_plain(dev, gen, shape, dtype):
    """Sums relative to the sum of magnitudes (float32 summation order)."""
    x = (torch.rand(shape, generator=gen, device=dev) * 2 + 0.3).to(dtype)
    g = torch.randn(shape, generator=gen, device=dev).to(dtype)
    n_m, n_p = mo.MOMENTS.launches, mo.PAIR.launches
    got = mo.channel_moments(x) + mo.grad_channel_sums(g, x)
    torch.cuda.synchronize()
    assert (mo.MOMENTS.launches, mo.PAIR.launches) == (n_m + 1, n_p + 1)
    want = mo.channel_moments_plain(x) + mo.grad_channel_sums_plain(g, x)
    xf, gf = x.float().reshape(-1, shape[-1]), g.float().reshape(-1, shape[-1])
    mags = (xf.abs().sum(0), (xf * xf).sum(0), gf.abs().sum(0), (gf * xf).abs().sum(0))
    for a, b, m in zip(got, want, mags):
        assert a.dtype == torch.float32
        assert ((a - b).abs() <= 1e-5 * m).all()


BN_SHAPES = [(8, 64, 64, 64), (2, 8, 8, 2048), (3, 5, 7, 24), (2, 1, 1, 256)]


def _bn_case(gen, dev, shape, dtype):
    c = shape[-1]
    x = (torch.rand(shape, generator=gen, device=dev) * 2 + 0.3).to(dtype)
    g = torch.randn(shape, generator=gen, device=dev).to(dtype)
    weight = torch.rand(c, generator=gen, device=dev) + 0.5
    bias = torch.randn(c, generator=gen, device=dev) * 0.3
    running = (torch.randn(c, generator=gen, device=dev) * 0.2,
               torch.rand(c, generator=gen, device=dev) + 0.5)
    return x, g, weight, bias, running


def _rel_to_max(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_bn_finishing_matches_plain(dev, gen, shape, dtype):
    """The finishing steps against the plain ones on the kernel's own sums
    (the sums are deterministic: same chunks, same order), within 1e-6 of
    each vector's largest value."""
    x, g, weight, _, (rm, rv) = _bn_case(gen, dev, shape, dtype)
    n = x.numel() // shape[-1]
    rm_p, rv_p = rm.clone(), rv.clone()
    tracked, tracked_p = (torch.tensor(3, device=dev) for _ in range(2))
    n_m, n_p = mo.MOMENTS.launches, mo.PAIR.launches
    got = mo.bn_stats_cuda(x, weight, rm, rv, tracked, 1e-5, 0.9)
    want = mo.stats_from_sums(*mo.channel_moments_cuda(x), n, weight, rm_p, rv_p,
                              tracked_p, 1e-5, 0.9)
    got_g = mo.bn_grad_cuda(g, x, got[0], got[2])
    want_g = mo.grad_from_sums(*mo.grad_channel_sums_cuda(g, x), n, got[0], got[2])
    torch.cuda.synchronize()
    assert (mo.MOMENTS.launches, mo.PAIR.launches) == (n_m + 2, n_p + 2)
    assert int(tracked) == int(tracked_p) == 4
    for a, b in zip(got + (rm, rv) + got_g, want + (rm_p, rv_p) + want_g):
        assert a.dtype == torch.float32 and a.shape == (shape[-1],)
        assert _rel_to_max(a, b) <= 1e-6


@pytest.mark.parametrize("shape,dtype", [
    ((2, 3, 1, 8), torch.bfloat16), ((3, 1, 5, 4), torch.float32),  # one vector a row
    ((1, 1, 1, 256), torch.bfloat16), ((1, 1, 1, 4), torch.float32),  # rows = 1
    ((8, 512, 512, 64), torch.bfloat16),    # R-50 1024^2 batch 8: the stem
    ((8, 256, 256, 256), torch.bfloat16),   # layer 1
    ((8, 32, 32, 2048), torch.bfloat16),    # layer 4
    ((8, 32, 32, 2048), torch.float32),
])
def test_bn_sums_one_launch_match_plain(dev, gen, shape, dtype):
    """The sums kernels at the odd and the R-50 shapes: one launch a call,
    sums within 1e-5 of the sums of magnitudes, the finishing within 1e-6 of
    the plain finishing on the kernel's own sums."""
    x, g, weight, _, (rm, rv) = _bn_case(gen, dev, shape, dtype)
    c, n = shape[-1], x.numel() // shape[-1]
    rm_p, rv_p = rm.clone(), rv.clone()
    tracked, tracked_p = (torch.tensor(0, device=dev) for _ in range(2))
    n_m, n_p = mo.MOMENTS.launches, mo.PAIR.launches
    stats = mo.bn_stats_cuda(x, weight, rm, rv, tracked, 1e-5, 0.9)
    grad = mo.bn_grad_cuda(g, x, stats[0], stats[2])
    sums = mo.channel_moments_cuda(x) + mo.grad_channel_sums_cuda(g, x)
    torch.cuda.synchronize()
    assert (mo.MOMENTS.launches, mo.PAIR.launches) == (n_m + 2, n_p + 2)
    xf, gf = x.float().reshape(-1, c), g.float().reshape(-1, c)
    want = (xf.sum(0), (xf * xf).sum(0), gf.sum(0), (gf * xf).sum(0))
    mags = (xf.abs().sum(0), (xf * xf).sum(0), gf.abs().sum(0), (gf * xf).abs().sum(0))
    for a, b, m in zip(sums, want, mags):
        assert ((a - b).abs() <= 1e-5 * m).all()
    ref = mo.stats_from_sums(sums[0], sums[1], n, weight, rm_p, rv_p, tracked_p, 1e-5, 0.9)
    ref_g = mo.grad_from_sums(sums[2], sums[3], n, stats[0], stats[2])
    for a, b in zip(stats + (rm, rv) + grad, ref + (rm_p, rv_p) + ref_g):
        assert a.shape == (c,) and _rel_to_max(a, b) <= 1e-6
    assert int(tracked) == int(tracked_p) == 1


@pytest.mark.parametrize("shape", [(8, 512, 512, 64), (8, 32, 32, 2048), (3, 5, 7, 24)])
def test_bn_sums_equal_over_runs(dev, gen, shape):
    """The order of every addition is fixed, whichever cluster finishes
    last: three runs agree bit for bit."""
    x, g, weight, _, _ = _bn_case(gen, dev, shape, torch.bfloat16)
    runs = []
    for _ in range(3):
        run = (torch.zeros_like(weight), torch.ones_like(weight), torch.tensor(0, device=dev))
        stats = mo.bn_stats_cuda(x, weight, *run, 1e-5, 0.9)
        runs.append(stats + mo.bn_grad_cuda(g, x, stats[0], stats[2]) + run[:2])
    torch.cuda.synchronize()
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


def test_bn_sums_tickets_reset_themselves(dev, gen):
    """100 calls back to back, then 10 replays of a captured CUDA graph: the
    count and the running statistics follow the plain updates exactly, so
    every launch left its tickets at zero."""
    x, g, weight, _, (rm, rv) = _bn_case(gen, dev, (4, 16, 16, 256), torch.bfloat16)
    n = x.numel() // 256
    rm_p, rv_p = rm.clone(), rv.clone()
    tracked, tracked_p = (torch.tensor(0, device=dev) for _ in range(2))
    s, q = mo.channel_moments_cuda(x)
    sg, sgx = mo.grad_channel_sums_cuda(g, x)
    for _ in range(100):
        stats = mo.bn_stats_cuda(x, weight, rm, rv, tracked, 1e-5, 0.9)
        grad = mo.bn_grad_cuda(g, x, stats[0], stats[2])
    want = mo.stats_from_sums(s, q, n, weight, rm.clone(), rv.clone(), tracked.clone(),
                              1e-5, 0.9)
    for _ in range(100):
        mo.stats_from_sums(s, q, n, weight, rm_p, rv_p, tracked_p, 1e-5, 0.9)
    torch.cuda.synchronize()
    assert int(tracked) == int(tracked_p) == 100
    assert torch.equal(rm, rm_p) and torch.equal(rv, rv_p)
    assert all(torch.equal(a, b) for a, b in zip(stats, want))
    assert all(torch.equal(a, b) for a, b in zip(
        grad, mo.grad_from_sums(sg, sgx, n, stats[0], stats[2])))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        mo.bn_grad_cuda(g, x, *mo.bn_stats_cuda(x, weight, rm, rv, tracked, 1e-5, 0.9)[0:3:2])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stats_g = mo.bn_stats_cuda(x, weight, rm, rv, tracked, 1e-5, 0.9)
        grad_g = mo.bn_grad_cuda(g, x, stats_g[0], stats_g[2])
    for _ in range(10):
        graph.replay()
    torch.cuda.synchronize()
    for _ in range(11):
        mo.stats_from_sums(s, q, n, weight, rm_p, rv_p, tracked_p, 1e-5, 0.9)
    assert int(tracked) == int(tracked_p) == 111
    assert torch.equal(rm, rm_p) and torch.equal(rv, rv_p)
    assert all(torch.equal(a, b) for a, b in zip(stats_g, want))
    assert all(torch.equal(a, b) for a, b in zip(grad_g, grad))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_bn_apply_and_dx_kernels_equal_plain(dev, gen, shape, dtype):
    """Given the same per-channel vectors, the normalise and dx kernels give
    the plain versions' bits."""
    x, g, weight, bias, (rm, rv) = _bn_case(gen, dev, shape, dtype)
    mean, _, rstd, mul = mo.bn_stats_cuda(x, weight, rm, rv, torch.tensor(0, device=dev),
                                          1e-5, 0.9)
    _, _, a, b = mo.bn_grad_cuda(g, x, mean, rstd)
    n_a, n_d = mo.APPLY.launches, mo.DX.launches
    y = mo.bn_apply(x, mean, mul, bias)
    dx = mo.bn_dx(g, x, mean, mul, a, b)
    torch.cuda.synchronize()
    assert (mo.APPLY.launches, mo.DX.launches) == (n_a + 1, n_d + 1)
    assert y.dtype == dx.dtype == dtype and y.is_contiguous() and dx.is_contiguous()
    assert torch.equal(y, mo.bn_apply_plain(x, mean, mul, bias))
    assert torch.equal(dx, mo.bn_dx_plain(g, x, mean, mul, a, b))


def test_bn_train_runs_the_kernels(dev, gen):
    """The training BatchNorm on the card against the same module with the
    plain versions; gradients as tests/test_pallas_bn.py bounds them."""
    from unittest import mock

    from s2anet_tpu_torch.models import bn as bn_mod

    x = torch.randn(4, 64, 16, 16, generator=gen, device=dev) + 0.5
    x = x.contiguous(memory_format=torch.channels_last)
    kernels = (mo.MOMENTS, mo.APPLY, mo.PAIR, mo.DX)
    runs = []
    for plain in (False, True):
        bn = bn_mod.BatchNorm2d(64).to(dev).train()
        xx = x.clone().requires_grad_(True)
        before = [k.launches for k in kernels]
        with contextlib.ExitStack() as stack:
            for name in ("bn_stats", "bn_apply", "bn_grad", "bn_dx"):
                fn = getattr(mo, name + "_plain") if plain else getattr(mo, name)
                stack.enter_context(mock.patch.object(bn_mod, name, fn))
            torch.sin(bn(xx)).sum().backward()
        torch.cuda.synchronize()
        assert [k.launches - n for k, n in zip(kernels, before)] == [0 if plain else 1] * 4
        runs.append((xx.grad, bn.weight.grad, bn.bias.grad, bn.running_mean, bn.running_var))
    for a, b in zip(*runs):
        assert (a - b).abs().max().item() / max(b.abs().max().item(), 1.0) < 1e-5


SAMPLED_CASES = [((8, 64, 64, 64), 2), ((8, 32, 32, 2048), 2), ((3, 5, 7, 24), 1),
                 ((4, 16, 16, 256), 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k", SAMPLED_CASES)
def test_sampled_bn_kernels_match_plain(dev, gen, shape, k, dtype):
    """Sampled statistics (``bn_stats_images = k``) on the kernels: the
    statistics of the first k images (their rows, no copy), the backward's
    sums over every row finished with the count of the statistics' rows,
    within 1e-6 of the plain finishing on the kernel's own sums; dx on the
    two row ranges into one output equal to the plain version bit for bit."""
    x, g, weight, bias, (rm, rv) = _bn_case(gen, dev, shape, dtype)
    c = shape[-1]
    nk = k * shape[1] * shape[2]
    rm_p, rv_p = rm.clone(), rv.clone()
    tracked, tracked_p = (torch.tensor(0, device=dev) for _ in range(2))
    n_m, n_p = mo.MOMENTS.launches, mo.PAIR.launches
    stats = mo.bn_stats(x[:k], weight, rm, rv, tracked, 1e-5, 0.9)
    mean, _, rstd, mul = stats
    grad = mo.bn_grad(g, x, mean, rstd, nk)
    sums = mo.channel_moments_cuda(x[:k]) + mo.grad_channel_sums_cuda(g, x)
    torch.cuda.synchronize()
    assert (mo.MOMENTS.launches, mo.PAIR.launches) == (n_m + 2, n_p + 2)
    ref = mo.stats_from_sums(sums[0], sums[1], nk, weight, rm_p, rv_p, tracked_p, 1e-5, 0.9)
    ref_g = mo.grad_from_sums(sums[2], sums[3], nk, mean, rstd)
    for a, b in zip(stats + (rm, rv) + grad, ref + (rm_p, rv_p) + ref_g):
        assert a.shape == (c,) and _rel_to_max(a, b) <= 1e-6
    _, _, a, b = grad
    zero = torch.zeros_like(a)
    n_a, n_d = mo.APPLY.launches, mo.DX.launches
    y = mo.bn_apply(x, mean, mul, bias)
    dx = torch.empty_like(x)
    mo.bn_dx(g[:k], x[:k], mean, mul, a, b, out=dx[:k])
    mo.bn_dx(g[k:], x[k:], mean, mul, zero, zero, out=dx[k:])
    torch.cuda.synchronize()
    assert (mo.APPLY.launches, mo.DX.launches) == (n_a + 1, n_d + 2)
    assert torch.equal(y, mo.bn_apply_plain(x, mean, mul, bias))
    want = torch.cat([mo.bn_dx_plain(g[:k], x[:k], mean, mul, a, b),
                      mo.bn_dx_plain(g[k:], x[k:], mean, mul, zero, zero)])
    assert torch.equal(dx, want)


def test_sampled_bn_train_runs_the_kernels(dev, gen):
    """``BatchNorm2d(stats_images=2)`` on 6 images through the kernels
    against the same module on the plain versions: one stats, apply and
    pair launch, two dx launches; outputs, gradients and running
    statistics within 1e-5."""
    from unittest import mock

    from s2anet_tpu_torch.models import bn as bn_mod

    x = torch.randn(6, 64, 16, 16, generator=gen, device=dev) + 0.5
    x = x.contiguous(memory_format=torch.channels_last)
    kernels = (mo.MOMENTS, mo.APPLY, mo.PAIR, mo.DX)
    runs = []
    for plain in (False, True):
        bn = bn_mod.BatchNorm2d(64, stats_images=2).to(dev).train()
        xx = x.clone().requires_grad_(True)
        before = [k.launches for k in kernels]
        with contextlib.ExitStack() as stack:
            for name in ("bn_stats", "bn_apply", "bn_grad", "bn_dx"):
                fn = getattr(mo, name + "_plain") if plain else getattr(mo, name)
                stack.enter_context(mock.patch.object(bn_mod, name, fn))
            y = bn(xx)
            torch.sin(y).sum().backward()
        torch.cuda.synchronize()
        assert [k.launches - n for k, n in zip(kernels, before)] == (
            [0] * 4 if plain else [1, 1, 1, 2])
        runs.append((y.detach(), xx.grad, bn.weight.grad, bn.bias.grad, bn.running_mean,
                     bn.running_var))
    for a, b in zip(*runs):
        assert (a - b).abs().max().item() / max(b.abs().max().item(), 1.0) < 1e-5


def test_kernel_wrappers_reject_cpu_and_non_channels_last(dev):
    from s2anet_tpu_torch.models.bn import BatchNorm2d

    v = torch.zeros(64)
    with pytest.raises(ValueError):
        mo.channel_moments_cuda(torch.zeros(4, 64))
    with pytest.raises(ValueError):
        mo.grad_channel_sums_cuda(torch.zeros(4, 64), torch.zeros(4, 64))
    with pytest.raises(ValueError):
        mo.bn_stats_cuda(torch.zeros(4, 64), v, v, v, torch.tensor(0), 1e-5, 0.9)
    with pytest.raises(ValueError):
        mo.bn_apply_cuda(torch.zeros(4, 64), v, v, v)
    with pytest.raises(ValueError):
        mo.bn_grad_cuda(torch.zeros(4, 64), torch.zeros(4, 64), v, v)
    with pytest.raises(ValueError):
        mo.bn_dx_cuda(torch.zeros(4, 64), torch.zeros(4, 64), v, v, v, v)
    with pytest.raises(ValueError):
        dc.deform_conv2d_bwd_cuda(torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 4, 9, 2),
                                  torch.zeros(3, 3, 8, 8), torch.zeros(1, 4, 4, 8))
    nchw = torch.zeros(2, 64, 8, 8, device=dev)  # contiguous NCHW
    vd = torch.zeros(64, device=dev)
    nhwc = nchw.permute(0, 2, 3, 1)  # not contiguous
    with pytest.raises(ValueError):
        mo.channel_moments(nhwc)
    with pytest.raises(ValueError):
        mo.bn_apply(nhwc, vd, vd, vd)
    with pytest.raises(ValueError):
        mo.bn_grad(nhwc, nhwc.contiguous(), vd, vd)
    with pytest.raises(ValueError):
        mo.bn_dx(nhwc, nhwc.contiguous(), vd, vd, vd, vd)
    with pytest.raises(ValueError):
        BatchNorm2d(64).to(dev).train()(nchw)
    # the backward raises on an output gradient that is not channels-last
    x = torch.zeros(2, 64, 8, 8, device=dev).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    with pytest.raises(ValueError):
        BatchNorm2d(64).to(dev).train()(x).backward(nchw)


@pytest.mark.parametrize("flags,bn", [
    ([], (20, 20, 20, 20)),
    (["--frozen-stages", "1"], (15, 15, 15, 15)),   # stem and layer1's 5 BNs frozen
    (["--norm-eval"], (0, 0, 0, 0)),
    (["--bn-stats-images", "1"], (20, 20, 20, 40)),  # dx on the two row ranges
    (["--no-orconv"], (20, 20, 20, 20)),
])
def test_small_train_step_kernel_path(dev, flags, bn):
    """R-18 at 128^2, batch 2, bf16, one step, with each model option: the
    BN kernels (moments, pair, apply, dx) launch once a training layer (dx
    twice under sampled statistics), AlignConv 5 and 5, the IoU once a
    stage, no NMS, and one process no fused finishing kernel of the
    data-parallel mode."""
    from s2anet_tpu_torch.train.__main__ import KERNELS, main

    before = {k.symbol: k.launches for k in KERNELS}
    summary = main(["--backbone", "resnet18", "--img-size", "128", "--batch-size", "2",
                    "--steps", "1", "--warmup", "0", "--synthetic", "1"] + flags)
    assert np.isfinite(summary["losses"]).all()
    per_step = {k.symbol: k.launches - before[k.symbol] for k in KERNELS}
    assert per_step == {
        "s2a_deform_conv2d_fwd": 5, "s2a_deform_conv2d_bwd": 5,
        "s2a_box_iou_rotated": 2,  # FAM and ODM assignment, one launch each
        "s2a_nms_rotated_mask": 0, "s2a_nms_rotated_sweep": 0,
        "s2a_bn_apply_finish": 0, "s2a_bn_dx_finish": 0,
        **dict(zip(("s2a_channel_moments", "s2a_grad_channel_sums", "s2a_bn_apply",
                    "s2a_bn_dx"), bn))}


# ---------------------------------------------------------------- int8 serving


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [4096, 4096 + 16, 4096 + 5, 2 * 64 * 64 * 256])
def test_quantize_act_kernel_equals_plain(dev, gen, dtype, n):
    """Codes bit-equal to the plain version: exact .5 ties (a power-of-two
    scale), values beyond the clip, a tail past the last 16-element vector."""
    from s2anet_tpu_torch.ops import quant as qt

    s = torch.tensor(2.0 ** -5, device=dev)
    zp = torch.tensor(-31.0, device=dev)
    x = torch.randn(n, generator=gen, device=dev) * 6
    x[: n // 3] = (torch.randint(-200, 200, (n // 3,), generator=gen, device=dev) + 0.5) * s
    x = x.to(dtype)
    got = qt.quantize_act(x, s, zp)
    torch.cuda.synchronize()
    want = qt.quantize_act_plain(x, s, zp)
    assert torch.equal(got, want)
    assert {-127, 127} <= set(got.unique().tolist())


# b, h, w, Cin, Cout, k, stride, pad, output type, bias: every shape class
# of the serving path (backbone 1x1 / 3x3 / stride 2 / downsample, FPN
# lateral and extras, the ODM class stack's Cin 32, the prediction heads'
# Cout 5 and 15 in float32 and bfloat16, ragged M), and every branch of
# ops/quant.py::conv_plan: K split over blocks, a partial last stage of K
# (K = 144, 288), M < 64, more tiles than one wave, 64 / 128 / 256-channel
# tiles, A by TMA and gathered, no bias
INT8_CONV_SHAPES = [
    (2, 32, 32, 64, 256, 1, 1, 0, torch.bfloat16, False),
    (2, 32, 32, 256, 512, 1, 2, 0, torch.bfloat16, False),
    (2, 33, 31, 128, 128, 3, 2, 1, torch.bfloat16, False),
    (2, 16, 16, 2048, 256, 1, 1, 0, torch.bfloat16, True),
    (2, 16, 16, 2048, 256, 3, 2, 1, torch.bfloat16, True),
    (2, 32, 32, 32, 256, 3, 1, 1, torch.bfloat16, True),
    (2, 16, 16, 256, 256, 3, 1, 1, torch.bfloat16, True),
    (2, 16, 16, 256, 5, 3, 1, 1, torch.float32, True),
    (2, 16, 16, 256, 15, 3, 1, 1, torch.bfloat16, True),
    (2, 16, 16, 256, 15, 1, 1, 0, torch.float32, True),
    (1, 7, 9, 64, 64, 3, 1, 1, torch.float32, False),
    (1, 1, 1, 256, 256, 3, 1, 1, torch.bfloat16, True),
    (1, 16, 16, 2048, 256, 3, 2, 1, torch.bfloat16, True),   # split K, K = 18432
    (1, 5, 7, 16, 48, 3, 1, 1, torch.bfloat16, True),        # M = 35, K = 144
    (1, 5, 7, 16, 48, 1, 1, 0, torch.bfloat16, False),       # K = 16 by TMA
    (2, 8, 8, 32, 256, 3, 1, 1, torch.bfloat16, False),      # K = 288
    (8, 64, 64, 64, 256, 1, 1, 0, torch.bfloat16, True),     # 256-channel tiles, > 1 wave
    (8, 64, 64, 256, 256, 3, 1, 1, torch.bfloat16, True),    # gathered, > 1 wave
    (2, 16, 16, 256, 5, 1, 1, 0, torch.float32, False),
    (2, 16, 16, 256, 15, 3, 1, 1, torch.float32, False),
    (4, 40, 40, 256, 200, 3, 1, 1, torch.float32, True),     # float32, 128-channel tiles
]


def _int8_operands(gen, dev, shape, zp=-77, saturated=False):
    b, h, w, cin, cout, k, stride, pad, dtype, has_bias = shape
    if saturated:  # every code at the clip
        xq = (torch.randint(0, 2, (b, h, w, cin), generator=gen, device=dev) * 254 - 127)
        wq = (torch.randint(0, 2, (cout, k, k, cin), generator=gen, device=dev) * 254 - 127)
    else:
        xq = torch.randint(-127, 128, (b, h, w, cin), generator=gen, device=dev)
        wq = torch.randint(-127, 128, (cout, k, k, cin), generator=gen, device=dev)
    xq, wq = xq.to(torch.int8), wq.to(torch.int8)
    corr = (zp * wq.int().sum((1, 2, 3))).int()
    mul = torch.rand(cout, generator=gen, device=dev) * 1e-4
    bias = torch.randn(cout, generator=gen, device=dev) if has_bias else None
    return xq, wq, mul, corr, torch.tensor(float(zp), device=dev), stride, pad, dtype, bias


@pytest.mark.parametrize("shape", INT8_CONV_SHAPES, ids=str)
def test_int8_conv_kernel_equals_plain(dev, gen, shape):
    from s2anet_tpu_torch.ops import quant as qt

    args = _int8_operands(gen, dev, shape)
    before = qt.CONV.launches
    got = qt.int8_conv2d(*args)
    torch.cuda.synchronize()
    want = qt.int8_conv2d_plain(*args)
    assert qt.CONV.launches == before + 1
    assert got.dtype == shape[8] and torch.equal(got, want)


@pytest.mark.parametrize("zp", [127, -127])
@pytest.mark.parametrize("shape", [
    (2, 16, 16, 2048, 256, 3, 2, 1, torch.bfloat16, True),
    (2, 33, 31, 128, 128, 3, 2, 1, torch.bfloat16, False),
    (2, 16, 16, 256, 15, 3, 1, 1, torch.float32, True),
    (2, 32, 32, 64, 256, 1, 1, 0, torch.bfloat16, True),
], ids=str)
def test_int8_conv_saturated_codes_equal_plain(dev, gen, shape, zp):
    """Codes and zero point at the clip: the largest partial and total sums
    (K = 18432 for the first shape) and the zero point in the padding."""
    from s2anet_tpu_torch.ops import quant as qt

    args = _int8_operands(gen, dev, shape, zp=zp, saturated=True)
    got = qt.int8_conv2d(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, qt.int8_conv2d_plain(*args))


def test_int8_split_k_tickets_reset(dev, gen):
    """Ten back-to-back launches of a split-K conv, and two split-K convs
    in turns on one stream, all equal to the plain version: the last block
    of each tile leaves its ticket at zero for the next launch."""
    from s2anet_tpu_torch.ops import quant as qt

    a1 = _int8_operands(gen, dev, (1, 16, 16, 2048, 256, 3, 2, 1, torch.bfloat16, True))
    a2 = _int8_operands(gen, dev, (2, 8, 8, 256, 256, 3, 1, 1, torch.bfloat16, True))
    for args in (a1, a2):
        xq, wq = args[:2]
        plan = qt.conv_plan(*xq.shape, wq.shape[0], wq.shape[1], wq.shape[2], args[5], args[6],
                            2, torch.cuda.get_device_properties(dev).multi_processor_count)
        assert plan.splits > 1
    before = qt.CONV.launches
    outs = [qt.int8_conv2d(*a1) for _ in range(10)]
    outs2 = [qt.int8_conv2d(*a) for _ in range(3) for a in (a1, a2)]
    torch.cuda.synchronize()
    assert qt.CONV.launches == before + 16
    w1, w2 = qt.int8_conv2d_plain(*a1), qt.int8_conv2d_plain(*a2)
    assert all(torch.equal(o, w1) for o in outs)
    assert all(torch.equal(o, w) for o, w in zip(outs2, [w1, w2] * 3))


@pytest.mark.parametrize("scope", ["default", "full"])
def test_int8_model_launches_and_equals_plain_path(dev, scope):
    """R-18 at 128^2, batch 2, bf16: one forward launches each int8 kernel
    once a quantised conv (default scope 19 + 8 + 40; full + 5 + 20), and
    equals, bit for bit, the forward with the int8 convs and the quantiser
    plain."""
    from unittest import mock

    from s2anet_tpu_torch.ops import quant as qt
    from s2anet_tpu_torch.predict import S2ANetPredictor

    scopes = {"default": qt.QUANT_SCOPE_DEFAULT, "full": qt.QUANT_SCOPE_ALL}
    p = S2ANetPredictor(ModelConfig(backbone="resnet18", quant="int8",
                                    quant_scope=scopes[scope]), device="cuda")
    imgs = np.random.default_rng(0).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    p.calibrate([imgs])
    x = p.to_input(imgs)
    before = (qt.QUANTIZE.launches, qt.CONV.launches)
    got = p.forward(x)
    torch.cuda.synchronize()
    n = 67 if scope == "default" else 92
    assert (qt.QUANTIZE.launches - before[0], qt.CONV.launches - before[1]) == (n, n)
    with mock.patch.object(qt, "quantize_act", qt.quantize_act_plain), \
            mock.patch.object(qt, "int8_conv2d", qt.int8_conv2d_plain):
        want = p.forward(x)
    for key in ("fam_cls", "fam_bbox", "odm_cls", "odm_bbox"):
        for a, b in zip(got[key], want[key]):
            assert torch.equal(a, b), key


def test_int8_wrappers_reject_bad_inputs(dev):
    from s2anet_tpu_torch.ops import quant as qt

    s = torch.tensor(0.1, device=dev)
    nchw = torch.zeros(2, 64, 8, 8, device=dev)
    with pytest.raises(ValueError):  # the NHWC view of an NCHW tensor
        qt.quantize_act(nchw.permute(0, 2, 3, 1), s, s)
    with pytest.raises(ValueError):  # a host scalar
        qt.quantize_act(nchw, torch.tensor(0.1), s)
    xq = torch.zeros(1, 8, 8, 24, dtype=torch.int8, device=dev)
    wq = torch.zeros(4, 3, 3, 24, dtype=torch.int8, device=dev)
    v = torch.zeros(4, device=dev)
    with pytest.raises(ValueError):  # Cin not a multiple of 16
        qt.int8_conv2d(xq, wq, v, v.int(), s, 1, 1, torch.bfloat16)
