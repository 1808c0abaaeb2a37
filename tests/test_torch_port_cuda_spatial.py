"""Card-only tests of spatial serving: the AlignConv kernel on the blocks a
height-sharded rank builds (halo rows, or the gathered level), a whole
non-square image through the kernels against the plain path, and
``predict``'s division by 255 on the card.

They need an NVIDIA GPU and ``nvcc``; here they skip. On the card:

    python -m pytest tests/test_torch_port_cuda_spatial.py -m cuda -q --noconftest
"""

from unittest import mock

import numpy as np
import pytest
import torch

from s2anet_tpu_torch.config import ModelConfig
from s2anet_tpu_torch.models import head as head_mod
from s2anet_tpu_torch.ops import deform_conv as dc
from s2anet_tpu_torch.ops import nms_rotated as nms
from s2anet_tpu_torch.parallel import mesh, rows, spatial
from s2anet_tpu_torch.predict import S2ANetPredictor

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def sharded_deform(fn, x, off, clamp: float, world: int):
    """``rows.deform_rows(fn, ...)`` as each of ``world`` ranks runs it, in
    this process, the exchanges served from the whole tensors; the ranks'
    outputs concatenated."""
    h = x.shape[1] // world
    outs = []
    for r in range(world):
        def halo(t, top, bottom, dim, r=r):
            zeros = torch.zeros_like(t[:, :1]).expand(-1, max(top, bottom), -1, -1)
            return (x[:, r * h - top:r * h] if r > 0 else zeros[:, :top],
                    x[:, (r + 1) * h:(r + 1) * h + bottom] if r < world - 1
                    else zeros[:, :bottom])

        with mock.patch.object(mesh, "world_size", lambda: world), \
                mock.patch.object(mesh, "rank", lambda r=r: r), \
                mock.patch.object(mesh, "halo_rows", halo), \
                mock.patch.object(mesh, "gather_rows",
                                  lambda t, dim: x if t.dim() == 4 else off), rows.sharded():
            outs.append(rows.deform_rows(fn, x[:, r * h:(r + 1) * h],
                                         off[:, r * h:(r + 1) * h], clamp))
    return torch.cat(outs, 1)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("h,world,clamp", [(96, 2, 6.0), (96, 4, 6.0), (24, 4, 6.0),
                                           (32, 2, 1.5), (48, 2, 0.0)])
def test_alignconv_kernel_on_sharded_blocks(dev, dtype, tol, h, world, clamp):
    """Shards of 48 and 24 rows (taller than the clamp-6 halo of 8), of 6
    (thinner: gathered), clamp 1.5 (halo 4) and clamp 0 (gathered):
    the ranks' rows together within ``tol`` of the largest value of the
    unsharded kernel's output."""
    gen = torch.Generator(device=dev).manual_seed(h + world)
    x = torch.randn(1, h, 40, 64, generator=gen, device=dev).to(dtype)
    reach = clamp if clamp > 0 else 12.0
    off = ((torch.rand(1, h, 40, 9, 2, generator=gen, device=dev) * 2 - 1) * reach).to(dtype)
    wt = (torch.randn(3, 3, 64, 64, generator=gen, device=dev) * 0.05).to(dtype)
    want = dc.deform_conv2d_cuda(x, off, wt)
    before = dc.DEFORM_FWD.launches
    got = sharded_deform(lambda xs, os: dc.deform_conv2d_cuda(xs, os, wt), x, off, clamp, world)
    assert dc.DEFORM_FWD.launches - before == world  # one launch a rank
    err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
    assert got.shape == want.shape and err <= tol, err


def test_whole_image_kernel_path_against_plain(dev):
    """R-18, 3 classes, float32, clamp 6, one non-square 384x640 image, the
    ODM class head's kernel times 100 and the threshold in a gap of the
    scores (none near-tied at it): the spatial step's head outputs through
    the kernels within 1e-3 of the plain path's, its detections matched
    1:1 by centre at least 95%, and
    one launch of the AlignConv a level, of the NMS mask and of the sweep."""
    cfg = ModelConfig(backbone="resnet18", num_classes=3, align_offset_clamp=6.0,
                      max_per_img=300, pre_nms_cap=1024)
    pred = S2ANetPredictor(cfg, device="cuda", dtype=torch.float32, seed=0)
    pred.divide = True
    pred.model.head.odm_cls_head.weight.data.mul_(100.0)
    img = np.random.default_rng(0).integers(0, 256, (1, 384, 640, 3), dtype=np.uint8)
    x = pred.to_input(img)
    counted = (dc.DEFORM_FWD, nms.NMS_MASK, nms.NMS_SWEEP)
    before = [k.launches for k in counted]
    with torch.no_grad():
        out_k = spatial.spatial_forward(pred.forward, x)
        scores = torch.cat([torch.sigmoid(c).reshape(-1) for c in out_k["odm_cls"]])
        top = torch.sort(scores, descending=True).values[:200].cpu().numpy()
        i = 100 + int(np.argmax(top[99:199] - top[100:200]))  # a gap: 100-199 pass
        kw = dict(pred.post_kwargs(), score_thr=float(top[i - 1] + top[i]) / 2)
        det_k = spatial.spatial_predict(pred.forward, x, **kw)
    assert [k.launches - b for k, b in zip(counted, before)] == [10, 1, 1]
    with mock.patch.object(head_mod, "deform_conv2d", dc.deform_conv2d_plain), \
            mock.patch.object(nms, "nms_keep", nms.nms_keep_plain), torch.no_grad():
        out_p = spatial.spatial_forward(pred.forward, x)
        det_p = spatial.spatial_predict(pred.forward, x, **kw)
    for key in spatial.DECODED:
        for a, b in zip(out_k[key], out_p[key]):
            assert ((a - b).abs().max() / b.abs().max()).item() <= 1e-3, key
    (bk, lk, vk), (bp, lp, vp) = ([t[0].cpu().numpy() for t in d] for d in (det_k, det_p))
    a, la, b, lb = bk[vk], lk[vk], bp[vp], lp[vp]
    used, matched = np.zeros(len(b), bool), 0
    for i in range(len(a)):
        cand = np.nonzero((~used) & (lb == la[i]) & (np.abs(b[:, 5] - a[i, 5]) < 1e-3)
                          & (np.linalg.norm(b[:, :2] - a[i, :2], axis=1) < 1.0))[0]
        if len(cand):
            used[cand[0]] = True
            matched += 1
    assert len(b) >= 10 and matched >= 0.95 * max(len(a), len(b)), (len(a), len(b), matched)


def test_predict_division_on_the_card(dev):
    """``divide``: every uint8 level divided by 255 in float32 on the card
    equals NumPy's ``np.float32(x) / 255.0``; the default is the product
    with float32(1/255)."""
    levels = np.arange(256, dtype=np.uint8)
    img = np.broadcast_to(levels.reshape(1, 16, 16, 1), (1, 16, 16, 3)).copy()
    pred = S2ANetPredictor(ModelConfig(backbone="resnet18", num_classes=3), device="cuda",
                           dtype=torch.float32, seed=0)
    got_product = pred.to_input(img)[0, 0].reshape(-1).cpu().numpy()
    pred.divide = True
    got = pred.to_input(img)[0, 0].reshape(-1).cpu().numpy()
    np.testing.assert_array_equal(got, np.float32(levels) / 255.0)
    np.testing.assert_array_equal(got_product, levels.astype(np.float32) * np.float32(1 / 255))
