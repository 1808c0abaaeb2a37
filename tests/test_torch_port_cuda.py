"""Card-only tests of the port's CUDA kernels against their plain versions.

They need an NVIDIA GPU and ``nvcc``; here they skip. On the card:

    python -m pytest tests/test_torch_port_cuda.py -m cuda -q --noconftest

(``--noconftest``: tests/conftest.py imports JAX, which the machine with the
card does not have.) Float32 comparisons turn TF32 off for matmuls and cuDNN.
"""

import numpy as np
import pytest
import torch

from s2anet_tpu_torch.config import ModelConfig
from s2anet_tpu_torch.ops import deform_conv as dc
from s2anet_tpu_torch.ops import iou_rotated as iou
from s2anet_tpu_torch.ops import nms_rotated as nms

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
