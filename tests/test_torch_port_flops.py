"""The analytic FLOP counter (``utils/flops.py``) against the JAX package's
(``s2anet_tpu/utils/flops.py``), tracing only on both sides.

The serving function of both packages -- detector, decode and NMS, the
JAX side on its gather AlignConv path as ``bench.py`` counts it -- gives
the same count after dead-code removal and as traced, at R-18 64^2 and at
R-50 1024^2 batch 1, but for one named term: the JAX ResNet runs its 7x7
stride-2 stem as a 4x4 convolution over the factor-2 space-to-depth input
(12 channels, a (H/2 + 1) x (W/2 + 1) output cropped afterwards;
``s2anet_tpu/models/resnet.py::_stem_s2d_conv``), which has more
multiply-adds than the 7x7 convolution the port runs. The port's
dead-code removal drops exactly the FAM classification branch.
"""

import math

import jax
import jax.numpy as jnp
import pytest
import torch

from s2anet_tpu.models.detector import S2ANet as JaxS2ANet
from s2anet_tpu.models.head import s2anet_get_bboxes as jax_get_bboxes
from s2anet_tpu.utils.flops import count_fn_flops as jax_count
from s2anet_tpu_torch.config import ModelConfig
from s2anet_tpu_torch.export import export_serving, serving_module
from s2anet_tpu_torch.ops import deform_conv as dc
from s2anet_tpu_torch.predict import S2ANetPredictor
from s2anet_tpu_torch.utils import flops


def stem_s2d_term(b: int, h: int, w: int) -> int:
    """JAX's space-to-depth stem less the port's 7x7 stride-2 stem (64
    output channels, 3 input channels)."""
    jax_stem = 2 * b * (h // 2 + 1) * (w // 2 + 1) * 64 * (4 * 4 * 12)
    port_stem = 2 * b * (h // 2) * (w // 2) * 64 * (7 * 7 * 3)
    return jax_stem - port_stem


def fam_cls_term(b: int, h: int, w: int, nc: int, strides=(8, 16, 32, 64, 128)) -> int:
    """The FAM classification stack (two 3x3 256 -> 256 convs) and head
    (1x1 256 -> nc) over the five levels: dead at inference."""
    cells = sum(math.ceil(h / s) * math.ceil(w / s) for s in strides)
    return 2 * b * cells * (2 * 9 * 256 * 256 + 256 * nc)


class _Ops(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(8, 12, 3, stride=2, padding=1, groups=2)
        self.dead = torch.nn.Conv2d(8, 8, 1)
        self.lin = torch.nn.Linear(12, 5)

    def forward(self, x, a, b, xd, off, wd):
        self.dead(x)  # reaches no output
        y = self.lin(self.conv(x).mean((2, 3)))      # [2, 5]
        return y, a @ b, torch.bmm(a[None], b[None]), dc.deform_conv2d(xd, off, wd)


def test_node_rules():
    args = (torch.zeros(2, 8, 10, 10), torch.zeros(4, 6), torch.zeros(6, 3),
            torch.zeros(2, 5, 7, 8), torch.zeros(2, 5, 7, 9, 2), torch.zeros(3, 3, 8, 16))
    conv = 2 * (2 * 12 * 5 * 5) * (4 * 3 * 3)
    lin, mm = 2 * 2 * 5 * 12, 2 * 4 * 3 * 6
    deform = 2 * 2 * 5 * 7 * 8 * 16 * 9
    want = conv + lin + 2 * mm + deform
    assert flops.count_fn_flops(_Ops().eval(), *args) == want
    assert flops.count_fn_flops(_Ops().eval(), *args, dce=False) == want + 2 * 2 * 100 * 8 * 8
    assert flops.mfu(1e9, 100.0, 1e12) == pytest.approx(0.1)


def _port(arch, size):
    pred = S2ANetPredictor(ModelConfig(backbone=arch), device="cpu", dtype=torch.float32)
    program = export_serving(serving_module(pred), 1, size, "cpu")
    return flops.count_program_flops(program), flops.count_program_flops(program, dce=False)


def _jax(arch, size):
    cfg = ModelConfig()
    model = JaxS2ANet(backbone_name=arch, num_classes=cfg.num_classes, deform_impl="gather")
    spec = jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32)
    variables = jax.eval_shape(model.init, jax.random.PRNGKey(0), spec)
    post = dict(score_thr=cfg.score_thr, iou_thr=cfg.nms_iou_thr,
                max_before_nms_per_level=cfg.max_before_nms_per_level,
                max_per_img=cfg.max_per_img, pre_nms_cap=cfg.pre_nms_cap)

    def one_batch(v, im):  # bench.py's MFU numerator
        return jax_get_bboxes(model.apply(v, im, train=False), **post)

    return (jax_count(one_batch, variables, spec),
            jax_count(one_batch, variables, spec, dce=False))


@pytest.mark.parametrize("arch,size", [("resnet18", 64), ("resnet50", 1024)])
def test_counts_equal_jax_but_for_the_stem(arch, size):
    port_dce, port_all = _port(arch, size)
    jax_dce, jax_all = _jax(arch, size)
    term = stem_s2d_term(1, size, size)
    assert port_dce == jax_dce - term
    assert port_all == jax_all - term
    assert port_all - port_dce == fam_cls_term(1, size, size, ModelConfig().num_classes)
