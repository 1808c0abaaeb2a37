"""The S2ANet detector: ResNet -> FPN -> S2ANet head.

Counterpart of ``s2anet_tpu/models/detector.py::S2ANet``. ``forward`` takes
``[B, 3, H, W]`` images already scaled by 1/255 and returns the raw head
outputs, in eval and in train mode; :func:`..models.head.s2anet_get_bboxes`
decodes them for serving, :func:`..models.head.compute_s2anet_loss` turns
them into the training loss.

int8 serving: :meth:`S2ANet.set_quant` turns the convs of the chosen scope
groups into int8-capable convs in place and switches their mode
(``ops/quant.py``); fold BatchNorm first (``models/fold.py``), then
calibrate (``ops.quant.calibrate``), then serve in ``int8``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.quant import QUANT_MODES, QUANT_SCOPE_DEFAULT, parse_scope, quant_modules
from ..utils.profiler import span
from .conv import quantizable
from .fpn import FPN
from .head import S2ANetHead
from .resnet import ResNet, stage_channels


class S2ANet(nn.Module):
    def __init__(self, backbone_name: str = "resnet50", num_classes: int = 15,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 align_offset_clamp: float = 0.0, frozen_stages: int = -1,
                 norm_eval: bool = False, with_orconv: bool = True,
                 bn_stats_images: int = 0):
        super().__init__()
        self.backbone = ResNet(backbone_name, frozen_stages, norm_eval, bn_stats_images)
        self.neck = FPN(stage_channels(backbone_name), 256,
                        num_outs=len(strides))
        self.head = S2ANetHead(num_classes=num_classes, feat_channels=256,
                               featmap_strides=strides,
                               align_offset_clamp=align_offset_clamp,
                               with_orconv=with_orconv)

    @classmethod
    def from_config(cls, mc) -> "S2ANet":
        """The detector of a ``config.ModelConfig``."""
        return cls(mc.backbone, mc.num_classes, tuple(mc.strides),
                   align_offset_clamp=mc.align_offset_clamp,
                   frozen_stages=mc.frozen_stages, norm_eval=mc.norm_eval,
                   with_orconv=mc.with_orconv, bn_stats_images=mc.bn_stats_images)

    def forward(self, imgs: torch.Tensor):
        """Raw head outputs; under a profiler the span ``s2anet.forward``,
        holding ``s2anet.backbone``, ``s2anet.neck`` and ``s2anet.head``."""
        with span("s2anet.forward"):
            with span("s2anet.backbone"):
                feats = self.backbone(imgs)
            with span("s2anet.neck"):
                feats = self.neck(feats)
            with span("s2anet.head"):
                return self.head(feats)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "S2ANet":
        """Random weights from ``generator`` (the JAX package's
        initialisers: He-normal backbone, Xavier FPN, normal(0.01) head)."""
        self.backbone.init_weights(generator)
        self.neck.init_weights(generator)
        self.head.init_weights(generator)
        return self

    def channels_last(self) -> "S2ANet":
        """Every 4-D weight channels-last: the convs then run NHWC, and the
        AlignConv and BatchNorm kernels read their inputs in place."""
        for p in self.parameters():
            if p.dim() == 4:
                p.data = p.data.contiguous(memory_format=torch.channels_last)
        return self

    def cast(self, dtype: torch.dtype) -> "S2ANet":
        """Compute in ``dtype``, except the four prediction heads (and,
        without the ORConv, the plain ``or_conv`` and the ODM stacks), whose
        parameters stay float32 (flax computes them in float32 when a
        bfloat16 input meets float32 parameters), and the convs set to
        calibrate or run int8, whose float32 weights and ranges the int8
        constants come from (the JAX package quantises its float32
        parameters)."""
        keep = {id(m) for c in self.head.float32_modules() for m in c.modules()}
        keep |= {id(m) for _, m in quant_modules(self) if m.mode != "none"}
        for m in self.modules():
            if id(m) in keep:
                continue
            for p in m._parameters.values():
                if p is not None:
                    p.data = p.data.to(dtype)
            for name, b in m._buffers.items():
                if b is not None and b.is_floating_point():
                    m._buffers[name] = b.to(dtype)
        return self

    def set_quant(self, mode: str, scope=QUANT_SCOPE_DEFAULT) -> "S2ANet":
        """Put the convs of the quantisation ``scope`` (groups of
        ``ops.quant.QUANT_SCOPE_ALL``; validated first) in ``mode``:
        ``calib`` (float, recording per-slot input ranges), ``int8`` (the
        calibrated ranges and current weights as int8 constants; raises on a
        conv never calibrated) or ``none``; every other conv runs float. The
        backbone's block and downsample convs (not the stem), the FPN's
        convs, the head's stacks and prediction heads become
        ``QuantConv2d`` in place on first use; the head's convs and its
        ORConv keep one range per FPN level. Without the ORConv
        (``with_orconv=False``) the ``orconv`` group is empty: the plain
        ``or_conv`` always runs float, as in the JAX package."""
        scope = parse_scope(scope)
        if mode not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {mode!r} (expected none | calib | int8)")
        nlv = len(self.head.featmap_strides)
        sites = {"backbone": (self.backbone.quant_sites, 1),
                 "neck": (self.neck.quant_sites, 1),
                 "head_stacks": (self.head.stack_sites, nlv),
                 "heads": (self.head.head_sites, nlv)}
        active = []
        if mode != "none":
            for group in scope:
                if group == "orconv":
                    if self.head.with_orconv:
                        active.append(self.head.or_conv)
                    continue
                fn, slots = sites[group]
                active += [quantizable(parent, key, slots) for parent, key in list(fn())]
        chosen = {id(m) for m in active}
        for _, m in quant_modules(self):
            if id(m) not in chosen:
                m.set_mode("none")
        for m in active:
            m.set_mode(mode)
        return self
