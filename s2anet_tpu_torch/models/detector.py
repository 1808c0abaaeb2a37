"""The S2ANet detector: ResNet -> FPN -> S2ANet head.

Counterpart of ``s2anet_tpu/models/detector.py::S2ANet``. ``forward`` takes
``[B, 3, H, W]`` images already scaled by 1/255 and returns the raw head
outputs, in eval and in train mode; :func:`..models.head.s2anet_get_bboxes`
decodes them for serving, :func:`..models.head.compute_s2anet_loss` turns
them into the training loss.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .fpn import FPN
from .head import S2ANetHead
from .resnet import ResNet, stage_channels


class S2ANet(nn.Module):
    def __init__(self, backbone_name: str = "resnet50", num_classes: int = 15,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 align_offset_clamp: float = 0.0):
        super().__init__()
        self.backbone = ResNet(backbone_name)
        self.neck = FPN(stage_channels(backbone_name), 256,
                        num_outs=len(strides))
        self.head = S2ANetHead(num_classes=num_classes, feat_channels=256,
                               featmap_strides=strides,
                               align_offset_clamp=align_offset_clamp)

    def forward(self, imgs: torch.Tensor):
        return self.head(self.neck(self.backbone(imgs)))

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
        """Compute in ``dtype``, except the four prediction heads, whose
        parameters stay float32 (flax computes them in float32 when a
        bfloat16 input meets float32 parameters)."""
        self.to(dtype)
        for conv in self.head.prediction_heads():
            conv.float()
        return self
