"""FPN neck: P3-P7 from C3-C5.

Counterpart of ``s2anet_tpu/models/fpn.py::FPN``: 1x1 laterals, nearest-2x
top-down additive fusion, 3x3 output convs, then P6 as a stride-2 3x3 conv
on raw C5 and P7 as one on P6.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .conv import Conv2d


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5):
        super().__init__()
        n_in = len(in_channels)
        self.lateral_convs = nn.ModuleList(
            Conv2d(c, out_channels, 1) for c in in_channels)
        extra = [Conv2d(in_channels[-1] if i == 0 else out_channels,
                           out_channels, 3, 2, 1)
                 for i in range(max(num_outs - n_in, 0))]
        self.fpn_convs = nn.ModuleList(
            [Conv2d(out_channels, out_channels, 3, 1, 1)
             for _ in range(n_in)] + extra)
        self.n_in = n_in

    def forward(self, inputs):
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(self.n_in - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], scale_factor=2, mode="nearest")
        outs = [self.fpn_convs[i](laterals[i]) for i in range(self.n_in)]
        for i, conv in enumerate(self.fpn_convs[self.n_in:]):
            outs.append(conv(inputs[-1] if i == 0 else outs[-1]))
        return tuple(outs)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Xavier-uniform kernels, zero biases."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)
