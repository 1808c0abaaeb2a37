"""FPN and PAN necks: P3-P7 from C3-C5.

Counterparts of ``s2anet_tpu/models/fpn.py``. :class:`FPN`: 1x1 laterals,
nearest-2x top-down additive fusion, 3x3 output convs, then P6 as a
stride-2 3x3 conv on raw C5 and P7 as one on P6. :class:`PAN`: that FPN,
then a bottom-up path of stride-2 3x3 convs, each level through a 3x3
output conv and a ReLU.
"""

from __future__ import annotations

from typing import Sequence

import math

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

    def quant_sites(self):
        """``(parent, key)`` of the laterals, the output convs and the
        extras, the convs the ``neck`` quantisation scope takes."""
        for convs in (self.lateral_convs, self.fpn_convs):
            for key in convs._modules:
                yield convs, key

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Xavier-uniform kernels, zero biases."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)


class PAN(nn.Module):
    """FPN plus a bottom-up aggregation path. For each input level i >= 1,
    in order, ``outs[i] = relu(pan_out(outs[i] + relu(pan_down(outs[i-1]))))``
    with ``outs[i-1]`` the level just updated; the extra levels (P6, P7)
    take ``relu(pan_out(outs[i]))`` with no bottom-up term; P3 stays the
    FPN's output."""

    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5):
        super().__init__()
        self.fpn = FPN(in_channels, out_channels, num_outs)
        self.n_in = len(in_channels)
        self.pan_down_convs = nn.ModuleList(
            Conv2d(out_channels, out_channels, 3, 2, 1) for _ in range(self.n_in - 1))
        self.pan_out_convs = nn.ModuleList(
            Conv2d(out_channels, out_channels, 3, 1, 1) for _ in range(num_outs - 1))

    def forward(self, inputs):
        outs = list(self.fpn(inputs))
        for i in range(1, self.n_in):
            outs[i] = outs[i] + F.relu(self.pan_down_convs[i - 1](outs[i - 1]))
            outs[i] = F.relu(self.pan_out_convs[i - 1](outs[i]))
        for i in range(self.n_in, len(outs)):
            outs[i] = F.relu(self.pan_out_convs[i - 1](outs[i]))
        return tuple(outs)

    def quant_sites(self):
        """The inner FPN's sites, then the bottom-up and output convs."""
        yield from self.fpn.quant_sites()
        for convs in (self.pan_down_convs, self.pan_out_convs):
            for key in convs._modules:
                yield convs, key

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """The inner FPN Xavier-uniform; the PAN convs flax's default
        ``lecun_normal`` (a normal truncated at two standard deviations,
        variance 1 / fan_in), zero biases."""
        self.fpn.init_weights(generator)
        for conv in (*self.pan_down_convs, *self.pan_out_convs):
            fan_in = conv.weight[0].numel()
            # the standard deviation of a unit normal truncated to [-2, 2]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            nn.init.zeros_(conv.bias)
