"""A 2-D convolution that computes in its input's type.

Training keeps float32 master parameters and computes in the input's type
(bfloat16 in a bf16 run), as flax does for a conv given ``dtype``: the
weight and bias are cast at use. When the parameters already have the
input's type (a model cast for serving) the cast is a no-op.
"""

from __future__ import annotations

import torch
from torch import nn


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)
