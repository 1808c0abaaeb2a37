"""A 2-D convolution that computes in its input's type.

Training keeps float32 master parameters and computes in the input's type
(bfloat16 in a bf16 run), as flax does for a conv given ``dtype``: the
weight and bias are cast at use. When the parameters already have the
input's type (a model cast for serving) the cast is a no-op. On a
height-sharded image (``parallel/rows.py``) it runs on the rank's rows.

:func:`quantizable` turns such a conv into an int8-capable
``ops.quant.QuantConv2d`` in place, keeping its parameters: the detector
does so for the convs of the quantisation scope it is given.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.quant import QuantConv2d
from ..parallel import rows


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return rows.conv2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding,
                           self.dilation, self.groups)


def quantizable(parent: nn.Module, key: str, range_slots: int = 1) -> QuantConv2d:
    """``parent``'s child conv ``key`` as a :class:`QuantConv2d` with
    ``range_slots`` activation ranges, replaced in place on first use; the
    new module holds the same parameter objects, so the ``state_dict`` and
    any optimiser or EMA reference are unchanged."""
    conv = parent._modules[key]
    if isinstance(conv, QuantConv2d):
        return conv
    q = QuantConv2d(conv.in_channels, conv.out_channels, conv.kernel_size, conv.stride,
                    conv.padding, conv.dilation, conv.groups, conv.bias is not None,
                    range_slots=range_slots)
    q.weight, q.bias = conv.weight, conv.bias
    q.act_min = q.act_min.to(conv.weight.device)
    q.act_max = q.act_max.to(conv.weight.device)
    parent._modules[key] = q.train(conv.training)
    return q
