"""Serving-time conv + BatchNorm folding.

Counterpart of ``s2anet_tpu/models/fold.py``: at inference a BatchNorm is a
per-channel affine with frozen constants, so its scale folds into the
preceding conv's weight and its shift becomes the conv's bias. The fold is
computed in float64 on the host and stored in float32, as in the JAX package.

Folding composes with int8 serving as in the JAX package: fold first, then
calibrate and quantise, so the per-channel weight scales absorb gamma/sigma
(:func:`fold_bn` refuses a model whose convs already hold int8 constants).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.quant import quant_modules


def _fold_pair(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> None:
    w = conv.weight.detach().cpu().double()
    gamma = bn.weight.detach().cpu().double()
    beta = bn.bias.detach().cpu().double()
    mean = bn.running_mean.detach().cpu().double()
    var = bn.running_var.detach().cpu().double()
    r = gamma / torch.sqrt(var + bn.eps)
    dev = conv.weight.device
    conv.weight = nn.Parameter((w * r[:, None, None, None]).float().to(dev),
                               requires_grad=False)
    conv.bias = nn.Parameter((beta - mean * r).float().to(dev),
                             requires_grad=False)


@torch.no_grad()
def fold_bn(module: nn.Module) -> int:
    """Fold every (conv, BatchNorm) pair under ``module`` in place.

    Pairs are a conv directly followed by a BatchNorm in an
    ``nn.Sequential`` (the stem, the downsample branches) and the
    ``conv{i}``/``bn{i}`` attributes of the residual blocks. Each folded
    BatchNorm becomes an ``nn.Identity``. Returns the number of pairs.
    """
    if any(m.mode == "int8" for _, m in quant_modules(module)):
        raise ValueError("fold_bn: fold BatchNorm before quantising (the int8 constants "
                         "come from the weights at set_quant time)")
    folded = 0
    for parent in list(module.modules()):
        if isinstance(parent, nn.Sequential):
            names = list(parent._modules)
            for a, b in zip(names, names[1:]):
                conv, bn = parent._modules[a], parent._modules[b]
                if isinstance(conv, nn.Conv2d) and isinstance(bn, nn.BatchNorm2d):
                    _fold_pair(conv, bn)
                    parent._modules[b] = nn.Identity()
                    folded += 1
        for i in (1, 2, 3):
            conv = getattr(parent, f"conv{i}", None)
            bn = getattr(parent, f"bn{i}", None)
            if isinstance(conv, nn.Conv2d) and isinstance(bn, nn.BatchNorm2d):
                _fold_pair(conv, bn)
                setattr(parent, f"bn{i}", nn.Identity())
                folded += 1
    return folded
