"""Exponential moving average of the parameters and the BN statistics.

Counterpart of the EMA in ``s2anet_tpu/train/state.py`` (``ema_update``):
after update number ``step`` (counted after the increment) every floating
entry of the state dict -- parameters, BN running means and variances --
moves as ``ema = ema * d + new * (1 - d)`` with
``d = decay * (1 - exp(-step / ramp))``. Integer buffers
(``num_batches_tracked``) are copied. Under gradient accumulation the
caller blends only on the micro-steps that update (the JAX rule blends the
others with ``d = 1``, which leaves the average as it is), and ``step``
counts updates.
"""

from __future__ import annotations

import copy
import math

import torch
from torch import nn


class ModelEMA:
    def __init__(self, model: nn.Module, decay: float = 0.9999, ramp: int = 2000):
        self.module = copy.deepcopy(model).eval()
        for p in self.module.parameters():
            p.requires_grad_(False)
        self.decay = decay
        self.ramp = ramp

    def decay_at(self, step: int) -> float:
        return self.decay * (1.0 - math.exp(-step / self.ramp))

    @torch.no_grad()
    def update(self, model: nn.Module, step: int) -> None:
        d = self.decay_at(step)
        src = model.state_dict()
        ema, new, ints = [], [], []
        for k, v in self.module.state_dict().items():
            if v.is_floating_point():
                ema.append(v)
                new.append(src[k])
            else:
                ints.append((v, src[k]))
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, new, alpha=1.0 - d)
        for v, s in ints:
            v.copy_(s)
