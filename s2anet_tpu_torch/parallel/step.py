"""The data-parallel train step's gradient: one sum over the ranks.

Counterpart of ``s2anet_tpu/parallel/step.py::make_train_step`` with a
mesh. There the step is one program over the global batch, and its
gradient is that of the global loss. Here each rank runs
``train/step.py::train_step`` on its slice with the loss normalised by the
global batch's positives (``models/head.py``, ``distributed``), so its
local loss is its share of the global loss; the gradient of the global
loss is the sum over the ranks of the local gradients, and the loss items
the sum of the local items. :func:`sum_over_ranks` adds both up in one
``all_reduce`` of one flat float32 buffer after the backward, before
clipping, SGD and the EMA, which then run identically on every rank (the
reference's DDP averages instead, and scales its loss by WORLD_SIZE while
counting positives per process: the approximation the JAX step replaced).

Left out of the sum: gamma and beta of each BatchNorm in training mode.
Its backward all-reduces its sums (``models/bn.py``), so their gradient is
already that of the global batch on every rank. The sum runs after the
backward, so its collectives follow the BatchNorms' in one order on every
rank.
"""

from __future__ import annotations

import torch
from torch import nn

from ..models.bn import BatchNorm2d
from .mesh import all_reduce_sum


def summed_elsewhere(model: nn.Module) -> set:
    """ids of the parameters whose gradient the backward already summed
    over the ranks: the affine parameters of training BatchNorms."""
    return {id(p) for m in model.modules() if isinstance(m, BatchNorm2d) and m.training
            for p in (m.weight, m.bias)}


def sum_over_ranks(model: nn.Module, params, items: torch.Tensor) -> torch.Tensor:
    """Replace each ``p.grad`` of ``params`` (but those of
    :func:`summed_elsewhere`) by its sum over the ranks; returns the loss
    items summed over the ranks."""
    done = summed_elsewhere(model)
    grads = [p.grad for p in params if id(p) not in done]
    flat = torch.cat([g.reshape(-1) for g in grads] + [items.detach().reshape(-1)])
    parts = all_reduce_sum(flat).split([g.numel() for g in grads] + [items.numel()])
    torch._foreach_copy_(grads, [s.view(g.shape) for s, g in zip(parts, grads)])
    return parts[-1]
