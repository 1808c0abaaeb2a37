"""SGD with momentum, masked weight decay and global-norm clipping.

:class:`Optimizer` is the counterpart of
``s2anet_tpu/train/optim.py::build_optimizer``, the optax chain
``clip_by_global_norm(35) -> add_decayed_weights(1e-4, mask) ->
sgd(lr, momentum 0.9, nesterov False)``:

* the gradients are clipped to a global norm before the update;
* weight decay adds ``wd * p`` to the gradient of conv kernels only (the
  convs, the AlignConv weight and the ORConv weight: every parameter of
  more than one dimension), through two parameter groups;
* ``torch.optim.SGD``'s momentum buffer is optax's trace (``g + m * trace``,
  starting from the first gradient);
* the rate comes from the schedule at the optax count, the number of
  earlier updates.

``frozen_stages >= 0`` (an optimizer mask in JAX) and gradient accumulation
(``optax.MultiSteps``) are not ported.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn


class Optimizer:
    """The update rule; :meth:`step` applies one update to the gradients
    in ``.grad``."""

    def __init__(self, model: nn.Module, lr_schedule: Callable[[int], float],
                 momentum: float = 0.9, weight_decay: float = 1e-4,
                 grad_clip_norm: float = 35.0):
        params = [p for p in model.parameters() if p.requires_grad]
        decay = [p for p in params if p.dim() > 1]
        no_decay = [p for p in params if p.dim() <= 1]
        self.params = params
        self.lr_schedule = lr_schedule
        self.grad_clip_norm = grad_clip_norm
        self.sgd = torch.optim.SGD(
            [{"params": decay, "weight_decay": weight_decay},
             {"params": no_decay, "weight_decay": 0.0}],
            lr=lr_schedule(0), momentum=momentum, nesterov=False)
        self.count = 0  # updates made so far

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.grad_clip_norm and self.grad_clip_norm > 0:
            torch.nn.utils.clip_grad_norm_(self.params, self.grad_clip_norm)
        lr = self.lr_schedule(self.count)
        for group in self.sgd.param_groups:
            group["lr"] = lr
        self.sgd.step()
        self.count += 1
