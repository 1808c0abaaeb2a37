"""SGD with momentum, masked weight decay, global-norm clipping, frozen
stages and gradient accumulation.

:class:`Optimizer` is the counterpart of
``s2anet_tpu/train/optim.py::build_optimizer``, the optax chain
``clip_by_global_norm(35) -> add_decayed_weights(1e-4, mask) ->
sgd(lr, momentum 0.9, nesterov False)``:

* the gradients are clipped to a global norm before the update, as optax
  does it (scaled by ``max / norm`` when the norm is not below ``max``;
  the norm accumulated in float64);
* weight decay adds ``wd * p`` to the gradient of conv kernels only (the
  convs, the AlignConv weight and the ORConv weight: every parameter of
  more than one dimension), through two parameter groups;
* ``torch.optim.SGD``'s momentum buffer is optax's trace (``g + m * trace``,
  starting from the first gradient);
* the rate comes from the schedule at the optax count, the number of
  earlier updates.

``frozen_stages >= 0`` (JAX: ``optax.multi_transform`` with
``set_to_zero`` on the frozen partition) is :func:`freeze_stages`: the
frozen parameters stop requiring gradients, so they are outside the
optimizer, the clip norm, the decay and the momentum, as there.

``accumulate > 1`` is ``optax.MultiSteps``: each micro-step's gradient
joins a running mean (``acc + (g - acc) / (n + 1)``, the same operations),
and every ``accumulate``-th micro-step the chain above runs once on the
mean and the mean restarts at zero; the micro-steps between leave the
parameters as they are.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..models.resnet import is_frozen_stage


def is_frozen(name: str, frozen_stages: int) -> bool:
    """The JAX ``freeze_mask`` rule on the port's parameter names: with
    ``frozen_stages >= 0`` the stem (``backbone.backbone.0``) and
    ``layer1..frozen_stages`` (``backbone.backbone.1..``) are frozen."""
    parts = name.split(".")
    if parts[:2] != ["backbone", "backbone"]:
        return False
    return is_frozen_stage(int(parts[2]), frozen_stages)


def freeze_stages(model: nn.Module, frozen_stages: int) -> int:
    """Stop gradients to the frozen stages' parameters; returns how many
    tensors were frozen."""
    n = 0
    for name, p in model.named_parameters():
        if is_frozen(name, frozen_stages):
            p.requires_grad_(False)
            n += 1
    return n


class Optimizer:
    """The update rule; :meth:`step` takes one micro-step's gradients from
    ``.grad`` and updates the parameters every ``accumulate`` micro-steps
    (then :attr:`synced` is true)."""

    def __init__(self, model: nn.Module, lr_schedule: Callable[[int], float],
                 momentum: float = 0.9, weight_decay: float = 1e-4,
                 grad_clip_norm: float = 35.0, accumulate: int = 1):
        params = [p for p in model.parameters() if p.requires_grad]
        decay = [p for p in params if p.dim() > 1]
        no_decay = [p for p in params if p.dim() <= 1]
        self.params = params
        self.lr_schedule = lr_schedule
        self.grad_clip_norm = grad_clip_norm
        self.accumulate = max(int(accumulate), 1)
        self.sgd = torch.optim.SGD(
            [{"params": decay, "weight_decay": weight_decay},
             {"params": no_decay, "weight_decay": 0.0}],
            lr=lr_schedule(0), momentum=momentum, nesterov=False)
        self.count = 0  # updates made so far
        self.micro = 0  # micro-steps made so far
        self.synced = False
        self.acc = ([torch.zeros_like(p) for p in params]
                    if self.accumulate > 1 else [])

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def _clip(self, grads) -> None:
        # the squares summed in float64: a float32 sum over a model's
        # tens of millions of squares drifts by 1e-5 (XLA's stays near 1e-7)
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads, 2, dtype=torch.float64)))
        torch._foreach_mul_(grads, (self.grad_clip_norm / norm).clamp(max=1.0).float())

    def step(self) -> None:
        self.micro += 1
        if self.accumulate > 1:
            n = (self.micro - 1) % self.accumulate
            grads = [p.grad for p in self.params]
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(n + 1))
            torch._foreach_add_(self.acc, delta)
            self.synced = n == self.accumulate - 1
            if not self.synced:
                return
            for p, a in zip(self.params, self.acc):
                p.grad = a.clone()
            torch._foreach_zero_(self.acc)
        self.synced = True
        if self.grad_clip_norm and self.grad_clip_norm > 0:
            self._clip([p.grad for p in self.params])
        lr = self.lr_schedule(self.count)
        for group in self.sgd.param_groups:
            group["lr"] = lr
        self.sgd.step()
        self.count += 1

    def state_dict(self) -> dict:
        """Counts, momentum buffers and the accumulated mean, as tensors in
        parameter order (the checkpoint's optimizer part)."""
        mom = [self.sgd.state.get(p, {}).get("momentum_buffer") for p in self.params]
        return {"count": self.count, "micro": self.micro,
                "momentum": [torch.empty(0) if m is None else m for m in mom],
                "acc": list(self.acc)}

    def load_state_dict(self, state: dict) -> None:
        if len(state["momentum"]) != len(self.params) or len(state["acc"]) != len(self.acc):
            raise ValueError("checkpoint optimizer state does not fit this model's "
                             "trainable parameters (frozen_stages or accumulation differ)")
        self.count, self.micro = int(state["count"]), int(state["micro"])
        for p, m in zip(self.params, state["momentum"]):
            if m.numel():
                self.sgd.state[p]["momentum_buffer"] = m.to(p.device).clone(
                    memory_format=torch.preserve_format)
        for a, s in zip(self.acc, state["acc"]):
            a.copy_(s)
