"""LR schedules: step, cosine and linear, after a linear warmup.

Counterpart of ``s2anet_tpu/train/schedule.py::build_lr_schedule``: indexed
by the update count (the optax count: updates made before this one), with
epochs of ``steps_per_epoch`` updates.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence


def build_lr_schedule(lr0: float, total_steps: int, steps_per_epoch: int,
                      schedule: str = "step",
                      decay_epochs_frac: Sequence[float] = (8 / 12, 11 / 12),
                      decay_factor: float = 0.1, lrf: float = 0.1,
                      warmup_iters: int = 500,
                      warmup_init_factor: float = 1.0 / 3.0) -> Callable[[int], float]:
    """``lr(step)``. step: x``decay_factor`` at each fraction of the total
    epochs; cosine and linear: from lr0 down to ``lrf * lr0``. During the
    first ``warmup_iters`` updates the rate ramps linearly from
    ``warmup_init_factor * lr``."""
    if schedule not in ("step", "cosine", "linear"):
        raise ValueError(f"unknown schedule {schedule}")
    total_epochs = max(total_steps // max(steps_per_epoch, 1), 1)

    def base(step: float) -> float:
        epoch = step / steps_per_epoch
        if schedule == "step":
            mult = 1.0
            for frac in decay_epochs_frac:
                if epoch >= frac * total_epochs:
                    mult *= decay_factor
            return lr0 * mult
        t = min(max(epoch / total_epochs, 0.0), 1.0)
        if schedule == "cosine":
            return lr0 * (((1 + math.cos(t * math.pi)) / 2) * (1 - lrf) + lrf)
        return lr0 * ((1 - t) * (1.0 - lrf) + lrf)

    def lr_fn(step: int) -> float:
        if step < warmup_iters:
            warm = warmup_init_factor + (1 - warmup_init_factor) * min(
                max(step / max(warmup_iters, 1), 0.0), 1.0)
            return base(step) * warm
        return base(step)

    return lr_fn
