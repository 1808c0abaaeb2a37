"""Callback hook registry: a copy of ``s2anet_tpu/utils/callbacks.py``.

The 19 hook points of the reference train and val loops, so tooling can
attach at the same moments of the port's loop.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List

HOOKS = (
    "on_pretrain_routine_start",
    "on_pretrain_routine_end",
    "on_train_start",
    "on_train_epoch_start",
    "on_train_batch_start",
    "optimizer_step",
    "on_before_zero_grad",
    "on_train_batch_end",
    "on_train_epoch_end",
    "on_val_start",
    "on_val_batch_start",
    "on_val_image_end",
    "on_val_batch_end",
    "on_val_end",
    "on_fit_epoch_end",
    "on_model_save",
    "on_train_end",
    "on_params_update",
    "teardown",
)


class Callbacks:
    def __init__(self):
        self._callbacks: Dict[str, List[dict]] = defaultdict(list)

    def register_action(self, hook: str, name: str = "", callback: Callable = None):
        assert hook in HOOKS, f"unknown hook {hook}"
        assert callable(callback)
        self._callbacks[hook].append({"name": name, "callback": callback})

    def get_registered_actions(self, hook: str = None):
        return self._callbacks[hook] if hook else dict(self._callbacks)

    def run(self, hook: str, *args, **kwargs):
        assert hook in HOOKS, f"unknown hook {hook}"
        for entry in self._callbacks[hook]:
            entry["callback"](*args, **kwargs)
