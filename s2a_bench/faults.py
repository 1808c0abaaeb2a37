"""Faults planted under the timed path, for the check's tests and for the
upper readings of its limits: each must make ``correct`` false.

Serving (wrap the pipeline's step): ``half_batch`` serves no detection for
the second half of every batch; ``alter`` replaces one served detection's
score (the first image's last, of lowest score) by its complement where
the step produces it. Training (wrap ``train_step``):
``frozen`` returns the state unchanged (the loss is computed, nothing
moves); ``half_batch`` trains on the first half of the batch alone, the
mean taken over it.
"""

from __future__ import annotations

import torch


def serve_half_batch(step):
    inner = step.predict

    def predict(x):
        boxes, labels, valid = inner(x)
        valid = valid.clone()
        valid[valid.shape[0] // 2:] = False
        return boxes, labels, valid
    step.predict = predict
    return step


def serve_alter(step):
    inner = step.predict

    def predict(x):
        boxes, labels, valid = inner(x)
        boxes = boxes.clone()
        last = valid[0].nonzero()[-1, 0] if bool(valid[0].any()) else 0
        boxes[0, last, 5] = 1.0 - boxes[0, last, 5]
        return boxes, labels, valid
    step.predict = predict
    return step


def train_frozen(train_step):
    def step(model, optimizer, ema, batch, cfg):
        saved = [p.detach().clone() for p in optimizer.params]
        items = train_step(model, optimizer, ema, batch, cfg)
        with torch.no_grad():
            for p, s in zip(optimizer.params, saved):
                p.copy_(s)
            for st in optimizer.sgd.state.values():
                st.get("momentum_buffer", torch.zeros(())).zero_()
        return items
    return step


def train_half_batch(train_step):
    def step(model, optimizer, ema, batch, cfg):
        half = batch["imgs"].shape[0] // 2
        return train_step(model, optimizer, ema, {k: v[:half] for k, v in batch.items()}, cfg)
    return step


SERVE = {"half_batch": serve_half_batch, "alter": serve_alter}
TRAIN = {"frozen": train_frozen, "half_batch": train_half_batch}
