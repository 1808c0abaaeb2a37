"""One training step on one device.

Counterpart of ``s2anet_tpu/parallel/step.py::make_train_step`` without a
mesh: forward in train mode, assignment and loss, backward, clipping, SGD
and the EMA (one micro-step under gradient accumulation: the EMA moves
only when the optimizer updates). Nothing in the step waits for the
device: the loss normalisation stays on the device, and the one
data-dependent choice of the JAX step (the gt tier of 64) is made on the
host from the batch's numpy mask by :func:`to_device`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from ..models.head import compute_s2anet_loss
from .optim import Optimizer
from .state import ModelEMA

GT_TIER = 64
# the JAX loader's scale (``rgb *= 1.0 / 255.0`` on a float32 array): a
# product by this float32 constant, not a division by 255 (1 ulp apart)
INV255 = float(np.float32(1.0 / 255.0))


def scale_images(imgs: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 RGB ``[B, H, W, 3]`` -> ``[B, 3, H, W]`` channels-last in
    ``dtype``: times float32(1/255) in float32, then cast."""
    return imgs.float().mul_(INV255).to(dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def to_device(batch, device, dtype: torch.dtype, imgs: torch.Tensor = None):
    """A numpy batch (``imgs [B, H, W, 3]``: float in [0, 1] or uint8 RGB,
    ``gt_boxes [B, G, 5]``, ``gt_classes [B, G]``, ``gt_mask [B, G]``, real
    gts first) -> tensors on ``device``: images ``[B, 3, H, W]``
    channels-last in ``dtype``. ``imgs``, when given, replaces the batch's
    images (a uint8 batch already on the device). Nothing waits for the
    copies.

    When every image has at most 64 real gts, only the first 64 gt columns
    go to the device: the JAX step's ``lax.cond`` gt tier, decided here once
    on the host, so the step never syncs to decide it.
    """
    g = batch["gt_mask"].shape[1]
    k = GT_TIER if g > GT_TIER and batch["gt_mask"].sum(1).max() <= GT_TIER else g
    if imgs is None:
        imgs = torch.from_numpy(np.ascontiguousarray(batch["imgs"]))
    imgs = imgs.to(device, non_blocking=True)
    if imgs.dtype == torch.uint8:
        imgs = scale_images(imgs, dtype)
    else:
        imgs = imgs.permute(0, 3, 1, 2).to(dtype=dtype).contiguous(
            memory_format=torch.channels_last)

    def put(key, np_dtype):
        a = np.ascontiguousarray(batch[key][:, :k], np_dtype)
        return torch.from_numpy(a).to(device, non_blocking=True)

    return {"imgs": imgs, "gt_boxes": put("gt_boxes", np.float32),
            "gt_classes": put("gt_classes", np.int64), "gt_mask": put("gt_mask", bool)}


def train_step(model: nn.Module, optimizer: Optimizer, ema: ModelEMA, batch,
               cfg: ModelConfig = ModelConfig()) -> torch.Tensor:
    """One update of ``model`` (in train mode) on a device batch from
    :func:`to_device`; returns the loss items ``[4]`` (fam_cls, fam_reg,
    odm_cls, odm_reg) on the device, without waiting for them."""
    imgs = batch["imgs"]
    out = model(imgs)
    total, items = compute_s2anet_loss(
        out, batch["gt_boxes"], batch["gt_classes"], batch["gt_mask"],
        imgs_size=tuple(imgs.shape[-2:]), num_classes=cfg.num_classes,
        fl_gamma=cfg.fl_gamma, fl_alpha=cfg.fl_alpha,
        smooth_beta=cfg.smooth_beta, odm_balance=cfg.odm_balance,
        reg_balance=cfg.reg_balance, fpn_balance=tuple(cfg.fpn_balance))
    optimizer.zero_grad()
    total.backward()
    optimizer.step()
    if optimizer.synced:
        ema.update(model, optimizer.count)
    return items.detach()
