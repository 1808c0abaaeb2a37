"""One training step on one device.

Counterpart of ``s2anet_tpu/parallel/step.py::make_train_step``: forward
in train mode, assignment and loss, backward, clipping, SGD and the EMA
(one micro-step under gradient accumulation: the EMA moves only when the
optimizer updates). The step waits for the device only where the head's
ORConv copies its ARF gather index from pageable host memory, once a
level (``ops/orn.py::rotate_arf``; a profiler counts five
``cudaStreamSynchronize`` a step inside ``s2anet.head``): the loss
normalisation stays on the device, and the one data-dependent choice of
the JAX step (the gt tier of 64) is made on the host from the batch's
numpy mask by :func:`to_device` (in a data-parallel group, per rank: it
only drops padding columns).

Under a profiler the feed is the span ``s2anet.train.feed`` and the step
``s2anet.train.step``, holding ``s2anet.forward``, ``s2anet.train.loss``
(with ``s2anet.train.assign``), ``s2anet.train.backward`` and
``s2anet.train.update`` (with ``s2anet.train.ema``).

In a process group of more than one rank (``parallel/mesh.py``) the batch
is this rank's slice of the global batch; the BatchNorms and the loss
count over the global batch, and ``parallel/step.py`` sums the gradient
and the loss items over the ranks before the update, the JAX step with a
mesh.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from ..models.head import compute_s2anet_loss
from ..parallel.mesh import world_size
from ..parallel.step import sum_over_ranks
from ..utils.profiler import span
from .optim import Optimizer
from .state import ModelEMA

GT_TIER = 64
# the JAX loader's scale (``rgb *= 1.0 / 255.0`` on a float32 array): a
# product by this float32 constant, not a division by 255 (1 ulp apart)
INV255 = float(np.float32(1.0 / 255.0))


def scale_images(imgs: torch.Tensor, dtype: torch.dtype, divide: bool = False) -> torch.Tensor:
    """uint8 RGB ``[B, H, W, 3]`` -> ``[B, 3, H, W]`` channels-last in
    ``dtype``: times float32(1/255) in float32, then cast; with ``divide``,
    divided by 255 in float32 instead (the repository's ``predict.py``).
    The divisor is a tensor on the images' device: PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal."""
    x = imgs.float()
    x = x.div_(torch.full((), 255.0, device=x.device)) if divide else x.mul_(INV255)
    return x.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


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
    with span("s2anet.train.feed"):
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
    odm_cls, odm_reg) on the device, without waiting for them (those of
    the global batch in a data-parallel group)."""
    with span("s2anet.train.step"):
        distributed = world_size() > 1
        imgs = batch["imgs"]
        out = model(imgs)
        with span("s2anet.train.loss"):
            total, items = compute_s2anet_loss(
                out, batch["gt_boxes"], batch["gt_classes"], batch["gt_mask"],
                imgs_size=tuple(imgs.shape[-2:]), num_classes=cfg.num_classes,
                fl_gamma=cfg.fl_gamma, fl_alpha=cfg.fl_alpha,
                smooth_beta=cfg.smooth_beta, odm_balance=cfg.odm_balance,
                reg_balance=cfg.reg_balance, fpn_balance=tuple(cfg.fpn_balance),
                distributed=distributed)
        with span("s2anet.train.backward"):
            optimizer.zero_grad()
            total.backward()
            if distributed:  # the gradient summed over the ranks
                items = sum_over_ranks(model, optimizer.params, items)
        with span("s2anet.train.update"):
            optimizer.step()
            if optimizer.synced:
                with span("s2anet.train.ema"):
                    ema.update(model, optimizer.count)
        return items.detach()
