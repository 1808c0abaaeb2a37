"""Train S2ANet on synthetic batches: ``python -m s2anet_tpu_torch.train``.

The PyTorch/CUDA counterpart of the repository's train step as
``tools/train_bench.py`` drives it: forward in train mode, assignment, loss,
backward, clipping at 35, SGD and the EMA, on ``--synthetic N`` distinct
batches made from ``--seed`` (2-20 gt boxes per image in 64 slots, uniform
boxes and images, all of class 0; at 1024^2 the same draws as
train_bench), with random weights from ``--seed``. The optimizer and the
LR schedule take the ``TrainConfig`` defaults, an epoch being one pass over
the N batches.

Prints the four loss items and the wall time of every step, then one JSON
line: the last losses, ms/step and img/s over the steps after ``--warmup``,
peak device memory, and each CUDA kernel's launches per step. With
``--save PATH`` it writes the EMA weights as a ``state_dict`` that
``python -m s2anet_tpu_torch.predict --weights PATH`` loads.

Runs on the card unless ``--device cpu``. Not here yet: the DOTA data
pipeline, the epoch loop with validation, checkpoints and resume.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..models.detector import S2ANet
from ..ops.deform_conv import DEFORM_BWD, DEFORM_FWD
from ..ops.iou_rotated import BOX_IOU
from ..ops.moments import APPLY, DX, MOMENTS, PAIR
from ..ops.nms_rotated import NMS_MASK, NMS_SWEEP
from .optim import Optimizer
from .schedule import build_lr_schedule
from .state import ModelEMA
from .step import to_device, train_step

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
KERNELS = (DEFORM_FWD, DEFORM_BWD, BOX_IOU, NMS_MASK, NMS_SWEEP, MOMENTS, PAIR, APPLY, DX)


def synthetic_batches(n: int, batch: int, size: int, seed: int, max_gt: int = 64):
    """``n`` numpy batches; at ``size`` 1024 the draws of
    tools/train_bench.py (box bounds scale with ``size / 1024``)."""
    rng = np.random.default_rng(seed)
    f = size / 1024
    out = []
    for _ in range(n):
        gtb = np.zeros((batch, max_gt, 5), np.float32)
        gtc = np.zeros((batch, max_gt), np.int32)
        gtm = np.zeros((batch, max_gt), bool)
        for k in range(batch):
            n_gt = int(rng.integers(2, 20))
            gtb[k, :n_gt, 0] = rng.uniform(100 * f, size - 100 * f, n_gt)
            gtb[k, :n_gt, 1] = rng.uniform(100 * f, size - 100 * f, n_gt)
            gtb[k, :n_gt, 2] = rng.uniform(20 * f, 200 * f, n_gt)
            gtb[k, :n_gt, 3] = rng.uniform(10 * f, 100 * f, n_gt)
            gtb[k, :n_gt, 4] = rng.uniform(-1.5, 1.5, n_gt)
            gtm[k, :n_gt] = True
        imgs = rng.uniform(size=(batch, size, size, 3)).astype(np.float32)
        out.append({"imgs": imgs, "gt_boxes": gtb, "gt_classes": gtc,
                    "gt_mask": gtm})
    return out


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--img-size", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--steps", type=int, default=10, help="timed steps")
    p.add_argument("--warmup", type=int, default=1,
                   help="steps before the timed ones")
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="bfloat16")
    p.add_argument("--clamp", type=float, default=6.0,
                   help="align_offset_clamp (configs/dota_r50.yaml: 6.0)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", type=int, default=4,
                   help="distinct synthetic batches, used in turn")
    p.add_argument("--save", default="", help="write the EMA state_dict here")
    return p.parse_args(argv)


def setup(opt):
    """``(cfg, model, optimizer, ema, batches)`` for the parsed options: the
    seeded model in train mode on the device, channels-last, and the
    synthetic batches already there."""
    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {opt.device}: no CUDA device")
    cfg = ModelConfig(backbone=opt.backbone, align_offset_clamp=opt.clamp)
    tc = TrainConfig()
    model = S2ANet(cfg.backbone, cfg.num_classes, tuple(cfg.strides),
                   align_offset_clamp=cfg.align_offset_clamp)
    model.init_weights(torch.Generator().manual_seed(opt.seed))
    model = model.to(device).channels_last().train()
    n_batches = max(opt.synthetic, 1)
    lr_fn = build_lr_schedule(
        tc.lr0, tc.epochs * n_batches, n_batches, tc.lr_schedule,
        tuple(tc.lr_decay_epochs), tc.lr_decay_factor, tc.lrf,
        tc.warmup_iters, tc.warmup_init_factor)
    optimizer = Optimizer(model, lr_fn, tc.momentum, tc.weight_decay,
                                tc.grad_clip_norm)
    ema = ModelEMA(model, tc.ema_decay, tc.ema_ramp_updates)
    batches = [to_device(b, device, _DTYPES[opt.dtype]) for b in synthetic_batches(
        n_batches, opt.batch_size, opt.img_size, opt.seed)]
    return cfg, model, optimizer, ema, batches


def main(argv=None) -> dict:
    opt = parse_opt(argv)
    device = torch.device(opt.device)
    cuda = device.type == "cuda"
    if cuda and torch.cuda.is_available():
        torch.backends.cudnn.benchmark = True  # fixed shapes: autotune the convs
        torch.cuda.reset_peak_memory_stats(device)
    cfg, model, optimizer, ema, batches = setup(opt)
    n_batches = len(batches)

    walls, items = [], None
    counts = {}
    for i in range(opt.warmup + opt.steps):
        if i == opt.warmup:
            counts = {k.symbol: k.launches for k in KERNELS}
        t0 = time.perf_counter()
        items = train_step(model, optimizer, ema, batches[i % n_batches], cfg)
        values = items.tolist()  # waits for the step
        ms = 1000 * (time.perf_counter() - t0)
        if i >= opt.warmup:
            walls.append(ms)
        print(f"step {i}: fam_cls {values[0]:.5f} fam_reg {values[1]:.5f} "
              f"odm_cls {values[2]:.5f} odm_reg {values[3]:.5f} {ms:.1f} ms",
              flush=True)
    n_timed = max(len(walls), 1)
    ms_step = sum(walls) / n_timed if walls else None
    summary = {
        "losses": items.tolist() if items is not None else None,
        "ms_per_step": ms_step,
        "img_per_s": 1000 * opt.batch_size / ms_step if ms_step else None,
        "peak_memory_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                            if cuda else None),
        "launches_per_step": {k.symbol: (k.launches - counts.get(k.symbol, 0))
                              / n_timed for k in KERNELS},
        "steps": len(walls), "warmup": opt.warmup, "device": str(device),
        "backbone": opt.backbone, "img_size": opt.img_size,
        "batch_size": opt.batch_size, "dtype": opt.dtype,
    }
    if opt.save:
        Path(opt.save).parent.mkdir(parents=True, exist_ok=True)
        torch.save(ema.module.state_dict(), opt.save)
        summary["saved"] = opt.save
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
