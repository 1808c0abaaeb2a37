"""Train S2ANet: ``python -m s2anet_tpu_torch.train``.

**Training** (``--config`` and/or ``--data-root``): the counterpart of the
repository's ``train.py``, with its flags (``--config``, ``--data-root``,
``--val-root``, ``--backbone``, ``--num-classes``, ``--epochs``,
``--batch-size``, ``--img-size``, ``--lr0``, ``--lr-schedule``,
``--dtype``, ``--seed``, ``--save-dir``, ``--resume``, ``--noval``,
``--pretrained``, ``--nbs``, ``--noplots``, ``--cache`` ('' or packed),
``--workers``) and ``--device``.
A flag that is not typed leaves the config file's value
(:func:`..config.prune_overrides`); a new run's ``--save-dir`` is
incremented (runs/train/exp -> exp2) unless resuming. It runs
:class:`.trainer.Trainer` and ends with a JSON line: epochs, steps, the
last row's metrics, the epoch loop's ms/step (to the device's end,
validation apart), the host's wait for the loader per step, the last
validation's seconds and peak device memory.

    python -m s2anet_tpu_torch.train --config configs/synth_accept.yaml \
        --data-root DIR/train/images --val-root DIR/val/images --save-dir runs/accept
    python -m s2anet_tpu_torch.train --config CFG --data-root ... --val-root ... \
        --save-dir runs/accept --resume runs/accept/weights/last

**Bench** (``--synthetic N``, the default without ``--config`` and
``--data-root``): the train step as ``tools/train_bench.py`` drives it:
forward in train mode, assignment, loss,
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

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig, load_config, prune_overrides
from ..models.detector import S2ANet
from ..ops.deform_conv import DEFORM_BWD, DEFORM_FWD
from ..ops.iou_rotated import BOX_IOU
from ..ops.moments import APPLY, DX, MOMENTS, PAIR
from ..ops.nms_rotated import NMS_MASK, NMS_SWEEP
from .checkpoint import increment_path
from .optim import Optimizer
from .schedule import build_lr_schedule
from .state import ModelEMA
from .step import to_device, train_step
from .trainer import Trainer

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


BENCH_DEFAULTS = dict(backbone="resnet50", img_size=1024, batch_size=8,
                      dtype="bfloat16", seed=0, synthetic=4)


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="", help="yaml config path")
    p.add_argument("--data-root", default="", help="train images dir or list txt")
    p.add_argument("--val-root", default="", help="val images dir or list txt")
    # config-mirroring flags default to None: an untyped flag never replaces
    # a --config value
    p.add_argument("--backbone", default=None)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--img-size", type=int, default=None)
    p.add_argument("--lr0", type=float, default=None)
    p.add_argument("--lr-schedule", default=None, choices=["step", "cosine", "linear"])
    p.add_argument("--dtype", choices=sorted(_DTYPES), default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--save-dir", default=None)
    p.add_argument("--resume", default="", help="checkpoint to resume from")
    p.add_argument("--noval", action="store_true")
    p.add_argument("--pretrained", default=None,
                   help="torchvision ResNet state dict path, or 'auto' (torch hub cache)")
    p.add_argument("--nbs", type=int, default=None,
                   help="nominal batch size for gradient accumulation (0 = off)")
    p.add_argument("--noplots", action="store_true")
    p.add_argument("--cache", default=None, choices=["", "packed"],
                   help="image source: '' = BGR .npy sidecars, packed = images.pack.bin")
    p.add_argument("--workers", type=int, default=None, help="loader threads (0 = auto)")
    p.add_argument("--device", default="cuda")
    # the bench (no --config, no --data-root)
    p.add_argument("--steps", type=int, default=10, help="bench: timed steps")
    p.add_argument("--warmup", type=int, default=1,
                   help="bench: steps before the timed ones")
    p.add_argument("--clamp", type=float, default=6.0,
                   help="bench: align_offset_clamp (configs/dota_r50.yaml: 6.0)")
    p.add_argument("--synthetic", type=int, default=None,
                   help="bench: distinct synthetic batches, used in turn (default 4)")
    p.add_argument("--save", default="", help="bench: write the EMA state_dict here")
    opt = p.parse_args(argv)
    opt.bench = not (opt.config or opt.data_root)
    if opt.bench:
        for k, v in BENCH_DEFAULTS.items():
            if getattr(opt, k) is None:
                setattr(opt, k, v)
    elif opt.synthetic is not None:
        p.error("--synthetic is the bench: give it without --config and --data-root")
    return opt


def make_config(opt):
    """The run's :class:`..config.Config`: the file, then the typed flags."""
    overrides = prune_overrides({
        "model": {"backbone": opt.backbone, "num_classes": opt.num_classes},
        "data": {"root": opt.data_root or None, "train_list": opt.data_root or None,
                 "val_list": opt.val_root or None, "img_size": opt.img_size,
                 "cache": opt.cache, "workers": opt.workers},
        "train": {"epochs": opt.epochs, "batch_size": opt.batch_size, "lr0": opt.lr0,
                  "lr_schedule": opt.lr_schedule, "dtype": opt.dtype, "seed": opt.seed,
                  "save_dir": opt.save_dir,
                  "val_every_epoch": False if opt.noval else None,
                  "pretrained": opt.pretrained, "nominal_batch_size": opt.nbs,
                  "plots": False if opt.noplots else None},
    })
    cfg = load_config(opt.config or None, overrides)
    if not opt.resume:  # a new run never writes into an existing run dir
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, save_dir=increment_path(cfg.train.save_dir)))
    return cfg


def run_training(opt, callbacks=None) -> dict:
    cfg = make_config(opt)
    device = torch.device(opt.device)
    cuda = device.type == "cuda"
    trainer = Trainer(cfg, callbacks, device=opt.device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    trainer.train(resume=opt.resume or None)
    with open(trainer.save_dir / "results.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    t = trainer.timing
    steps = max(t["steps"], 1)
    summary = {
        "save_dir": str(trainer.save_dir), "epochs": len(rows),
        "steps": t["steps"], "updates": trainer.optimizer.count,
        "last": {k: float(v) for k, v in rows[-1].items() if v} if rows else {},
        "ms_per_step": 1000 * t["loop"] / steps,
        "loader_wait_ms_per_step": 1000 * t["loader_wait"] / steps,
        "val_seconds": getattr(trainer, "val_seconds", None),
        "peak_memory_gib": torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None,
        "device": str(device),
    }
    print(json.dumps(summary))
    return summary


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


def main(argv=None, callbacks=None) -> dict:
    """Train (or bench, see the module docstring); returns the summary
    printed as the last line. ``callbacks`` (a :class:`..utils.callbacks.
    Callbacks`) reach the trainer's hooks."""
    opt = parse_opt(argv)
    if not opt.bench:
        return run_training(opt, callbacks)
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
