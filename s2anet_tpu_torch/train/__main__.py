"""Train S2ANet: ``python -m s2anet_tpu_torch.train``.

**Training** (``--config`` and/or ``--data-root``): the counterpart of the
repository's ``train.py``, with its flags (``--config``, ``--data-root``,
``--val-root``, ``--backbone``, ``--num-classes``, ``--epochs``,
``--batch-size``, ``--img-size``, ``--lr0``, ``--lr-schedule``,
``--dtype``, ``--seed``, ``--save-dir``, ``--resume``, ``--noval``,
``--pretrained``, ``--nbs``, ``--noplots``, ``--cache`` ('' or packed),
``--workers``, ``--loader`` (thread or process)) and ``--device``.
A flag that is not typed leaves the config file's value
(:func:`..config.prune_overrides`); a new run's ``--save-dir`` is
incremented (runs/train/exp -> exp2) unless resuming. It runs
:class:`.trainer.Trainer` and ends with a JSON line: epochs, steps, the
last row's metrics, the epoch loop's ms/step (to the device's end,
validation apart; with plots, the three first batches' mosaics drawn
inside it), the host's wait for the loader per step, the last
validation's seconds, the plots' host seconds (all, and those of the
mosaics) and peak device memory.

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
the N batches. The model options ``--frozen-stages``, ``--norm-eval``,
``--bn-stats-images`` and ``--no-orconv`` set the ``ModelConfig`` fields of
those names (a training run reads them from ``--config``).

Prints the four loss items and the wall time of every step, then one JSON
line: the last losses, ms/step and img/s over the steps after ``--warmup``,
peak device memory, and each CUDA kernel's launches per step. With
``--save PATH`` it writes the EMA weights as a ``state_dict`` that
``python -m s2anet_tpu_torch.predict --weights PATH`` loads.

**Data parallel**: under ``torchrun`` every mode runs on N ranks, one
process each, ``--batch-size`` being the global batch:

    torchrun --standalone --nproc_per_node N -m s2anet_tpu_torch.train --config ...

(``python -m torch.distributed.run`` is the same launcher). Each rank joins
the process group (``parallel/mesh.py``: NCCL when each rank has a GPU of
its own, gloo when ranks share one; ``--multihost`` or
``S2A_MULTIHOST=1`` asks for the group explicitly, as the JAX
``train.py``) and computes on ``cuda:LOCAL_RANK``; rank 0 alone writes
and prints the summary. The bench steps the global batch, each rank its
slice, and reports ms/step and img/s of the global batch.

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
from ..ops.moments import APPLY, APPLY_FINISH, DX, DX_FINISH, MOMENTS, PAIR
from ..ops.nms_rotated import NMS_MASK, NMS_SWEEP
from ..parallel import mesh
from .checkpoint import increment_path
from .optim import Optimizer, freeze_stages
from .schedule import build_lr_schedule
from .state import ModelEMA
from .step import to_device, train_step
from .trainer import Trainer

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
KERNELS = (DEFORM_FWD, DEFORM_BWD, BOX_IOU, NMS_MASK, NMS_SWEEP, MOMENTS, PAIR, APPLY, DX,
           APPLY_FINISH, DX_FINISH)


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
    p.add_argument("--workers", type=int, default=None, help="loader workers (0 = auto)")
    p.add_argument("--loader", default=None, choices=["thread", "process"],
                   help="loader workers: threads, or forked processes")
    p.add_argument("--device", default="cuda")
    p.add_argument("--multihost", action="store_true",
                   help="join a process group (torchrun's environment; also "
                        "S2A_MULTIHOST=1); under torchrun with N > 1 ranks it joins anyway")
    # the bench (no --config, no --data-root)
    p.add_argument("--steps", type=int, default=10, help="bench: timed steps")
    p.add_argument("--warmup", type=int, default=1,
                   help="bench: steps before the timed ones")
    p.add_argument("--clamp", type=float, default=6.0,
                   help="bench: align_offset_clamp (configs/dota_r50.yaml: 6.0)")
    p.add_argument("--synthetic", type=int, default=None,
                   help="bench: distinct synthetic batches, used in turn (default 4)")
    p.add_argument("--save", default="", help="bench: write the EMA state_dict here")
    p.add_argument("--frozen-stages", type=int, default=None,
                   help="bench: model.frozen_stages (-1 = none frozen)")
    p.add_argument("--norm-eval", action="store_true", default=None,
                   help="bench: model.norm_eval (every BatchNorm on its running statistics)")
    p.add_argument("--bn-stats-images", type=int, default=None,
                   help="bench: model.bn_stats_images (BN statistics from the first k images)")
    p.add_argument("--no-orconv", action="store_true", default=None,
                   help="bench: model.with_orconv false (a plain or_conv)")
    opt = p.parse_args(argv)
    opt.bench = not (opt.config or opt.data_root)
    if opt.bench:
        for k, v in BENCH_DEFAULTS.items():
            if getattr(opt, k) is None:
                setattr(opt, k, v)
    else:
        for flag in ("synthetic", "frozen_stages", "norm_eval", "bn_stats_images",
                     "no_orconv"):
            if getattr(opt, flag) is not None:
                p.error(f"--{flag.replace('_', '-')} is the bench's: give it without "
                        "--config and --data-root (a training run reads the config)")
    return opt


def make_config(opt):
    """The run's :class:`..config.Config`: the file, then the typed flags."""
    overrides = prune_overrides({
        "model": {"backbone": opt.backbone, "num_classes": opt.num_classes},
        "data": {"root": opt.data_root or None, "train_list": opt.data_root or None,
                 "val_list": opt.val_root or None, "img_size": opt.img_size,
                 "cache": opt.cache, "workers": opt.workers, "loader": opt.loader},
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
    if mesh.world_size() > 1:
        # every rank has picked the run dir before rank 0 creates it
        mesh.barrier(device)
    trainer = Trainer(cfg, callbacks, device=device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    trainer.train(resume=opt.resume or None)
    if not trainer.is_main:
        return {"save_dir": str(trainer.save_dir), "rank": trainer.rank}
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
        "plots_seconds": t["plots"], "batch_plots_seconds": t["batch_plots"],
        "peak_memory_gib": torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None,
        "device": str(device), "ranks": trainer.num_processes,
    }
    print(json.dumps(summary))
    return summary


def setup(opt):
    """``(cfg, model, optimizer, ema, batches)`` for the parsed options: the
    seeded model in train mode on the device, channels-last, and the
    synthetic batches already there (this rank's slice of each global
    batch in a data-parallel group)."""
    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {opt.device}: no CUDA device")
    options = {"frozen_stages": opt.frozen_stages, "norm_eval": opt.norm_eval,
               "bn_stats_images": opt.bn_stats_images,
               "with_orconv": False if opt.no_orconv else None}
    cfg = ModelConfig(backbone=opt.backbone, align_offset_clamp=opt.clamp,
                      **{k: v for k, v in options.items() if v is not None})
    tc = TrainConfig()
    model = S2ANet.from_config(cfg)
    model.init_weights(torch.Generator().manual_seed(opt.seed))
    model = model.to(device).channels_last().train()
    freeze_stages(model, cfg.frozen_stages)
    n_batches = max(opt.synthetic, 1)
    lr_fn = build_lr_schedule(
        tc.lr0, tc.epochs * n_batches, n_batches, tc.lr_schedule,
        tuple(tc.lr_decay_epochs), tc.lr_decay_factor, tc.lrf,
        tc.warmup_iters, tc.warmup_init_factor)
    optimizer = Optimizer(model, lr_fn, tc.momentum, tc.weight_decay,
                                tc.grad_clip_norm)
    ema = ModelEMA(model, tc.ema_decay, tc.ema_ramp_updates)
    b = mesh.local_batch(opt.batch_size)
    part = slice(mesh.rank() * b, (mesh.rank() + 1) * b)
    batches = [to_device({k: v[part] for k, v in batch.items()}, device, _DTYPES[opt.dtype])
               for batch in synthetic_batches(n_batches, opt.batch_size, opt.img_size,
                                              opt.seed)]
    return cfg, model, optimizer, ema, batches


def main(argv=None, callbacks=None) -> dict:
    """Train (or bench, see the module docstring); returns the summary
    printed as the last line. ``callbacks`` (a :class:`..utils.callbacks.
    Callbacks`) reach the trainer's hooks."""
    opt = parse_opt(argv)
    ours = not torch.distributed.is_initialized()  # a group this call joins, it leaves
    opt.device = str(mesh.maybe_initialize_distributed(opt.multihost or None, opt.device))
    summary = run_training(opt, callbacks) if not opt.bench else bench(opt)
    if ours:
        mesh.shutdown()
    return summary


def bench(opt) -> dict:
    """The step bench (the module docstring); rank 0 prints."""
    say = print if mesh.is_main_process() else (lambda *a, **k: None)
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
        say(f"step {i}: fam_cls {values[0]:.5f} fam_reg {values[1]:.5f} "
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
        "batch_size": opt.batch_size, "dtype": opt.dtype, "ranks": mesh.world_size(),
    }
    if opt.save and mesh.is_main_process():
        Path(opt.save).parent.mkdir(parents=True, exist_ok=True)
        torch.save(ema.module.state_dict(), opt.save)
        summary["saved"] = opt.save
    say(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
