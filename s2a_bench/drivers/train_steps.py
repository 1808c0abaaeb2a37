"""Training steps, as ``python -m s2anet_tpu_torch.train`` takes them: the
program's ``train/step.py::train_step`` (forward in train mode, the
assigner, the loss, backward, clipping, SGD and the EMA) on the model,
optimizer and EMA built as ``train/__main__.py::setup`` builds them, fed
batches from a pool of seeded batches in pinned host memory through
``train/step.py::to_device`` (uint8 images copied and scaled on the card).

Set-up drives that one object through its first three steps, on three
different batches, through the same call and feed as the window; the
reference follows those three steps (``compare.train_readings``). The
window then goes on with the same object.

Traffic parameters (``traffic/<mix>.json``): ``pool`` (batches),
``gt_counts`` (the fixed list of ground-truth counts an image; the seed
draws which image gets which, and each box's place, size, angle and
class), ``one_large_per_batch`` (the largest counts spread one to a
batch), ``box`` (the long side's range in pixels at 1024, the short
side's share of it) and ``profile_steps``.

End-to-end: ``train_img_per_s`` (images of the steps completed in the
window over its seconds; the window ends in a synchronise) and
``setup_s``.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from .. import compare, roofline, trace, weights
from ..flops import reference_flops

CHECKED_STEPS = 3


def gt_batches(cfg: dict, traffic: dict, seed: int) -> list:
    """The pool's ground truth: ``[{gt_boxes [B, G, 5], gt_classes [B, G],
    gt_mask [B, G]}]`` (NumPy), real rows first."""
    b, size = cfg["train"]["batch_size"], cfg["data"]["img_size"]
    g, nc = cfg["data"]["max_gt"], cfg["model"]["num_classes"]
    n = traffic["pool"]
    counts = np.array(traffic["gt_counts"], np.int64)
    if len(counts) != n * b:
        raise ValueError(f"gt_counts has {len(counts)} entries, the pool {n * b} images")
    rng = np.random.default_rng(seed)
    if traffic.get("one_large_per_batch"):
        order = np.argsort(-counts, kind="stable")
        large, rest = counts[order[:n]], counts[order[n:]]
        rest = rng.permutation(rest).reshape(n, b - 1)
        per = np.concatenate([rng.permutation(large)[:, None], rest], 1)
        per = np.stack([rng.permutation(r) for r in per])
    else:
        per = rng.permutation(counts).reshape(n, b)
    scale = size / 1024.0
    lo, hi = traffic["box"]["long_px"]
    s_lo, s_hi = traffic["box"]["short_share"]
    out = []
    for k in range(n):
        boxes = np.zeros((b, g, 5), np.float32)
        classes = np.zeros((b, g), np.int64)
        mask = np.zeros((b, g), bool)
        for j in range(b):
            m = int(per[k, j])
            w = rng.uniform(lo, hi, m) * scale
            boxes[j, :m, 2] = w
            boxes[j, :m, 3] = w * rng.uniform(s_lo, s_hi, m)
            boxes[j, :m, 0] = rng.uniform(0.05 * size, 0.95 * size, m)
            boxes[j, :m, 1] = rng.uniform(0.05 * size, 0.95 * size, m)
            boxes[j, :m, 4] = rng.uniform(-math.pi / 4, 3 * math.pi / 4, m)
            classes[j, :m] = rng.integers(0, nc, m)
            mask[j, :m] = True
        out.append({"gt_boxes": boxes, "gt_classes": classes, "gt_mask": mask})
    return out


def make_images(cfg: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """``[pool, B, S, S, 3]`` uint8 on the device."""
    from ..images import square_chips
    b, size, n = cfg["train"]["batch_size"], cfg["data"]["img_size"], traffic["pool"]
    gen = torch.Generator(device=device).manual_seed((seed * 7919 + 2) % (1 << 63))
    return square_chips(n * b, size, gen, device).view(n, b, size, size, 3)


def build(cfg: dict, state_dict: dict, device, mark=lambda phase: None):
    """Model, optimizer and EMA as ``train/__main__.py::setup`` builds them,
    on the seeded weights."""
    from s2anet_tpu_torch.config import ModelConfig
    from s2anet_tpu_torch.models.detector import S2ANet
    from s2anet_tpu_torch.train.optim import Optimizer, freeze_stages
    from s2anet_tpu_torch.train.schedule import build_lr_schedule
    from s2anet_tpu_torch.train.state import ModelEMA
    fields = ModelConfig.__dataclass_fields__
    mc = ModelConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                        for k, v in cfg["model"].items() if k in fields})
    tc = cfg["train"]
    model = S2ANet.from_config(mc)
    mark("model_built")
    model.load_state_dict({k: v.cpu() for k, v in state_dict.items()})
    mark("model_loaded")
    model = model.to(device).channels_last().train()
    freeze_stages(model, mc.frozen_stages)
    mark("model_on_device")
    spe = cfg["assumed"]["steps_per_epoch"]
    lr_fn = build_lr_schedule(tc["lr0"], tc["epochs"] * spe, spe, tc["lr_schedule"],
                              tuple(tc["lr_decay_epochs"]), tc["lr_decay_factor"], tc["lrf"],
                              tc["warmup_iters"], tc["warmup_init_factor"])
    optimizer = Optimizer(model, lr_fn, tc["momentum"], tc["weight_decay"], tc["grad_clip_norm"])
    ema = ModelEMA(model, tc["ema_decay"], tc["ema_ramp_updates"])
    return mc, model, optimizer, ema


def leaf_norms(model, optimizer, start: dict):
    """Per parameter name: the norm of its momentum buffer (after one step:
    the first update direction) and of its move from ``start``."""
    names = {id(p): n for n, p in model.named_parameters()}
    first, change = {}, {}
    for p in optimizer.params:
        buf = optimizer.sgd.state.get(p, {}).get("momentum_buffer")
        n = names[id(p)]
        first[n] = buf.float().norm() if buf is not None else torch.zeros((), device=p.device)
        change[n] = (p.detach().float() - start[n].to(p.device)).norm()
    return first, change


def run(run, fault=None) -> None:
    cell, device, seed = run.cell, run.device, run.seed
    cfg, traffic = cell.config, cell.traffic
    from s2anet_tpu_torch.train.step import to_device, train_step

    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    dtype = getattr(torch, cfg["train"]["dtype"])
    run.mark("imports")
    sd = weights.make_state_dict(cfg["model"], cfg["init"], seed, device)
    run.mark("weights")
    mc, model, optimizer, ema = build(cfg, sd, device, run.mark)
    run.mark("model")
    gts = gt_batches(cfg, traffic, seed)
    imgs_dev = make_images(cfg, traffic, seed, device)
    imgs = imgs_dev.cpu().pin_memory() if device.type == "cuda" else imgs_dev.cpu()
    del imgs_dev
    run.mark("inputs")
    step_fn = train_step if fault is None else fault(train_step)
    n_pool = traffic["pool"]
    enqueue = []

    def step(i: int):
        t0 = time.perf_counter()
        with torch.profiler.record_function("s2a_bench.train_step"):
            batch = to_device(gts[i % n_pool], device, dtype, imgs=imgs[i % n_pool])
            items = step_fn(model, optimizer, ema, batch, mc)
        enqueue.append(time.perf_counter() - t0)
        return items

    # set-up: the first steps, which the reference follows, warm every shape
    items, first, change = [], None, None
    for i in range(CHECKED_STEPS):
        items.append(step(i))
        if i == 0:
            first, _ = leaf_norms(model, optimizer, sd)
            if device.type == "cuda":
                torch.cuda.synchronize()
            run.mark("first_step")
    _, change = leaf_norms(model, optimizer, sd)
    prog = {"items": torch.stack(items).cpu().numpy(),
            "first": {k: float(v) for k, v in first.items()},
            "change": {k: float(v) for k, v in change.items()}}
    del sd
    if device.type == "cuda":
        torch.cuda.synchronize()
    enqueue.clear()
    run.mark_setup_done()

    t0 = time.perf_counter()
    i = CHECKED_STEPS
    while time.perf_counter() - t0 < run.seconds:
        step(i)
        i += 1
    if device.type == "cuda":
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    run.mark("window")
    steps = i - CHECKED_STEPS
    b = cfg["train"]["batch_size"]
    run.attempted = steps
    run.metrics["train_img_per_s"] = steps * b / window
    run.metrics["setup_s"] = run.setup_s
    enq = list(enqueue)
    if run.trace:
        n_prof = traffic["profile_steps"]
        run.timeline = trace.profile(lambda k: step(i + k), n_prof)
    if device.type == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated(device)
    run.layer.update(rate=run.metrics["train_img_per_s"], enqueue_ms=1e3 * float(np.mean(enq)),
                     batch=b, window_steps=steps)
    del model, optimizer, ema, step_fn
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    sd = weights.make_state_dict(cfg["model"], cfg["init"], seed, device)
    torch.backends.cudnn.benchmark = False  # the reference runs each shape once
    checked = [dict(gts[k], imgs=imgs[k]) for k in range(CHECKED_STEPS)]
    t_check = time.perf_counter()
    run.readings = compare.train_readings(cfg, sd, checked, prog, device)
    run.readings["check_s"] = time.perf_counter() - t_check
    run.mark("check")
    if run.trace:
        _layer_inputs(run, cfg)
        run.mark("layer_inputs")


def _layer_inputs(run, cfg) -> None:
    """FLOPs an image (three times the training forward: the backward is
    taken as twice the forward), the AlignConv backward's and the BN
    kernels' bounds a step."""
    size, b = cfg["data"]["img_size"], cfg["train"]["batch_size"]
    mc = cfg["model"]
    run.layer["flops_per_item"] = 3 * reference_flops(mc, 1, size, size, train=True)
    run.layer["peak_flop_s"] = roofline.PEAK_FLOP_S[cfg["train"]["dtype"]]
    lv = roofline.level_sizes(size, size, mc["strides"])
    run.layer["align_bwd_bound_s"] = roofline.bound_s(*roofline.align_bwd(b, lv),
                                                      roofline.BF16_FLOP_S)
    nbytes = roofline.bn_train_bytes(roofline.bn_shapes(mc["backbone"], b, size, size))
    run.layer["bn_bound_s"] = roofline.bound_s(nbytes, 0, roofline.BF16_FLOP_S)
