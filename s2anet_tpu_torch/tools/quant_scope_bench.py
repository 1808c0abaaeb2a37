"""int8 serving rate by quantisation scope: ``python -m
s2anet_tpu_torch.tools.quant_scope_bench``.

The counterpart of the repository's ``tools/quant_scope_bench.py``. It
takes the float serving rate once, then the int8 rate of each scope set
(``--scopes``: semicolon-separated comma lists of ``backbone``, ``neck``,
``head_stacks``, ``orconv``, ``heads``), all through
:class:`..predict.S2ANetPredictor` (forward, decode and NMS; bf16, BatchNorm
folded unless ``--no-fold``, random weights from seed 0) on a batch staged
on the device. Each int8 predictor is calibrated on that batch first, as
the JAX tool calibrates on its first batch. The variants are timed in
turns, ``--reps`` rounds of each, every round ``ITERS`` batches between
two CUDA events (the host clock on the CPU, where the numbers are CPU
numbers); the median round gives chips/s, with the rounds' spread.

The JAX tool's ``--forms`` (two int8 formulations of its padding) is left
out: the port has one int8 form, ``csrc/int8_conv.cu`` with the zero point
patched into the padding.

Usage: ``python -m s2anet_tpu_torch.tools.quant_scope_bench`` on the card
(R-50, 1024^2, batch 8); ``--device cpu --backbone resnet18 --size 64
--batch 2`` here.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..config import ModelConfig
from ..models.head import s2anet_get_bboxes
from ..ops.quant import CONV, QUANTIZE
from ..predict import S2ANetPredictor
from ..utils.profiler import median_spread

DEFAULT_SCOPES = [
    "backbone,neck,head_stacks",
    "backbone,neck,head_stacks,orconv",
    "backbone,neck,head_stacks,heads",
    "backbone,neck,head_stacks,orconv,heads",
    "backbone,neck",
]
ITERS = 3  # batches in a timed round


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--scopes", default=";".join(DEFAULT_SCOPES),
                   help="semicolon-separated scope sets (each a comma list)")
    p.add_argument("--skip-float", action="store_true",
                   help="no float rate (rates below are absolute chips/s)")
    p.add_argument("--no-fold", action="store_true",
                   help="keep BatchNorm unfolded (serving folds by default)")
    p.add_argument("--reps", type=int, default=3, help="timed rounds of each variant")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _timer(device: torch.device):
    """``time(fn, n) -> seconds`` of n calls: CUDA events on the card, the
    host clock on the CPU."""
    if device.type == "cuda":
        def time_cuda(fn, n):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1000
        return time_cuda

    def time_host(fn, n):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return time.perf_counter() - t0
    return time_host


def main(argv=None) -> list:
    opt = parse_opt(argv)
    base = ModelConfig(backbone=opt.backbone, fold_bn=not opt.no_fold)
    imgs = np.random.default_rng(0).integers(0, 256, (opt.batch, opt.size, opt.size, 3),
                                             dtype=np.uint8)
    variants = {} if opt.skip_float else {"float": S2ANetPredictor(base, device=opt.device)}
    for scope in filter(None, (s.strip() for s in opt.scopes.split(";"))):
        cfg = ModelConfig(backbone=opt.backbone, fold_bn=not opt.no_fold, quant="int8",
                          quant_scope=tuple(g.strip() for g in scope.split(",") if g.strip()))
        pred = S2ANetPredictor(cfg, device=opt.device)
        pred.calibrate([imgs])
        variants[scope] = pred
    device = next(iter(variants.values())).device
    timer = _timer(device)
    inputs = {name: p.to_input(imgs) for name, p in variants.items()}

    def batch(name):
        p = variants[name]
        return s2anet_get_bboxes(p.forward(inputs[name]), **p.post_kwargs())

    launches = {}
    for name in variants:  # warm-up (kernel builds, cuDNN), and int8 launches a batch
        before = (QUANTIZE.launches, CONV.launches)
        batch(name)
        launches[name] = (QUANTIZE.launches - before[0], CONV.launches - before[1])
    rounds = {name: [] for name in variants}
    for _ in range(opt.reps):
        for name in variants:
            rounds[name].append(ITERS * opt.batch / timer(lambda n=name: batch(n), ITERS))
    rows = []
    clock = "CUDA events" if device.type == "cuda" else "host clock, CPU"
    float_rate = median_spread(rounds["float"])[0] if "float" in rounds else None
    for name, rates in rounds.items():
        rate, spread = median_spread(rates)
        rel = f" ({rate / float_rate:.2f}x float)" if float_rate and name != "float" else ""
        q, c = launches[name]
        label = "float" if name == "float" else f"int8 [{name}]"
        print(f"{label}: {rate:.2f} chips/s{rel}, spread {spread:.1%} over {opt.reps} rounds "
              f"({clock}); quantiser / int8 conv launches a batch {q} / {c}", flush=True)
        rows.append({"scope": name, "chips_per_s": rate, "spread": spread,
                     "quantize_launches": q, "conv_launches": c})
    return rows


if __name__ == "__main__":
    main()
