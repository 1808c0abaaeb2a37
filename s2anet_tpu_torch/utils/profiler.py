"""Profiling and timing: a Chrome trace of a window, a timed op and named
wall-clock stages.

Counterpart of ``s2anet_tpu/utils/profiler.py``:

* :func:`trace` -- ``torch.profiler`` over a window, CPU and (where a card
  is present) CUDA activity, written as a Chrome trace under ``log_dir``
  (``python -m s2anet_tpu_torch.tools.profile_report`` reads it); call
  ``prof.step()`` between steps to mark them;
* :func:`profile_op` -- a function on the card timed with CUDA events after
  a warm-up: the median of ``repeats`` loops with its spread, and TFLOP/s
  when its FLOPs are given (``utils/flops.py`` counts them);
* :class:`StepTimer` -- named wall-clock stages with exponential smoothing,
  as the JAX class.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from pathlib import Path
from typing import Callable, Optional

import torch
from torch.profiler import ProfilerAction, ProfilerActivity, profile


def median_spread(values) -> tuple:
    """``(median, (max - min) / median)`` of timings."""
    m = statistics.median(values)
    return m, ((max(values) - min(values)) / m if m else 0.0)


def _record_every_step(step: int) -> ProfilerAction:
    return ProfilerAction.RECORD


@contextlib.contextmanager
def trace(log_dir, name: str = "trace"):
    """``with trace(log_dir) as prof:`` profiles the block and writes
    ``<log_dir>/<name>_<time ns>.pt.trace.json`` (Chrome trace format, for
    Perfetto or ``chrome://tracing``). The device's activity is recorded
    where a card is present. Yields the ``torch.profiler.profile``; its
    ``step()`` marks a step (``ProfilerStep#N`` ranges in the trace)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    # a schedule that records every step: with none, step() marks nothing
    with profile(activities=activities, schedule=_record_every_step) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"{name}_{time.time_ns()}.pt.trace.json"))


def profile_op(fn: Callable, *args, flops: Optional[float] = None, iters: int = 10,
               warmup: int = 3, repeats: int = 5) -> dict:
    """Time ``fn(*args)`` on the card: ``warmup`` calls (first-call builds
    and autotuning), then ``repeats`` loops of ``iters`` calls between two
    CUDA events. Returns ``ms`` (the median per call), ``spread`` ((max -
    min) / median over the loops), ``first_ms`` (the first call, host
    clock to the device's end) and, given ``flops`` per call,
    ``tflops``."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_op times on a CUDA device; there is none")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1000
    for _ in range(warmup - 1):
        fn(*args)
    per_call = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    ms, spread = median_spread(per_call)
    out = {"ms": ms, "spread": spread, "first_ms": first_ms}
    if flops:
        out["tflops"] = flops / (ms / 1000) / 1e12
    return out


class StepTimer:
    """Named wall-clock stages with EMA smoothing for progress lines."""

    def __init__(self, smooth: float = 0.9):
        self.smooth = smooth
        self.avg: dict = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        prev = self.avg.get(name)
        self.avg[name] = dt if prev is None else self.smooth * prev + (1 - self.smooth) * dt

    def summary(self) -> str:
        return " ".join(f"{k}={v * 1000:.0f}ms" for k, v in self.avg.items())
