"""Profiling: named spans at the port's layer boundaries and a Chrome trace
of a window.

Counterpart of ``s2anet_tpu/utils/profiler.py``:

* :func:`span` -- a named ``torch.profiler`` range (``s2anet.forward``,
  ``s2anet.train.backward``, ``s2anet.pipeline.wait_device``, ...) that is
  recorded only while a profiler records, so it lands in the same trace as
  the kernels and runtime calls, on one clock; otherwise it costs one flag
  check. Given a dict, it also adds the block's host seconds to one of its
  keys;
* :func:`trace` -- ``torch.profiler`` over a window, CPU and (where a card
  is present) CUDA activity, written as a Chrome trace under ``log_dir``
  (``python -m s2anet_tpu_torch.tools.profile_report`` reads it, spans
  included); call ``prof.step()`` between steps to mark them.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from pathlib import Path
from typing import Optional

import torch
from torch.profiler import ProfilerAction, ProfilerActivity, profile, record_function

_NO_SPAN = contextlib.nullcontext()


def span(name: str, seconds: Optional[dict] = None, key: str = ""):
    """``with span(name):`` records the block as the range ``name`` while a
    profiler is recording, and not while the code is being compiled or
    exported (the range would be a node of the graph); otherwise it enters
    nothing. With ``seconds``, the block's host seconds are also added to
    ``seconds[key]``, recorded or not."""
    recording = torch.autograd._profiler_enabled() and not torch.compiler.is_compiling()
    ctx = record_function(name) if recording else _NO_SPAN
    return ctx if seconds is None else _timed(ctx, seconds, key)


@contextlib.contextmanager
def _timed(ctx, seconds: dict, key: str):
    t0 = time.perf_counter()
    with ctx:
        yield
    seconds[key] += time.perf_counter() - t0


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
