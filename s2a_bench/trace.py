"""A profiled stretch of steps, read back as a timeline.

:func:`profile` runs ``n`` steps under ``torch.profiler`` (CPU and CUDA),
writes the Chrome trace to a file of ``TMPDIR``, reads it and deletes it.
The stretch is the host span ``s2a_bench.stretch`` around the steps, which
ends in a synchronise; device events are kernels, copies and memsets.
:class:`Timeline` answers the readers: busy time (the union of device
intervals inside the stretch), kernels by name, the grouping of
``tools/profile_report.py`` (copied: hand kernels, convolutions and GEMMs,
reductions, copies, elementwise, other), and the idle gaps named by what
the host was doing at their middle.
"""

from __future__ import annotations

import collections
import json
import os
import re
import tempfile

import torch

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
STRETCH = "s2a_bench.stretch"

HAND_KERNELS = (
    "deform_fwd_bf16_sm90", "deform_fwd_f32", "deform_bwd_dx_bf16_sm90",
    "deform_bwd_dw_bf16_sm90", "deform_bwd_finish_bf16", "deform_bwd_dx_f32",
    "deform_bwd_dw_f32", "box_iou_rotated_kernel", "nms_mask_kernel",
    "nms_sweep_kernel", "channel_sums", "bn_apply", "bn_dx", "bn_apply_finish",
    "bn_dx_finish", "int8_conv_sm90", "quantize_act_kernel",
)
HAND, CONV, REDUCE, COPY, ELEMENTWISE, OTHER = (
    "hand", "conv_gemm", "reduce", "copy", "elementwise", "other")
_HAND_RE = re.compile(r"\b(" + "|".join(HAND_KERNELS) + r")\b")
_CONV_KEYS = ("conv", "gemm", "xmma", "cutlass", "cudnn", "wgrad", "dgrad", "implicit")
_COPY_KEYS = ("memcpy", "memset", "copy", "catarray", "nchwtonhwc", "nhwctonchw", "transpose")


def category(name: str, cat: str = "kernel") -> str:
    if cat in ("gpu_memcpy", "gpu_memset"):
        return COPY
    if _HAND_RE.search(name):
        return HAND
    low = name.lower()
    if any(k in low for k in _COPY_KEYS):
        return COPY
    if any(k in low for k in _CONV_KEYS):
        return CONV
    if "reduce" in low:
        return REDUCE
    if "elementwise" in low:
        return ELEMENTWISE
    return OTHER


def short_name(name: str) -> str:
    return name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0][:120]


class Timeline:
    """Events of one profiled stretch of ``steps`` steps (microseconds)."""

    def __init__(self, events: list, steps: int):
        self.steps = steps
        span = [e for e in events if e["cat"] == "user_annotation" and e["name"] == STRETCH]
        if not span:
            raise RuntimeError("the profiler recorded no stretch span")
        self.t0 = span[0]["ts"]
        self.t1 = span[0]["ts"] + span[0]["dur"]
        self.main_tid = span[0]["tid"]
        inside = [e for e in events if e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0]
        self.device = [e for e in inside if e["cat"] in DEVICE_CATS]
        self.host = [e for e in inside if e["cat"] in HOST_CATS and e["tid"] == self.main_tid
                     and e["name"] != STRETCH]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def intervals(self):
        """Merged device intervals, clipped to the stretch."""
        iv = sorted((max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1)) for e in self.device)
        merged = []
        for a, b in iv:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals()) / 1e6

    def kernels(self):
        return [e for e in self.device if e["cat"] == "kernel"]

    def device_ms(self, pattern: str) -> float:
        """Device milliseconds a step of the kernels whose name matches."""
        rx = re.compile(pattern)
        return sum(e["dur"] for e in self.kernels() if rx.search(e["name"])) / 1e3 / self.steps

    def category_ms(self, cat: str) -> float:
        return sum(e["dur"] for e in self.device
                   if category(e["name"], e["cat"]) == cat) / 1e3 / self.steps

    def gaps(self):
        """``[(name, seconds)]`` of every idle stretch of the device."""
        out, last = [], self.t0
        for a, b in self.intervals() + [[self.t1, self.t1]]:
            if a > last:
                out.append((self._host_at((a + last) / 2), (a - last) / 1e6))
            last = max(last, b)
        return out

    def _host_at(self, t: float) -> str:
        active = [e for e in self.host if e["ts"] <= t <= e["ts"] + e["dur"]]
        spans = [e for e in active if e["cat"] == "user_annotation"]
        ops = [e for e in active if e["cat"] != "user_annotation"]
        span = min(spans, key=lambda e: e["dur"])["name"] if spans else "harness"
        op = min(ops, key=lambda e: e["dur"])["name"] if ops else "python"
        return f"{span}: {op}"

    def breakdown(self) -> dict:
        by_op = collections.Counter()
        for e in self.device:
            by_op[short_name(e["name"])] += e["dur"] / 1e6
        by_gap = collections.Counter()
        for name, s in self.gaps():
            by_gap[name] += s
        return {"device_ops": [[k, v] for k, v in by_op.most_common(10)],
                "idle_gaps": [[k, v] for k, v in by_gap.most_common(10)]}


def _events(path: str) -> list:
    with open(path) as f:
        data = json.load(f)
    raw = data["traceEvents"] if isinstance(data, dict) else data
    out = []
    for e in raw:
        if e.get("ph") != "X":
            continue
        out.append({"name": str(e.get("name", "")), "cat": str(e.get("cat", "")).lower(),
                    "ts": float(e["ts"]), "dur": float(e.get("dur", 0)), "tid": e.get("tid")})
    return out


def profile(step, n: int) -> Timeline:
    """Run ``step(i)`` for ``i < n`` under the profiler; the stretch ends
    in a synchronise."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(STRETCH):
            for i in range(n):
                step(i)
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return Timeline(_events(path), n)
    finally:
        os.unlink(path)
