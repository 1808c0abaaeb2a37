"""Per-kernel device time of a profiler trace: ``python -m
s2anet_tpu_torch.tools.profile_report TRACE_DIR [--top N] [--steps S]``.

The counterpart of the repository's ``tools/xplane_report.py``, for the
Chrome traces that ``torch.profiler`` writes (``utils/profiler.py::trace``,
``prof.export_chrome_trace``). It reads the newest ``*.json`` (or
``*.json.gz``) under the directory, sums the device's events (kernels,
memcpys and memsets) by kernel name, and prints

* the device total and ms per step: the steps are the profiler's step
  markers (``ProfilerStep#N``, from ``prof.step()``) that hold an
  operator, unless ``--steps`` gives their number;
* the totals per category: the port's hand kernels (``csrc/``), cuDNN /
  cuBLAS / CUTLASS convolutions and GEMMs, reductions, copies and memsets,
  elementwise kernels, and the rest (sorts, scans, gathers);
* the top N kernels;
* the elementwise group by kernel name;
* the port's spans (``s2anet.*``, ``utils/profiler.py::span``), each with
  its host ms a step, the blocking runtime calls a step inside it
  (``cudaStreamSynchronize``, ``cudaEventSynchronize``,
  ``cudaDeviceSynchronize``, ``cudaMemcpy``) and the device's idle ms a
  step whose gap falls inside it (at the gap's middle; the trace's stretch
  runs from its first host range or device event to its last device
  event). A span's numbers hold those of the spans inside it.

Times are the trace's own (microseconds on the device's clock); nothing is
measured here.
"""

from __future__ import annotations

import argparse
import collections
import gzip
import json
import re
from pathlib import Path

# the __global__ functions of csrc/*.cu (tests/test_torch_port_profiler.py
# holds this list to the sources)
HAND_KERNELS = (
    "deform_fwd_bf16_sm90", "deform_fwd_f32", "deform_bwd_dx_bf16_sm90",
    "deform_bwd_dw_bf16_sm90", "deform_bwd_finish_bf16", "deform_bwd_dx_f32",
    "deform_bwd_dw_f32", "box_iou_rotated_kernel", "nms_mask_kernel",
    "nms_sweep_kernel", "channel_sums", "bn_apply", "bn_dx", "bn_apply_finish",
    "bn_dx_finish", "int8_conv_sm90", "quantize_act_kernel",
)
HAND = "hand kernels (csrc/)"
CONV = "convolutions and GEMMs (cuDNN, cuBLAS, CUTLASS)"
COPY = "copies and memsets"
REDUCE = "reductions"
ELEMENTWISE = "elementwise"
OTHER = "other (sort, scan, index, gather)"
CATEGORIES = (HAND, CONV, REDUCE, COPY, ELEMENTWISE, OTHER)
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}

_HAND_RE = re.compile(r"\b(" + "|".join(HAND_KERNELS) + r")\b")
_CONV_KEYS = ("conv", "gemm", "xmma", "cutlass", "cudnn", "wgrad", "dgrad", "implicit")
_COPY_KEYS = ("memcpy", "memset", "copy", "catarray", "nchwtonhwc", "nhwctonchw",
              "transpose")
_STEP_RE = re.compile(r"^ProfilerStep#\d+$")
SPAN_PREFIX = "s2anet."
BLOCKING = frozenset({"cudaStreamSynchronize", "cudaEventSynchronize",
                      "cudaDeviceSynchronize", "cudaMemcpy"})


def newest_trace(trace_dir) -> Path:
    """The newest ``*.json`` / ``*.json.gz`` under ``trace_dir`` (or the
    file itself)."""
    p = Path(trace_dir)
    if p.is_file():
        return p
    paths = sorted((q for q in p.rglob("*") if q.name.endswith((".json", ".json.gz"))),
                   key=lambda q: q.stat().st_mtime)
    if not paths:
        raise SystemExit(f"no *.json trace under {trace_dir}")
    return paths[-1]


def load_events(path: Path) -> list:
    opener = gzip.open if path.name.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def category(name: str, cat: str = "kernel") -> str:
    """The category of a device event."""
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


def idle_gaps(device: list, start: float) -> list:
    """``[(t0, t1)]`` of the device's idle stretches between ``start`` and
    its last event's end; ``device`` holds ``(t0, t1)`` of its events."""
    gaps, last = [], start
    for t0, t1 in sorted(device):
        if t0 > last:
            gaps.append((last, t0))
        last = max(last, t1)
    return gaps


def span_table(spans: list, syncs: list, gaps: list) -> dict:
    """``{name: {"host_ms", "syncs", "idle_ms"}}`` (totals) of the ranges
    ``spans`` (``(name, tid, t0, t1)``): their host time, the blocking
    calls ``syncs`` (``(tid, t0, t1)``) of their thread inside them, and
    the idle ``gaps`` whose middle lies inside them."""
    out = {}
    for name, tid, t0, t1 in spans:
        row = out.setdefault(name, {"host_ms": 0.0, "syncs": 0, "idle_ms": 0.0})
        row["host_ms"] += (t1 - t0) / 1000
        row["syncs"] += sum(s_tid == tid and t0 <= a and b <= t1 for s_tid, a, b in syncs)
        row["idle_ms"] += sum(b - a for a, b in gaps if t0 <= (a + b) / 2 <= t1) / 1000
    return out


def report(trace, steps: int = 0) -> dict:
    """Device time of the trace at ``trace`` (a file or a directory):
    ``{"path", "total_ms", "steps", "kernels": {name: (ms, launches,
    category)}, "categories": {category: ms}, "spans": {name: {"host_ms",
    "syncs", "idle_ms"}}}`` (totals; see :func:`span_table`). ``steps`` 0:
    the number of the trace's step markers (1 if it has none)."""
    path = newest_trace(trace)
    per_name: dict = {}
    markers, op_starts, spans, syncs, device, starts = [], [], [], [], [], []
    for ev in load_events(path):
        if ev.get("ph") != "X":
            continue
        cat = str(ev.get("cat", "")).lower()
        name = str(ev.get("name", ""))
        t0 = float(ev["ts"])
        t1 = t0 + float(ev.get("dur", 0))
        if cat == "user_annotation":
            starts.append(t0)
            if _STEP_RE.match(name):
                markers.append((t0, t1))
            if name.startswith(SPAN_PREFIX):
                spans.append((name, ev.get("tid"), t0, t1))
        if cat == "cuda_runtime" and name in BLOCKING:
            syncs.append((ev.get("tid"), t0, t1))
        if cat == "cpu_op":
            op_starts.append(t0)
        if cat not in DEVICE_CATS:
            continue
        device.append((t0, t1))
        ms, n, _ = per_name.get(name, (0.0, 0, None))
        per_name[name] = (ms + float(ev.get("dur", 0)) / 1000, n + 1, category(name, cat))
    cats = collections.Counter()
    for ms, _, c in per_name.values():
        cats[c] += ms
    # a step is a marker that holds an operator: prof.step() after the
    # last step opens one more marker, empty
    ran = sum(any(t0 <= t <= t1 for t in op_starts) for t0, t1 in markers)
    gaps = idle_gaps(device, min(starts + [t for t, _ in device])) if device else []
    return {"path": str(path), "total_ms": sum(cats.values()),
            "steps": steps or ran or 1, "kernels": per_name,
            "categories": {c: cats[c] for c in CATEGORIES},
            "spans": span_table(spans, syncs, gaps)}


def format_report(rep: dict, top: int = 25) -> str:
    steps, total = rep["steps"], rep["total_ms"]
    lines = [f"{Path(rep['path']).name}: {total:.3f} ms of device time over {steps} "
             f"step(s) = {total / steps:.3f} ms/step", "",
             f"{'category':50s} {'ms/step':>9s} {'%':>6s}"]
    for c, ms in sorted(rep["categories"].items(), key=lambda kv: -kv[1]):
        lines.append(f"{c:50s} {ms / steps:9.3f} {100 * ms / total if total else 0:5.1f}%")
    ranked = sorted(rep["kernels"].items(), key=lambda kv: -kv[1][0])
    lines += ["", f"top {top} kernels (ms/step, launches/step):"]
    for name, (ms, n, c) in ranked[:top]:
        lines.append(f"  {ms / steps:9.3f} {n / steps:7.1f}  [{c[:12]:12s}] {name[:110]}")
    lines += ["", f"{ELEMENTWISE} by kernel name (ms/step, launches/step):"]
    for name, (ms, n, c) in ranked:
        if c == ELEMENTWISE:
            lines.append(f"  {ms / steps:9.3f} {n / steps:7.1f}  {name[:120]}")
    lines += ["", "spans (host ms/step, blocking calls/step, device idle ms/step):"]
    for name, row in sorted(rep["spans"].items(), key=lambda kv: -kv[1]["host_ms"]):
        lines.append(f"  {row['host_ms'] / steps:9.3f} {row['syncs'] / steps:7.1f} "
                     f"{row['idle_ms'] / steps:9.3f}  {name}")
    return "\n".join(lines)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trace", help="a directory (its newest *.json trace) or a trace file")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--steps", type=int, default=0,
                   help="steps in the trace (default: its ProfilerStep markers, else 1)")
    opt = p.parse_args(argv)
    rep = report(opt.trace, opt.steps)
    print(format_report(rep, opt.top))
    return rep


if __name__ == "__main__":
    main()
