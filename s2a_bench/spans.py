"""The readers of the program's own spans (``s2anet.*``, recorded by
``s2anet_tpu_torch/utils/profiler.py::span`` while a profiler records) in
the profiled stretch: host milliseconds a step inside a span, and blocking
runtime calls a step inside spans.

They read ``run.timeline.host``, the main thread's events inside the
stretch, and divide by ``run.timeline.steps``. A reader whose span is
absent (a program without spans, or no traced stretch) returns None; no
reader returns a value derived from the device's kernels.
"""

from __future__ import annotations

# runtime calls that hold the host until the device has finished earlier
# work (``cudaMemcpy``, not ``cudaMemcpyAsync``); the list of the port's
# ``tools/profile_report.py``, copied: the readers also run over a program
# that lacks it
BLOCKING = frozenset({"cudaStreamSynchronize", "cudaEventSynchronize",
                      "cudaDeviceSynchronize", "cudaMemcpy"})


def spans(t, name: str) -> list:
    """The main thread's ranges named ``name``."""
    return [e for e in t.host if e["cat"] == "user_annotation" and e["name"] == name]


def inside(e, outer: list) -> bool:
    """``e`` lies within one of the ranges ``outer``."""
    return any(o["ts"] <= e["ts"] and e["ts"] + e["dur"] <= o["ts"] + o["dur"] for o in outer)


def span_ms(run, name: str, within: str = ""):
    """Host ms a step of the ``name`` spans (those inside a ``within`` span,
    when given); None when there is none."""
    t = run.timeline
    if t is None:
        return None
    found = spans(t, name)
    if within:
        outer = spans(t, within)
        found = [e for e in found if inside(e, outer)]
    if not found:
        return None
    return sum(e["dur"] for e in found) / 1e3 / t.steps


def syncs(run, *within: str):
    """Blocking runtime calls a step inside any span named in ``within``;
    None when there is no such span."""
    t = run.timeline
    if t is None:
        return None
    outer = [e for name in within for e in spans(t, name)]
    if not outer:
        return None
    calls = [e for e in t.host if e["cat"] == "cuda_runtime" and e["name"] in BLOCKING]
    return sum(inside(e, outer) for e in calls) / t.steps


def train_forward_ms(run):
    return span_ms(run, "s2anet.forward", within="s2anet.train.step")


def train_loss_ms(run):
    return span_ms(run, "s2anet.train.loss")


def train_backward_ms(run):
    return span_ms(run, "s2anet.train.backward")


def train_update_ms(run):
    return span_ms(run, "s2anet.train.update")


def train_syncs(run):
    return syncs(run, "s2anet.train.step", "s2anet.train.feed")


def serve_forward_ms(run):
    return span_ms(run, "s2anet.forward")


def serve_post_ms(run):
    return span_ms(run, "s2anet.post")


def serve_syncs(run):
    return syncs(run, "s2anet.predict")


def device_wait_ms(run):
    return span_ms(run, "s2anet.pipeline.wait_device")


def loader_wait_ms(run):
    return span_ms(run, "s2anet.pipeline.wait_loader")
