"""The per-layer metrics, each a function of a traced run: its profiled
stretch (``run.timeline``), the harness's own spans and the bounds the
driver worked out (``run.layer``). ``metrics/<name>.py`` names which one a
metric is. A reader that finds nothing to read returns None, and the
metric is left out of the line; a share of a roofline or a peak is never
given for kernels that did not run."""

from __future__ import annotations

from .roofline import share_pct

ALIGN_FWD = r"\bdeform_fwd_(bf16_sm90|f32)\b"
ALIGN_BWD = r"\bdeform_bwd_(dx_bf16_sm90|dw_bf16_sm90|finish_bf16|dx_f32|dw_f32)\b"
NMS = r"\bnms_(mask|sweep)_kernel\b"
BN = r"\b(channel_sums|bn_apply|bn_dx)\b"


def idle_pct(run):
    t = run.timeline
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def launches(run):
    t = run.timeline
    if t is None or not t.device:
        return None
    return len(t.kernels()) / t.steps


def enqueue_ms(run):
    return run.layer.get("enqueue_ms")


def mfu_pct(run):
    """Work a second over the chip's peak in the cell's compute type
    (``run.layer["peak_flop_s"]``, from ``roofline.PEAK_FLOP_S``)."""
    f, rate, peak = (run.layer.get(k) for k in ("flops_per_item", "rate", "peak_flop_s"))
    if not f or not rate or not peak:
        return None
    return 100.0 * f * rate / peak


def elementwise_ms(run):
    t = run.timeline
    if t is None or not t.device:
        return None
    return t.category_ms("elementwise")


def _roofline(run, bound_key: str, pattern: str):
    t = run.timeline
    if t is None:
        return None
    return share_pct(run.layer.get(bound_key), t.device_ms(pattern) / 1e3)


def align_fwd_roofline(run):
    return _roofline(run, "align_fwd_bound_s", ALIGN_FWD)


def align_bwd_roofline(run):
    return _roofline(run, "align_bwd_bound_s", ALIGN_BWD)


def nms_roofline(run):
    return _roofline(run, "nms_bound_s", NMS)


def bn_roofline(run):
    return _roofline(run, "bn_bound_s", BN)
