"""The per-layer readers on a synthetic profiler timeline."""

from __future__ import annotations

import types

import pytest

from s2a_bench import harness, readers, roofline, trace


def ev(name, cat, ts, dur, tid=1):
    return {"name": name, "cat": cat, "ts": float(ts), "dur": float(dur), "tid": tid}


def timeline(steps=2):
    events = [ev(trace.STRETCH, "user_annotation", 0, 1000),
              ev("s2a_bench.predict", "user_annotation", 0, 900),
              ev("aten::conv2d", "cpu_op", 100, 50),
              ev("void at::native::vectorized_elementwise_kernel<4>", "kernel", 100, 100),
              ev("sm90_xmma_fprop_implicit_gemm_bf16", "kernel", 150, 150),  # overlaps
              ev("deform_fwd_bf16_sm90", "kernel", 400, 100),
              ev("nms_mask_kernel", "kernel", 600, 50),
              ev("Memcpy HtoD", "gpu_memcpy", 700, 100),
              ev("outside", "kernel", 2000, 100)]
    return trace.Timeline(events, steps)


def test_busy_idle_and_launches():
    t = timeline()
    assert t.window_s == pytest.approx(1e-3)
    # device busy [100, 300] + [400, 500] + [600, 650] + [700, 800] = 450 us
    assert t.busy_s == pytest.approx(450e-6)
    run = types.SimpleNamespace(timeline=t, layer={})
    assert readers.idle_pct(run) == pytest.approx(55.0)
    assert readers.launches(run) == pytest.approx(4 / 2)


def test_grouping_copies_profile_report():
    t = timeline()
    assert trace.category("void at::native::vectorized_elementwise_kernel<4>") == trace.ELEMENTWISE
    assert trace.category("deform_fwd_bf16_sm90") == trace.HAND
    assert trace.category("bn_apply_finish<bf16>") == trace.HAND
    assert trace.category("sm90_xmma_fprop_implicit_gemm") == trace.CONV
    assert trace.category("Memcpy HtoD", "gpu_memcpy") == trace.COPY
    run = types.SimpleNamespace(timeline=t, layer={})
    assert readers.elementwise_ms(run) == pytest.approx(0.1 / 2)


def test_gaps_are_named_by_the_host():
    t = timeline()
    names = dict(t.breakdown()["idle_gaps"])
    assert sum(names.values()) == pytest.approx(t.window_s - t.busy_s)
    assert any(k.startswith("s2a_bench.predict") for k in names)
    assert len(t.breakdown()["device_ops"]) <= 10


def test_a_roofline_share_reads_100_at_its_bound_and_never_above_for_slower_kernels():
    t = timeline(steps=1)
    bound = 100e-6  # the deform kernel runs 100 us
    run = types.SimpleNamespace(timeline=t, layer={"align_fwd_bound_s": bound})
    assert readers.align_fwd_roofline(run) == pytest.approx(100.0)
    for slower in (1.5, 2.0, 10.0):
        assert roofline.share_pct(bound, slower * bound) < 100.0


def test_readers_return_nothing_where_nothing_ran():
    t = timeline()
    run = types.SimpleNamespace(timeline=t, layer={"bn_bound_s": 1e-3, "align_bwd_bound_s": 1e-3})
    assert readers.bn_roofline(run) is None
    assert readers.align_bwd_roofline(run) is None
    assert readers.mfu_pct(types.SimpleNamespace(layer={})) is None
    assert readers.idle_pct(types.SimpleNamespace(timeline=None, layer={})) is None


@pytest.mark.parametrize("dtype,peak", [("bfloat16", 989e12), ("float32", 67e12)])
def test_mfu_against_the_published_peak(dtype, peak):
    run = types.SimpleNamespace(layer={"flops_per_item": 40e9, "rate": 250.0,
                                       "peak_flop_s": roofline.PEAK_FLOP_S[dtype]})
    assert readers.mfu_pct(run) == pytest.approx(100 * 40e9 * 250 / peak)


def test_every_manifest_metric_has_a_reader():
    for m in harness.load_cell("dota_r50.serve.dense").per_layer + \
            harness.load_cell("dota_r50.train").per_layer:
        assert callable(harness.load_reader(m["name"]))
