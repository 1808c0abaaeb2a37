"""The readers of the program's spans (``spans.py``) on synthetic profiler
timelines: nesting, the main-thread filter, blocking calls inside and
outside a span, and nothing where a span is absent."""

from __future__ import annotations

import types

import pytest

from s2a_bench import harness, spans, trace

MAIN, OTHER = 1, 2


def ev(name, cat, ts, dur, tid=MAIN):
    return {"name": name, "cat": cat, "ts": float(ts), "dur": float(dur), "tid": tid}


def span(name, ts, dur, tid=MAIN):
    return ev(name, "user_annotation", ts, dur, tid)


def run_of(events, steps):
    return types.SimpleNamespace(timeline=trace.Timeline(events, steps), layer={})


def train_run():
    """Two steps of 1000 us: feed, then the step holding the forward (with
    its backbone), the loss (with the assigner), the backward and the
    update (with the EMA); a forward outside any step; spans and a sync on
    another thread."""
    events = [span(trace.STRETCH, 0, 3000)]
    for t in (0, 1000):
        events += [span("s2a_bench.train_step", t, 1000),
                   span("s2anet.train.feed", t, 50),
                   ev("cudaMemcpyAsync", "cuda_runtime", t + 10, 5),
                   span("s2anet.train.step", t + 50, 940),
                   span("s2anet.forward", t + 60, 300),
                   span("s2anet.backbone", t + 60, 200),
                   span("s2anet.train.loss", t + 360, 150),
                   span("s2anet.train.assign", t + 370, 60),
                   span("s2anet.train.backward", t + 510, 320),
                   span("s2anet.train.update", t + 830, 150),
                   span("s2anet.train.ema", t + 900, 60)]
    events += [span("s2anet.forward", 2100, 400),  # outside every step
               ev("cudaStreamSynchronize", "cuda_runtime", 2200, 30),  # outside the step
               span("s2anet.train.backward", 600, 100, tid=OTHER),
               ev("cudaDeviceSynchronize", "cuda_runtime", 610, 10, tid=OTHER)]
    return run_of(events, 2)


def serve_run(sync_inside=True):
    """Two batches: wait for the loader, stage, predict (forward, then post
    with decode and NMS), copy out, wait for the device."""
    events = [span(trace.STRETCH, 0, 2000)]
    for t in (0, 1000):
        events += [span("s2anet.pipeline.wait_loader", t, 40),
                   span("s2a_bench.wait_loader", t + 5, 30),
                   span("s2anet.pipeline.stage", t + 40, 10),
                   span("s2a_bench.predict", t + 50, 800),
                   span("s2anet.predict", t + 52, 796),
                   span("s2anet.forward", t + 60, 500),
                   span("s2anet.post", t + 560, 280),
                   span("s2anet.decode", t + 560, 80),
                   span("s2anet.nms", t + 640, 200),
                   span("s2anet.pipeline.copy_out", t + 850, 20),
                   span("s2anet.pipeline.wait_device", t + 870, 120),
                   # the pipeline's own event wait, outside predict
                   ev("cudaEventSynchronize", "cuda_runtime", t + 880, 100),
                   ev("cudaMemcpyAsync", "cuda_runtime", t + 855, 3)]
        if sync_inside:
            events.append(ev("cudaStreamSynchronize", "cuda_runtime", t + 700, 40))
    return run_of(events, 2)


def test_training_spans_per_step():
    run = train_run()
    assert spans.train_forward_ms(run) == pytest.approx(0.3)  # not the forward outside
    assert spans.train_loss_ms(run) == pytest.approx(0.15)
    assert spans.train_backward_ms(run) == pytest.approx(0.32)  # the main thread's only
    assert spans.train_update_ms(run) == pytest.approx(0.15)
    # the sync at 2200 lies in no step and the other thread's is not read
    assert spans.train_syncs(run) == 0.0


def test_a_sync_inside_the_feed_counts():
    run = train_run()
    run.timeline.host.append(ev("cudaMemcpy", "cuda_runtime", 1010, 5))
    assert spans.train_syncs(run) == pytest.approx(0.5)


def test_serving_spans_per_batch():
    run = serve_run()
    assert spans.serve_forward_ms(run) == pytest.approx(0.5)
    assert spans.serve_post_ms(run) == pytest.approx(0.28)
    assert spans.device_wait_ms(run) == pytest.approx(0.12)
    assert spans.loader_wait_ms(run) == pytest.approx(0.04)
    # one stream sync inside predict a batch; the event wait lies outside
    assert spans.serve_syncs(run) == pytest.approx(1.0)
    assert spans.serve_syncs(serve_run(sync_inside=False)) == 0.0


def test_the_gaps_are_named_by_the_innermost_program_span():
    run = serve_run()
    run.timeline.device.append(ev("kernel_a", "kernel", 0, 700))
    run.timeline.device.append(ev("kernel_b", "kernel", 760, 1940))
    names = dict(run.timeline.breakdown()["idle_gaps"])
    assert list(names) == ["s2anet.nms: cudaStreamSynchronize"]


@pytest.mark.parametrize("reader", [
    spans.train_forward_ms, spans.train_loss_ms, spans.train_backward_ms,
    spans.train_update_ms, spans.train_syncs, spans.serve_forward_ms,
    spans.serve_post_ms, spans.serve_syncs, spans.device_wait_ms, spans.loader_wait_ms])
def test_nothing_where_the_program_has_no_spans(reader):
    """A program without spans (the harness's own only) reads nothing."""
    events = [span(trace.STRETCH, 0, 1000), span("s2a_bench.predict", 0, 900),
              span("s2a_bench.train_step", 0, 900),
              ev("cudaStreamSynchronize", "cuda_runtime", 100, 10),
              ev("kernel", "kernel", 100, 100)]
    assert reader(run_of(events, 1)) is None
    assert reader(types.SimpleNamespace(timeline=None, layer={})) is None


def test_the_manifest_names_a_reader_of_spans_for_each_new_metric():
    names = {m["name"] for cell in ("dota_r50.serve.dense", "dota_r50.train")
             for m in harness.load_cell(cell).per_layer if m["source"] == "program_span"}
    assert {"host_ms.train.forward", "host_ms.train.loss", "host_ms.train.backward",
            "host_ms.train.update", "host_syncs.train", "host_ms.serve.forward",
            "host_ms.serve.post", "host_syncs.serve", "device_wait_ms.serve",
            "loader_wait_ms.serve"} <= names
    for name in names - {"enqueue_ms.serve", "enqueue_ms.train"}:
        assert harness.load_reader(name).__module__ == "s2a_bench.spans"
