"""The profiler tools: ``utils/profiler.py`` and ``tools/profile_report.py``.

* The report's totals, categories, steps and listings on a Chrome trace the
  test writes, exactly; its table of the port's spans (host ms, blocking
  calls of the span's thread inside it, device idle whose gap falls inside
  it) on the same trace.
* A real CPU ``torch.profiler`` trace from ``utils/profiler.trace``: found,
  parsed, its steps counted from the step markers.
* The report's list of hand kernels is the ``__global__`` functions of
  ``csrc/*.cu``.
* ``measure_matmul_peak`` refuses the CPU.
"""

import json
import re
from pathlib import Path

import pytest
import torch

from s2anet_tpu_torch.tools import profile_report as pr
from s2anet_tpu_torch.utils import flops, profiler

CSRC = Path(pr.__file__).resolve().parents[1] / "csrc"

# (name, cat, microseconds, launches)
EVENTS = [
    ("void deform_fwd_bf16_sm90<256>(Params)", "kernel", 300.0, 5),
    ("nms_mask_kernel(float const*, int const*, bool const*, float, long*, int, int)",
     "kernel", 120.0, 1),
    ("nms_sweep_kernel(long const*, bool const*, bool*, int, int)", "kernel", 15.0, 1),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "kernel", 2000.0, 40),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float>(...)", "kernel", 50.0, 2),
    ("void at::native::reduce_kernel<512, 1, ReduceOp<float>>(...)", "kernel", 80.0, 4),
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 400.0, 1),
    ("Memset (Device)", "gpu_memset", 4.0, 2),
    ("void at::native::vectorized_elementwise_kernel<4, AddFunctor<float>>(...)", "kernel",
     600.0, 30),
    ("void at::native::unrolled_elementwise_kernel<ClampFunctor>(...)", "kernel", 200.0, 20),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>(...)", "kernel", 90.0, 3),
]


def _write_trace(path: Path, steps: int = 2):
    events, t = [], 0.0
    for s in range(steps + 1):  # the last marker holds no operator
        events.append({"ph": "X", "cat": "user_annotation", "name": f"ProfilerStep#{s}",
                       "ts": t, "dur": 1000.0 if s < steps else 5.0})
        if s < steps:
            events.append({"ph": "X", "cat": "cpu_op", "name": "aten::conv2d",
                           "ts": t + 1, "dur": 10.0})
        t += 2000.0
    for name, cat, us, n in EVENTS:
        for _ in range(n):
            events.append({"ph": "X", "cat": cat, "name": name, "ts": t, "dur": us / n})
            t += us / n
    # the port's spans on thread 1: the device is idle from 0 to the first
    # kernel at 2 * steps + 2 ms, a gap whose middle lies in wait_device
    mid = (2000.0 * (steps + 1)) / 2
    for name, cat, ts, dur, tid in [
            ("s2anet.predict", "user_annotation", 1, 998, 1),
            ("s2anet.post", "user_annotation", 500, 400, 1),
            ("cudaStreamSynchronize", "cuda_runtime", 600, 50, 1),  # inside post
            ("cudaStreamSynchronize", "cuda_runtime", 610, 20, 2),  # another thread
            ("cudaMemcpyAsync", "cuda_runtime", 700, 5, 1),  # does not block
            ("s2anet.predict", "user_annotation", 2001, 998, 1),
            ("cudaMemcpy", "cuda_runtime", 2100, 10, 1),  # inside predict only
            ("cudaEventSynchronize", "cuda_runtime", 1500, 10, 1),  # in no span
            ("s2anet.pipeline.wait_device", "user_annotation", mid - 500, 1000, 1)]:
        events.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid})
    events.append({"ph": "i", "cat": "kernel", "name": "ignored instant", "ts": t})
    path.write_text(json.dumps({"traceEvents": events}))


def test_report_on_a_written_trace(tmp_path, capsys):
    older = tmp_path / "a" / "old.pt.trace.json"
    older.parent.mkdir()
    older.write_text(json.dumps({"traceEvents": []}))
    _write_trace(tmp_path / "a" / "new.pt.trace.json")
    rep = pr.report(tmp_path)  # the newest trace under the directory
    assert rep["path"].endswith("new.pt.trace.json") and rep["steps"] == 2
    assert rep["total_ms"] == pytest.approx(sum(e[2] for e in EVENTS) / 1000)
    want = {pr.HAND: 435.0, pr.CONV: 2000.0, pr.REDUCE: 80.0, pr.COPY: 454.0,
            pr.ELEMENTWISE: 800.0, pr.OTHER: 90.0}
    assert rep["categories"] == pytest.approx({c: us / 1000 for c, us in want.items()})
    assert {name: n for name, (_, n, _) in rep["kernels"].items()} == {
        e[0]: e[3] for e in EVENTS}
    assert pr.report(tmp_path, steps=5)["steps"] == 5
    got = pr.main([str(tmp_path), "--top", "3"])
    out = capsys.readouterr().out
    assert got["steps"] == 2 and "3.859 ms of device time over 2 step(s) = 1.930 ms/step" in out
    top = out.split("top 3 kernels")[1].split("\n\n")[0].splitlines()[1:]
    assert len(top) == 3 and "sm90_xmma_fprop" in top[0] and "vectorized_elementwise" in top[1]
    listed = out.split("elementwise by kernel name")[1].split("\n\n")[0].splitlines()[1:]
    assert [line.split()[:2] for line in listed] == [["0.300", "15.0"], ["0.100", "10.0"]]
    # the spans: host ms, blocking calls and idle ms, totals and per step
    assert rep["spans"] == {
        "s2anet.predict": {"host_ms": pytest.approx(1.996), "syncs": 2, "idle_ms": 0.0},
        "s2anet.post": {"host_ms": pytest.approx(0.4), "syncs": 1, "idle_ms": 0.0},
        "s2anet.pipeline.wait_device": {"host_ms": pytest.approx(1.0), "syncs": 0,
                                        "idle_ms": pytest.approx(6.0)}}
    spans = out.split("spans (host ms/step")[1].splitlines()[1:]
    assert [line.split() for line in spans] == [
        ["0.998", "1.0", "0.000", "s2anet.predict"],
        ["0.500", "0.0", "3.000", "s2anet.pipeline.wait_device"],
        ["0.200", "0.5", "0.000", "s2anet.post"]]


def test_report_on_a_real_cpu_trace(tmp_path):
    with profiler.trace(tmp_path, name="cpu") as prof:
        for _ in range(3):
            torch.randn(64, 64) @ torch.randn(64, 64)
            prof.step()
    (path,) = tmp_path.glob("cpu_*.pt.trace.json")
    rep = pr.report(tmp_path)
    assert rep["path"] == str(path) and rep["steps"] == 3
    # no card: no device events
    assert rep["total_ms"] == 0 and not rep["kernels"]
    names = {e.get("name") for e in pr.load_events(path)}
    assert "aten::mm" in names


def test_hand_kernels_are_the_csrc_kernels():
    found = set()
    for src in CSRC.glob("*.cu"):
        text = src.read_text()
        for m in re.finditer(r"__global__\s+void\s+(?:(?:__launch_bounds__|__cluster_dims__)"
                             r"\s*\([^)]*\)\s*)*(\w+)\s*\(", text):
            found.add(m.group(1))
    assert found == set(pr.HAND_KERNELS)
    for name in found:
        assert pr.category(f"void {name}<1>(int)") == pr.HAND


def test_median_spread():
    assert profiler.median_spread([1.0, 2.0, 4.0]) == (2.0, 1.5)


def test_card_timers_refuse_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        flops.measure_matmul_peak()
