"""Run one benchmark cell once and print its result line.

    python3 s2a_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Loads the cell named in ``BENCHMARK.json`` (its configuration, traffic mix
and limits, see ``harness.py``), makes the weights and inputs from the
seed, warms up, measures for ``--seconds``, checks what the timed path
produced against the plain reference, and prints one JSON line last on
standard output. ``--trace 1`` also profiles a short stretch after the
window and reports the cell's per-layer metrics in place of the
end-to-end ones. Exits non-zero, printing no result, without a CUDA card
(or with fewer than the cell needs), or when JAX or the JAX package was
imported. Build and kernel caches stay in ``build/`` of the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"  # no library may load JAX into the process
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(opt, device=None, fault=None, t_start: float = T_START):
    """Run the cell; returns the result dict and the check's lines.
    ``device`` (tests) replaces
    the card; ``fault`` wraps the timed step (tests of the check)."""
    import importlib

    import torch

    from s2a_bench import harness

    root = getattr(opt, "root", harness.ROOT)
    bench_dir = getattr(opt, "bench_dir", harness.HERE)
    cell = harness.load_cell(opt.workload, root, bench_dir)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise SystemExit(f"{opt.workload} needs {cell.chips} CUDA device(s); found {n}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)  # the context, before the peak is reset
        torch.cuda.reset_peak_memory_stats(device)
    run = harness.Run(cell, opt.seed, opt.seconds, bool(opt.trace), device, t_start)
    driver = importlib.import_module(f"s2a_bench.drivers.{cell.traffic['driver']}")
    driver.run(run, fault=fault)
    correct = harness.check_limits(run)
    values = {}
    if run.trace:
        for m in cell.per_layer:
            v = harness.load_reader(m["name"], bench_dir)(run)
            if v is not None:
                values[m["name"]] = v
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": cell.chips, "memory_peak_bytes": run.memory_peak}
    if run.trace and run.timeline is not None:
        info["busy_s"] = run.timeline.busy_s
        info["window_s"] = run.timeline.window_s
    return harness.result(run, correct, info, values), harness.check_lines(run)


def main(argv=None) -> int:
    opt = parse(argv)
    out, lines = execute(opt)
    from s2a_bench import harness
    bad = harness.forbidden_modules()
    if bad:
        print(f"refused: the process imported {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
