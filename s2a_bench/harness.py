"""What every driver shares: the cell as ``BENCHMARK.json`` and its files
describe it, the run's options, the limits of the correctness check, the
result line and the per-layer metric readers.

Everything of one configuration, traffic mix, cell or metric is a file
found by its name: ``configs/<config>.json``, ``traffic/<traffic>.json``
(whose ``driver`` names a module of ``drivers/``), ``limits/<cell>.json``
and ``metrics/<metric>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "s2anet_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    chips: int


def load_cell(name: str, root: Path = ROOT, bench_dir: Path = HERE) -> Cell:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the manifest has {sorted(cells)}")
    w = cells[name]
    config = json.loads((bench_dir / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((bench_dir / "limits" / f"{name}.json").read_text())
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name, config, traffic, limits, e2e, per_layer, int(w["chips"]))


@dataclasses.dataclass
class Run:
    """One run of a cell: its options, and what the driver measured."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    metrics: dict = dataclasses.field(default_factory=dict)  # end-to-end values
    readings: dict = dataclasses.field(default_factory=dict)  # the check's numbers
    attempted: int = 0
    failed: int = 0
    memory_peak: int = 0
    timeline: Optional[object] = None  # trace.Timeline of the profiled stretch
    layer: dict = dataclasses.field(default_factory=dict)  # inputs of the readers
    setup_s: float = math.nan
    phases: dict = dataclasses.field(default_factory=dict)  # seconds since the start

    def mark(self, phase: str) -> None:
        self.phases[phase] = time.perf_counter() - self.t_start

    def mark_setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t_start


def load_reader(metric: str, bench_dir: Path = HERE):
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"s2a_bench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def check_limits(run: Run) -> bool:
    """True when every reading is a number at or under its limit."""
    ok = True
    for key, limit in run.cell.limits["limits"].items():
        v = run.readings.get(key)
        if v is None or not math.isfinite(v) or v > limit:
            ok = False
    return ok


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` of JAX or of the JAX package,
    compared whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def result(run: Run, correct: bool, device_info: dict, layer_values: dict) -> dict:
    """The result line: end-to-end metrics, or with ``--trace 1`` the
    per-layer values its readers found; the check's numbers last."""
    metrics = {}
    units = {m["name"]: m["unit"] for m in run.cell.end_to_end + run.cell.per_layer}
    if run.trace:
        for name, v in layer_values.items():
            metrics[name] = {"value": v, "unit": units[name]}
    else:
        for m in run.cell.end_to_end:
            metrics[m["name"]] = {"value": run.metrics[m["name"]], "unit": units[m["name"]]}
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device_info}
    if run.trace and run.timeline is not None:
        out["breakdown"] = run.timeline.breakdown()
    out["check"] = {k: {"value": run.readings.get(k), "limit": v}
                    for k, v in run.cell.limits["limits"].items()}
    return out


def check_lines(run: Run) -> list:
    """The check's numbers beside their limits, then what else it read."""
    limits = run.cell.limits["limits"]
    return ([f"noted phase {k}: {v:.3f} s" for k, v in run.phases.items()]
            + [f"noted {k}: {v!r}" for k, v in run.readings.items() if k not in limits]
            + [f"check {k}: {run.readings.get(k)!r} limit {v!r}" for k, v in limits.items()])
