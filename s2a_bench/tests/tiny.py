"""A copy of the benchmark's files at a size the CPU runs in seconds: the
same cells, configurations cut to ResNet-18 at 128^2 with 3 classes, float32,
and traffic cut to a few batches. Only data files change; the harness's code
is the repository's."""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent


def make(dest: Path) -> Path:
    """Write the tiny benchmark under ``dest`` (``BENCHMARK.json`` and a
    bench folder ``dest/b``); returns ``dest``."""
    bench = dest / "b"
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(HERE / "metrics", bench / "metrics", dirs_exist_ok=True)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in manifest["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["model"].update(backbone="resnet18", num_classes=min(cfg["model"]["num_classes"], 3))
        cfg["data"].update(img_size=128, max_gt=16)
        cfg["train"].update(batch_size=2, dtype="float32")
        cfg["eval"]["dtype"] = "float32"
        (bench / "configs" / f"{c['name']}.json").write_text(json.dumps(cfg))
    for w in manifest["workloads"]:
        t = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        if t["driver"] == "serve_closed":
            t.update(batch=2, pool=4, warmup_batches=1, sample_batches=2, profile_batches=2)
        else:
            t.update(pool=4, profile_steps=2, gt_counts=[1 + i % 6 for i in range(8)])
            t["box"]["long_px"] = [60, 300]
        (bench / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
        shutil.copy(HERE / "limits" / f"{w['name']}.json", bench / "limits")
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest))
    return dest


def options(dest: Path, workload: str, seed: int = 2**31 + 12345, seconds: float = 1.0,
            trace: int = 0) -> argparse.Namespace:
    return argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=trace,
                              root=dest, bench_dir=dest / "b")
