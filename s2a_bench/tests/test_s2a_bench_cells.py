"""Every cell end to end on the CPU at a tiny size (the program's plain
paths), a cell added from files alone, and the faults the check must see."""

from __future__ import annotations

import json

import pytest
import torch

from s2a_bench import faults, harness, run as bench_run
from s2a_bench.tests import tiny

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_end_to_end_on_cpu(tiny_bench, cell):
    out, lines = bench_run.execute(tiny.options(tiny_bench, cell), device=torch.device("cpu"))
    assert out["correct"] is True, lines
    e2e = harness.load_cell(cell, tiny_bench, tiny_bench / "b").end_to_end
    assert set(out["metrics"]) == {m["name"] for m in e2e}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "check" and set(out["check"]) == set(
        json.loads((tiny_bench / "b" / "limits" / f"{cell}.json").read_text())["limits"])
    assert out["attempted"] > 0 and out["failed"] == 0
    assert lines[-1].startswith("check ")


def test_a_cell_added_from_files_alone(tmp_path):
    dest = tiny.make(tmp_path)
    manifest = json.loads((dest / "BENCHMARK.json").read_text())
    traffic = json.loads((dest / "b" / "traffic" / "serve_dense.json").read_text())
    traffic.update(score_thr=0.05, pool=2)
    (dest / "b" / "traffic" / "serve_new_mix.json").write_text(json.dumps(traffic))
    (dest / "b" / "limits" / "dota_r50.serve.new.json").write_text(
        (dest / "b" / "limits" / "dota_r50.serve.dense.json").read_text())
    manifest["workloads"].append({"name": "dota_r50.serve.new", "config": "s2anet_r50_fpn_dota",
                                  "traffic": "serve_new_mix", "chips": 1, "why": "a test"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "dota_r50.serve.dense" in m.get("workloads", []):
            m["workloads"].append("dota_r50.serve.new")
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest))
    out, lines = bench_run.execute(tiny.options(dest, "dota_r50.serve.new"),
                                   device=torch.device("cpu"))
    assert out["correct"] is True, lines
    assert "chips_per_s" in out["metrics"]


@pytest.mark.parametrize("cell,fault", [
    ("dota_r50.serve.dense", "half_batch"), ("dota_r50.serve.dense", "alter"),
    ("dota_r50.train", "frozen"), ("dota_r50.train", "half_batch")])
def test_a_planted_fault_makes_correct_false(tiny_bench, cell, fault):
    table = faults.SERVE if "serve" in cell else faults.TRAIN
    out, lines = bench_run.execute(tiny.options(tiny_bench, cell), device=torch.device("cpu"),
                                   fault=table[fault])
    assert out["correct"] is False, lines


def test_the_command_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        bench_run.main(["--workload", "dota_r50.serve.dense", "--seed", "1", "--seconds", "1"])
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(tiny_bench, card, cell):
    out, lines = bench_run.execute(tiny.options(tiny_bench, cell, trace=1), device=card)
    assert out["correct"] is True, lines
    assert out["device"]["busy_s"] > 0
