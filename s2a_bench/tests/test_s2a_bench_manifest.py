"""BENCHMARK.json against the benchmark's contract, and the files it names."""

from __future__ import annotations

import json
import re

import pytest

from s2a_bench import harness

ROOT = harness.ROOT
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(M) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(M["command"]) <= 32
    for word in M["command"]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in M["paths"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_entry_keys(section):
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}[section]
    names = [e["name"] for e in M[section]]
    assert len(names) == len(set(names))
    for e in M[section]:
        assert set(e) <= allowed, set(e) - allowed
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_configs_cells_and_files():
    configs = {c["name"]: c for c in M["configs"]}
    used = {w["config"] for w in M["workloads"]}
    assert used == set(configs)
    for c in M["configs"]:
        assert c["file"].startswith("s2a_bench/") and (ROOT / c["file"]).is_file()
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] and all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in M["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (harness.HERE / "limits" / f"{w['name']}.json").is_file()
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(M["workloads"]) // 4)


def test_bounds_and_setup():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for w in M["workloads"]:
        cell = harness.load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


def test_per_layer_moves_is_reported_in_each_of_its_cells():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    cells = {w["name"] for w in M["workloads"]}
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        target = e2e[m["moves"]]
        for cell in m.get("workloads", sorted(cells)):
            assert cell in cells
            assert cell in target.get("workloads", [cell])
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in M["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_file_names_under_paths_use_name_characters():
    for p in (harness.HERE).rglob("*"):
        if "__pycache__" in p.parts or p.suffix == ".pyc":
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
