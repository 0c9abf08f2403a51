"""The benchmark is driven by data: a cell, a traffic driver and a
per-layer metric are files found by the names in ``BENCHMARK.json``, and
``BENCHMARK.json`` keeps to the contract's shape."""
from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

import harness

BENCH_DIR = Path(harness.__file__).resolve().parent
ROOT = BENCH_DIR.parent
SPEC = harness.load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            for key in ("why", "layer"):
                if key in entry:
                    text = entry[key]
                    assert 1 <= len(text) <= 200
                    assert "\n" not in text and "\t" not in text
            if "unit" in entry:
                assert UNIT.match(entry["unit"])
                assert entry["better"] in ("lower", "higher")
    assert len(set(names)) == len(names)
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_every_cell_names_files_that_exist():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4)
        cfg = configs[w["config"]]
        assert (ROOT / cfg["file"]).is_file()
        assert cfg["file"].startswith("benchmark/")
        cell = harness.resolve_cell(w["name"])
        assert (BENCH_DIR / "traffic" / f"{cell.driver}.py").is_file()
        assert {"setup_s"} < {m["name"] for m in cell.end_to_end}
        assert cell.per_layer
    assert {w["config"] for w in SPEC["workloads"]} == set(configs)
    for c in SPEC["configs"]:
        assert harness.load_json(ROOT / c["file"])["reduced"] == c["reduced"]


def test_every_metric_is_reported_where_it_is_listed():
    """A per-layer metric's ``moves`` is an end-to-end metric of every
    cell it lists, and its reader exists."""
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in moved.get("workloads", cells)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_has_its_limits():
    for w in SPEC["workloads"]:
        cell = harness.resolve_cell(w["name"])
        assert cell.limits and all(v > 0 for v in cell.limits.values())


@pytest.mark.parametrize("threads", [None, 2])
def test_torch_threads_follow_the_workload_file(threads):
    import torch
    before = torch.get_num_threads()
    cell = harness.resolve_cell("vitb-judge-sweep")
    cell.workload = dict(cell.workload, torch_threads=threads)
    try:
        harness.limit_threads(cell)
        assert torch.get_num_threads() == (threads or before)
    finally:
        torch.set_num_threads(before)


def test_new_cell_and_metric_are_found_by_name(tmp_path):
    """In a copy, a new workload file, a new metric file and their entries
    in BENCHMARK.json are found and read with no file of the folder
    edited."""
    root = tmp_path / "repo"
    shutil.copytree(BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "vitb-nvit-b8", "config": "vit-b16-224",
                              "traffic": "train-closed-b8-vitb", "chips": 1,
                              "why": "a new cell"})
    spec["end_to_end"][0]["workloads"].append("vitb-nvit-b8")
    spec["per_layer"].append({"name": "train.steps", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "train.trainer",
                              "moves": "train_img_per_s",
                              "workloads": ["vitb-nvit-b8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    wl = json.loads((BENCH_DIR / "workloads" / "vitl-nvit-b8.json").read_text())
    wl.update(config="vit-b16-224", traffic="train-closed-b8-vitb")
    (root / "benchmark" / "workloads" / "vitb-nvit-b8.json").write_text(
        json.dumps(wl))
    (root / "benchmark" / "metrics" / "train.steps.py").write_text(
        "def read(readings):\n    return readings.get('steps')\n")
    cell = harness.resolve_cell("vitb-nvit-b8", root, root / "benchmark")
    assert cell.driver == "train_step"
    assert cell.config["hidden_size"] == 768
    assert [m["name"] for m in cell.per_layer] == ["train.steps"]
    assert harness.read_per_layer(cell, {"steps": 7}, root / "benchmark") == {
        "train.steps": {"value": 7, "unit": "steps"}}
    for path, data in before.items():
        assert path.read_bytes() == data


@pytest.mark.parametrize("missing", ["nothing", "absent"])
def test_reader_that_finds_nothing_is_left_out(missing):
    cell = harness.resolve_cell("vitl-nvit-b8")
    got = harness.read_per_layer(cell, {} if missing == "absent" else
                                 {"trace": {}, "calls": {}})
    assert got == {}
