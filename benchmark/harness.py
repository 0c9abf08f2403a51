"""The benchmark's frame: finds a cell and its files by name, checks the
card, runs the cell's traffic driver, reads the per-layer metrics and
prints the result line.

Everything that belongs to one cell, configuration, traffic kind or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the configuration's sizes (the ``file`` of its
  ``configs`` entry);
- ``workloads/<cell>.json``: the cell's traffic driver, its parameters,
  the limits of its correctness check and, optionally, ``torch_threads``:
  the CPU threads torch's operators may use in the run;
- ``traffic/<driver>.py``: a driver, ``run(ctx) -> dict``;
- ``metrics/<metric>.py``: a reader, ``read(readings) -> float | None``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names that may not be loaded in a run
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "touhouimageclassification_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    workload: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def driver(self) -> str:
        return self.workload["driver"]

    @property
    def params(self) -> dict:
        return self.workload["params"]

    @property
    def limits(self) -> dict:
        return self.workload["limits"]


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the run's arguments, the device, the
    process's start on ``time.perf_counter``'s clock and a scratch
    directory of the run under ``TMPDIR``."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t_process: float
    scratch: Path

    def log(self, *parts) -> None:
        print(*parts, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve_cell(name: str, root: Path = ROOT,
                 bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    spec = load_json(root / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in spec["configs"] if c["name"] == entry["config"])
    workload = load_json(bench_dir / "workloads" / f"{name}.json")
    if (workload["config"], workload["traffic"]) != (entry["config"],
                                                     entry["traffic"]):
        raise ValueError(f"workloads/{name}.json names another config or "
                         "traffic than BENCHMARK.json")
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(name=name, chips=int(entry["chips"]),
                config=load_json(root / config["file"]), workload=workload,
                end_to_end=e2e, per_layer=per_layer)


def load_module(path: Path) -> ModuleType:
    """A benchmark file as a module (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def driver_module(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return load_module(bench_dir / "traffic" / f"{name}.py")


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return load_module(bench_dir / "metrics" / f"{name}.py")


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN_MODULES`, compared whole."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN_MODULES})


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card, or ''."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def read_per_layer(cell: Cell, readings: dict,
                   bench_dir: Path = BENCH_DIR) -> dict:
    """Every per-layer metric of the cell that its reader finds."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"], bench_dir).read(readings)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def verdict(checks: list[tuple[str, float, float]]) -> bool:
    """Correct when every compared number is finite and within its limit."""
    return bool(checks) and all(math.isfinite(v) and v <= lim
                                for _, v, lim in checks)


def result_line(cell: Cell, outcome: dict, trace: bool,
                device: dict) -> dict:
    """The result object; ``checks`` comes last."""
    checks = outcome["checks"]
    if trace:
        metrics = read_per_layer(cell, outcome["readings"])
    else:
        metrics = {m["name"]: {"value": outcome["metrics"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    line = {"correct": verdict(checks),
            "attempted": int(outcome["attempted"]),
            "failed": int(outcome["failed"]), "metrics": metrics,
            "device": device}
    if trace and outcome.get("breakdown"):
        line["breakdown"] = outcome["breakdown"]
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in checks}
    return line


def scratch_dir(workload: str) -> Path:
    """The run's scratch directory under ``TMPDIR``, emptied first."""
    path = Path(tempfile.gettempdir()) / f"tic_bench_{workload}"
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def limit_threads(cell: Cell) -> None:
    """Hold torch's CPU operators to the cell's ``torch_threads``, where its
    workload file names a number: idle pool threads that spin take cores
    from a host-bound loop (and, in a sandboxed kernel, from its system
    calls), which makes the loop's pace swing from run to run."""
    threads = cell.workload.get("torch_threads")
    if threads:
        import torch
        torch.set_num_threads(int(threads))


def cache_dirs() -> None:
    """Kernel and extension caches inside the checkout, at fixed paths (the
    port's own kernel library is built under ``build/torch_kernels``)."""
    base = ROOT / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(base / sub)
