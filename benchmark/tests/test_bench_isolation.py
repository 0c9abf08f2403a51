"""Nothing the benchmark runs loads JAX or the JAX package, the plain
reference loads nothing of the port, and a run without a card gives no
result."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import harness

BENCH_DIR = Path(harness.__file__).resolve().parent
ROOT = BENCH_DIR.parent
PORT = "touhouimageclassification_tpu_torch"


def _modules(exclude_tests: bool = True) -> list[Path]:
    return sorted(p for p in BENCH_DIR.rglob("*.py")
                  if not (exclude_tests and "tests" in p.relative_to(
                      BENCH_DIR).parts))


def _python(code: str) -> dict:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


_HEAD = f"""
import json, sys
sys.path[:0] = [{str(BENCH_DIR)!r}, {str(ROOT)!r}]
import harness
"""


def test_every_module_and_cell_loads_without_jax():
    """Every benchmark module, every cell's resolution, the traffic drivers' port
    entry points: no loaded module's top-level name is jax, jaxlib, flax
    or the JAX package (the port's own name, which begins with it, is
    another name)."""
    # files the harness loads by name, and the importable modules
    by_path = [str(p) for p in _modules()
               if p.parent.name in ("traffic", "metrics")]
    by_name = [".".join(p.relative_to(BENCH_DIR).with_suffix("").parts)
               for p in _modules() if p.parent.name not in ("traffic",
                                                            "metrics")]
    names = [w["name"] for w in harness.load_json(
        ROOT / "BENCHMARK.json")["workloads"]]
    got = _python(_HEAD + f"""
import importlib, pathlib
for p in {by_path!r}:
    harness.load_module(pathlib.Path(p))
for m in {by_name!r}:
    importlib.import_module(m)
for name in {names!r}:
    harness.resolve_cell(name)
import {PORT}.train.trainer, {PORT}.infer.serve, {PORT}.web.runtime
print(json.dumps({{"bad": harness.forbidden_loaded(),
                   "port": "{PORT}" in sys.modules}}))
""")
    assert got["port"]
    assert got["bad"] == []


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    for name in (PORT, PORT + ".ops", "jaxtyping", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_loaded() == []
    for name in ("jax.numpy", "touhouimageclassification_tpu.ops", "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_loaded() == ["flax", "jax.numpy",
                                          "touhouimageclassification_tpu.ops"]


def test_reference_imports_nothing_of_the_port():
    refs = sorted((BENCH_DIR / "reference").glob("*.py"))
    for path in refs:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in (PORT, *harness.FORBIDDEN_MODULES), \
                    f"{path.name} imports {mod}"
    got = _python(_HEAD + """
import reference.vit_plain, reference.augment_plain, reference.train_plain
import reference.serve_plain
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
""")
    assert PORT not in got
    assert not set(got) & set(harness.FORBIDDEN_MODULES)


def test_run_without_a_card_gives_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "vitl-nvit-b8",
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_test_file_names_are_unused_under_tests():
    ours = {p.name for p in (BENCH_DIR / "tests").glob("test_*.py")}
    theirs = {p.name for p in (ROOT / "tests").rglob("*.py")}
    assert ours and not ours & theirs


@pytest.fixture
def card():
    """Skips a test without a CUDA card (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_cell_runs_on_the_card(card):
    """One short run of the smallest cell on the card: a result line whose
    last key is the checks, with the card named."""
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "vitl-nvit-b8",
         "--seed", "3000000019", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
