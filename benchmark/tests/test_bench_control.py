"""The control comes out as not correct: the plain reference one precision
below bf16 (float8 e4m3), put in the program's place at each cell's own
size on the card, fails at least one of the cell's limits on every seed."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

import harness

ROOT = Path(harness.__file__).resolve().parents[1]


@pytest.fixture
def card():
    """Skips a test without a CUDA card (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["vitl-nvit-b8", "vitb-judge-sweep"])
def test_control_fails(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/control.py", "--workload", cell,
         "--seeds", "3700000001", "3700000002", "3700000003"],
        capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert len(lines) == 3
    assert all(line["control_fails"] for line in lines), lines


def test_verdict_rejects_a_number_over_its_limit_or_not_finite():
    assert harness.verdict([("a", 0.1, 0.2), ("b", 0.0, 0.0)])
    assert not harness.verdict([("a", 0.3, 0.2)])
    assert not harness.verdict([("a", float("nan"), 0.2)])
    assert not harness.verdict([])
