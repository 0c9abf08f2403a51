"""The benchmark's tests: the benchmark's folder and the repository root
on ``sys.path``, and a fixture of tiny cells on the CPU."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for _p in (str(BENCH_DIR), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from bench_tiny import tiny_context  # noqa: E402


@pytest.fixture
def tiny(tmp_path):
    return lambda driver, **kw: tiny_context(driver, tmp_path, **kw)
