"""Helpers of the port's multi-process CPU tests: start one child process a
rank (``torch_mp_child.py``) and collect what each returns."""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHILD = pathlib.Path(__file__).with_name("torch_mp_child.py")


def spawn(directory: pathlib.Path, mode: str, world: int, spec: dict,
          timeout: float = 150) -> list[dict]:
    """Run ``mode`` on ``world`` gloo ranks of the CPU; each child's own
    ``communicate(timeout=...)`` bounds it, and a failed or hung child fails
    the test with its output."""
    directory.mkdir(parents=True, exist_ok=True)
    torch.save(spec, directory / "spec.pt")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "PYTHONPATH")}
    env["PYTHONPATH"] = str(ROOT)
    procs = [subprocess.Popen(
        [sys.executable, str(CHILD), mode, str(rank), str(world),
         str(directory)], env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(world)]
    results = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail(f"{mode} on {world} ranks timed out")
        results.append((p.returncode, out, err))
    for rank, (rc, out, err) in enumerate(results):
        assert rc == 0, f"{mode} rank {rank} failed:\n{out[-2000:]}\n" \
                        f"{err[-4000:]}"
    return [torch.load(directory / f"out{rank}.pt", weights_only=False)
            for rank in range(world)]


def merged(outs: list[dict], key: str = "held") -> dict:
    """The union of the ranks' state dicts; a name two ranks hold must be
    equal on both (replicated state stays replicated)."""
    merged_sd: dict = {}
    for out in outs:
        for name, value in out[key].items():
            if name in merged_sd:
                assert torch.equal(merged_sd[name], value), name
            merged_sd[name] = value
    return merged_sd
