"""The benchmark of the port ``touhouimageclassification_tpu_torch`` on
NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the card(s) of this machine: its
set-up (weights and inputs from the seed, every shape warmed), a measured
window of ``--seconds``, then the plain reference's check of what the
window produced. The last line of standard output is the result: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from a profiled part of the window. Each compared number
and its limit are printed last on standard error and under ``checks`` in
the result. Without enough CUDA devices it exits with code 3, and with a
JAX module loaded after the window with code 4, printing no result.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
for path in (str(BENCH_DIR), str(BENCH_DIR.parent)):
    if path not in sys.path:
        sys.path.insert(0, path)
# libraries that would load JAX on their own stay off it
for var in ("USE_FLAX", "USE_JAX", "USE_TF"):
    os.environ[var] = "0"


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import harness
    cell = harness.resolve_cell(args.workload)
    harness.cache_dirs()
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s), this machine "
              f"has {have}; no result", file=sys.stderr)
        return 3
    harness.limit_threads(cell)
    out = sys.stdout
    scratch = harness.scratch_dir(cell.name)
    with contextlib.redirect_stdout(sys.stderr):
        ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace),
                              device=torch.device("cuda", 0),
                              t_process=T_PROCESS, scratch=scratch)
        outcome = harness.driver_module(cell.driver).run(ctx)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"JAX modules loaded in the run: {loaded}; no result",
              file=sys.stderr)
        return 4
    outcome["metrics"]["setup_s"] = outcome["t_first"] - T_PROCESS
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(outcome["memory_peak_bytes"]),
              "card": harness.power_limit()}
    if args.trace:
        trace = outcome["trace"] or {}
        device.update(busy_s=trace.get("busy_s", 0.0),
                      window_s=trace.get("window_s", 0.0))
        outcome["breakdown"] = {k: trace[k] for k in ("device_ops",
                                                      "idle_gaps")
                                if k in trace}
    line = harness.result_line(cell, outcome, bool(args.trace), device)
    shutil.rmtree(scratch, ignore_errors=True)
    for name, value, limit in outcome["checks"]:
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(line), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
