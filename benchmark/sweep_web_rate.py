"""Finds a web cell's knee once: the unloaded bucket-1 latency, then the
open loop at each of several rates, in one process over one set-up.

    python3 benchmark/sweep_web_rate.py --workload <cell> --seed 5 \
        --seconds 30 --rates 32 48 64

``<cell>`` is a cell of ``BENCHMARK.json`` whose driver is
``web_open_loop``; its own rate is ignored. It
prints one JSON line a rate: p50 and p95 of the requests' latency, the
median latency of the last quarter of requests over that of the first
(above 1 the backlog grew), the generator's lateness, images a device
call. The knee is the highest rate whose backlog does not grow and whose
p95 stays under ``--limit-x`` times the unloaded bucket-1 p50.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
for _p in (str(BENCH_DIR), str(BENCH_DIR.parent)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--limit-x", type=float, default=5.0)
    args = ap.parse_args(argv)
    cell = harness.resolve_cell(args.workload)
    web = harness.driver_module(cell.driver)
    ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds,
                          trace=False, device=torch.device("cuda", 0),
                          t_process=0.0,
                          scratch=harness.scratch_dir(cell.name + "_sweep"))
    served = web.Served(ctx)
    alone = []
    for i in range(60):
        t = time.perf_counter()
        served.daemon.predict([served.pool[i % len(served.pool)]])
        alone.append((time.perf_counter() - t) * 1e3)
    base = statistics.median(alone)
    print(json.dumps({"unloaded_bucket1_ms": {"p50": base,
                                              "p95": web.p95(alone)},
                      "limit_ms": args.limit_x * base}), flush=True)
    for rate in args.rates:
        p = dict(cell.params, rate_per_s=rate)
        served.proxy.calls.clear()
        out = web.offer(ctx, served, p, args.seconds)
        lat = out["latency_ms"]
        q = max(1, len(lat) // 4)
        calls = served.proxy.calls
        print(json.dumps({
            "rate_per_s": rate, "requests": len(lat),
            "p50_ms": statistics.median(lat), "p95_ms": web.p95(lat),
            "growth": statistics.median(lat[-q:]) / statistics.median(lat[:q]),
            "late_p95_ms": 1e3 * web.p95(out["late_s"]),
            "images_per_call": sum(n for n, _ in calls) / max(len(calls), 1),
            "failed": sum(r is None for r in out["results"])}), flush=True)
    served.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
