"""An open loop of Poisson arrivals into the web demo's ``ModelDaemon``.

Parameters: ``rate_per_s``, ``single_share`` (requests of one image; the
rest take ``multi_min``..``multi_max`` images, evenly), ``pool_images``
(PIL images, sides ``side_min``..``side_max``), ``clients`` (client
threads), ``check_images`` (served images the reference scores),
``wait_s`` (how long past the window's close a request may still come),
``schedule_seed``, ``warm_seconds`` (an open loop of set-up).
A traced run profiles from a quarter into the window until every request
has come back, so that stopping the profiler delays no request.

Every seed sends the same requests: round(rate x seconds) of them, the
same counts of each size and the same exponential gaps (their quantiles,
scaled to span the window), in the order that the mix's ``schedule_seed``
draws, with the same pool images (their sizes in that seed's order too).
``--seed`` draws the pixels, the weights and the checked sample: a tail
depends on where the bursts and the large requests fall, so the order of
arrivals is part of the mix, not of the run. A request is timed from its due time to the return of
``ModelDaemon.predict``; one that fails or never comes counts at the wait's
end. The daemon holds a proxy of the ``Predictor`` that times and counts
each ``predict_images`` call.
"""
from __future__ import annotations

import gc
import math
import queue
import threading
import time

import numpy as np
import torch

from compare import served_gaps
from images import make_pictures
from programs import build_predictor
from reference.serve_plain import pil_canvas, serve_logits
from traced import TracedWindow
from weights import make_weights, vit_shape


class CountingPredictor:
    """The ``Predictor`` with each ``predict_images`` call's image count and
    host milliseconds recorded."""

    def __init__(self, predictor):
        self._inner = predictor
        self.calls: list[tuple[int, float]] = []

    def predict_images(self, images):
        t = time.perf_counter()
        out = self._inner.predict_images(images)
        self.calls.append((len(images), (time.perf_counter() - t) * 1e3))
        return out

    def __getattr__(self, name):
        return getattr(self._inner, name)


def schedule(p: dict, seconds: float):
    """(due seconds, image indices) of every request, in due order."""
    rng = np.random.default_rng([p["schedule_seed"], 5])
    n = max(1, round(p["rate_per_s"] * seconds))
    singles = round(p["single_share"] * n)
    span = p["multi_max"] - p["multi_min"] + 1
    sizes = [1] * singles + [p["multi_min"] + i % span
                             for i in range(n - singles)]
    sizes = rng.permutation(sizes)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps = rng.permutation(gaps)
    due = np.cumsum(gaps)
    due = (due - due[0]) * (seconds / due[-1]) if n > 1 else np.zeros(1)
    return [(float(t), rng.integers(0, p["pool_images"], int(k)).tolist())
            for t, k in zip(due, sizes)]


class Served:
    """The set-up of the cell: the image pool and the daemon over a warmed,
    counted ``Predictor``."""

    def __init__(self, ctx):
        from touhouimageclassification_tpu_torch.web.runtime import ModelDaemon
        p, cfg, dev = ctx.cell.params, ctx.cell.config, ctx.device
        self.shape = vit_shape(cfg)
        self.pool = make_pictures(p["pool_images"], p["side_min"],
                                  p["side_max"], ctx.seed, p["schedule_seed"])
        w0 = make_weights(self.shape, ctx.seed, dev)
        predictor = build_predictor(cfg, w0, dev)
        del w0
        predictor.warmup()
        self.proxy = CountingPredictor(predictor)
        self.daemon = ModelDaemon()
        self.daemon.predictor = self.proxy
        for k in (1, 3, 8):   # the daemon's thread and the host path, warm
            self.daemon.predict(self.pool[:k])
        # a short open loop at the cell's rate warms the batching paths
        offer(ctx, self, p, p["warm_seconds"])
        self.proxy.calls.clear()

    def close(self) -> None:
        if self.daemon.timer:
            self.daemon.timer.cancel()
        self.daemon = self.proxy = None


def offer(ctx, served: Served, p: dict, seconds: float, window=None) -> dict:
    """Sends one window of the schedule; returns each request's latency in
    ms (failed ones and those that never came at the wait's end), results,
    plan and the generator's lateness."""
    plan = schedule(p, seconds)
    results: list = [None] * len(plan)
    done = [math.inf] * len(plan)
    started = [math.inf] * len(plan)
    finished = [False] * len(plan)
    inbox: queue.Queue = queue.Queue()
    daemon, pool = served.daemon, served.pool

    def client():
        while True:
            item = inbox.get()
            if item is None:
                return
            i, t_due = item
            started[i] = time.perf_counter() - t_due
            try:
                results[i] = daemon.predict([pool[j] for j in plan[i][1]])
                done[i] = time.perf_counter()
            except Exception as e:  # a failed request misses every limit
                ctx.log(f"request {i} failed: {e!r}")
            finally:
                finished[i] = True

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(p["clients"])]
    for t in threads:
        t.start()
    trace_from = 0.25 * seconds
    t0 = time.perf_counter()
    for i, (due, _) in enumerate(plan):
        if (window is not None and window.enabled and not window.active
                and not window.done
                and time.perf_counter() - t0 >= trace_from):
            window.start()
        delay = t0 + due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        inbox.put((i, t0 + due))
    deadline = time.perf_counter() + p["wait_s"]
    while time.perf_counter() < deadline and not all(finished):
        time.sleep(0.005)
    if window is not None:
        window.stop()
    for _ in threads:
        inbox.put(None)
    for t in threads:
        t.join(timeout=1.0)
    cap = (deadline - t0) * 1e3
    lat = [min((d - (t0 + due)) * 1e3, cap) for d, (due, _) in zip(done, plan)]
    return {"plan": plan, "results": results, "latency_ms": lat,
            "late_s": [s for s in started if math.isfinite(s)],
            "t0": t0}


def p95(values: list[float]) -> float:
    """The nearest-rank 95th percentile."""
    xs = sorted(values)
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


def run(ctx) -> dict:
    p, dev = ctx.cell.params, ctx.device
    served = Served(ctx)
    shape, pool = served.shape, served.pool
    window = TracedWindow(ctx.trace, ctx.scratch)
    out = offer(ctx, served, p, ctx.seconds, window)
    summary = window.finish()
    plan, results, lat = out["plan"], out["results"], out["latency_ms"]
    calls = list(served.proxy.calls)
    served.close()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    failed = sum(r is None for r in results)
    late = sorted(out["late_s"])
    ctx.log(f"requests {len(plan)}, failed {failed}, p50 "
            f"{sorted(lat)[len(lat) // 2]:.3f} ms, p95 {p95(lat):.3f} ms; "
            f"generator late p95 {1e3 * p95(late) if late else math.nan:.3f} "
            f"ms, max {1e3 * late[-1] if late else math.nan:.3f} ms")

    del served
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the reference: a seeded sample of served requests, the longest in it
    rng = np.random.default_rng([ctx.seed, 9])
    ok = [i for i, r in enumerate(results) if r is not None]
    checks_ok = bool(ok)
    picks, count = [], 0
    if ok:
        longest = max(ok, key=lambda i: len(plan[i][1]))
        for i in [longest] + [int(i) for i in rng.permutation(ok)
                              if i != longest]:
            if count >= p["check_images"]:
                break
            picks.append(i)
            count += len(plan[i][1])
    lim = ctx.cell.limits
    if checks_ok:
        size = (shape["image"], shape["image"])
        canvases = np.stack([pil_canvas(pool[j], size)
                             for i in picks for j in plan[i][1]])
        t_ref = time.perf_counter()
        w0 = make_weights(shape, ctx.seed, dev)
        ref = serve_logits(w0, shape, canvases, dev)
        index = {f"c{k:03d}": k for k in range(shape["classes"])}
        got = [pair for i in picks for pair in results[i]]
        gap, err = served_gaps(ref, torch.tensor([index[c] for c, _ in got]),
                               torch.tensor([c for _, c in got]))
        ctx.log(f"reference: {len(got)} images in "
                f"{time.perf_counter() - t_ref:.3f} s")
    else:
        gap = err = math.inf
    checks = [("logit_gap", gap, lim["logit_gap"]),
              ("confidence_gap", err, lim["confidence_gap"])]
    return {
        "t_first": out["t0"], "attempted": len(plan), "failed": failed,
        "metrics": {"serve_p95_ms": p95(lat)},
        "memory_peak_bytes": peak, "checks": checks,
        "trace": summary,
        "readings": {"kind": "web", "predict_calls": calls,
                     "trace": summary},
    }
