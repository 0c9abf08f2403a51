"""Back-to-back dataset sweeps of ``full_judge`` over a JPEG folder written
from the seed, fed by the canvas cache that a set-up sweep fills.

Parameters: ``images``, ``side_min``/``side_max`` (pixel sides of the
JPEGs), ``quality`` (JPEG), ``batch`` (``full_judge``'s batch size),
``canvas_cache`` (its mode), ``check_images`` (rows the reference
scores), ``trace_seconds`` (at least this long a traced window, in whole
sweeps).

The window runs sweeps until one ends past ``--seconds``; the rate divides
the images of every sweep by the time they took, the last one's overrun
included. Every sweep writes its own CSV. After the window the reference
decodes a seeded sample of the CSV rows' files itself and scores them:
the widest gap of the written class's logit below the best, and of the
written confidence from the reference's probability of that class.
"""
from __future__ import annotations

import csv
import gc
import time

import numpy as np
import torch

from compare import served_gaps
from images import write_folder
from programs import build_predictor, class_names
from reference.serve_plain import decode_canvas, serve_logits
from roofline import vit_forward_flops
from traced import TracedWindow
from weights import make_weights, vit_shape

CANVAS = (256, 256)  # full_judge's cache canvas for a 224 model


def read_rows(path) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def run(ctx) -> dict:
    from touhouimageclassification_tpu_torch.data import native_loader
    from touhouimageclassification_tpu_torch.infer.serve import full_judge
    from touhouimageclassification_tpu_torch.ops import attention
    # the reference decodes with PIL; say which decoder filled the cache
    ctx.log("program's JPEG decoder: "
            + ("native" if native_loader.available() else "PIL"))
    p, cfg, dev = ctx.cell.params, ctx.cell.config, ctx.device
    shape = vit_shape(cfg)
    names = class_names(shape["classes"])
    folder = ctx.scratch / "judge_data"
    write_folder(str(folder), p["images"], names, p["side_min"], p["side_max"],
                 p["quality"], ctx.seed)
    w0 = make_weights(shape, ctx.seed, dev)
    predictor = build_predictor(cfg, w0, dev)
    del w0

    def sweep(k):
        out = ctx.scratch / f"sweep_{k:04d}.csv"
        full_judge(predictor, str(folder), output=str(out),
                   batch_size=p["batch"], progress=False,
                   canvas_cache=p["canvas_cache"])
        return out

    sweep(0)  # fills the canvas cache and warms the bucket
    window = TracedWindow(ctx.trace, ctx.scratch)
    calls, traced = {}, []

    def stop_trace():
        if window.active:
            window.stop()
            calls["k1"] = attention.launches - calls["k1"]

    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_first = time.perf_counter()
    outputs, durations = [], []
    while True:
        now = time.perf_counter() - t_first
        if window.active and now - window_from >= p["trace_seconds"]:
            stop_trace()
        if (ctx.trace and not window.done and not window.active
                and now >= 0.25 * ctx.seconds):
            window_from = now
            calls["k1"] = attention.launches
            window.start()
        if now >= ctx.seconds:
            break
        t_sweep = time.perf_counter()
        outputs.append(sweep(len(outputs) + 1))
        durations.append(time.perf_counter() - t_sweep)
        if window.active:
            traced.append(len(outputs) - 1)
    elapsed = time.perf_counter() - t_first
    stop_trace()
    ctx.log(f"sweeps: {len(durations)}, seconds each: "
            + " ".join(f"{d:.3f}" for d in durations)
            + f"; torch threads {torch.get_num_threads()}")
    summary = window.finish()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    rows = [read_rows(o) for o in outputs]
    scored = sum(len(r) for r in rows)
    attempted = len(outputs) * p["images"]
    traced_rows = sum(len(rows[k]) for k in traced)

    del predictor
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng([ctx.seed, 3])
    flat = [(k, j) for k, r in enumerate(rows) for j in range(len(r))]
    picks = [flat[i] for i in rng.choice(len(flat), min(p["check_images"],
                                                        len(flat)),
                                         replace=False)]
    sample = [rows[k][j] for k, j in picks]
    t_ref = time.perf_counter()
    canvases = np.stack([decode_canvas(r["path"], CANVAS) for r in sample])
    w0 = make_weights(shape, ctx.seed, dev)
    ref = serve_logits(w0, shape, canvases, dev)
    index = {n: i for i, n in enumerate(names)}
    served = torch.tensor([index[r["predicted_class"]] for r in sample])
    conf = torch.tensor([float(r["confidence"]) for r in sample])
    gap, err = served_gaps(ref, served, conf)
    ctx.log(f"reference: {len(sample)} rows in "
            f"{time.perf_counter() - t_ref:.3f} s")
    lim = ctx.cell.limits
    checks = [("logit_gap", gap, lim["logit_gap"]),
              ("confidence_gap", err, lim["confidence_gap"])]
    fwd = vit_forward_flops(shape["hidden"], shape["layers"], shape["mlp"],
                            shape["image"], shape["patch"], shape["classes"])
    return {
        "t_first": t_first, "attempted": attempted,
        "failed": attempted - scored,
        "metrics": {"judge_img_per_s": scored / elapsed},
        "memory_peak_bytes": peak, "checks": checks,
        "trace": summary,
        # the rate's window leaves out the profiled sweeps and the
        # profiler's starting and stopping
        "readings": {"kind": "judge", "batch": p["batch"], "shape": shape,
                     "images": scored - traced_rows,
                     "window_s": elapsed - window.cost_s,
                     "trace": summary, "calls": calls,
                     "flops_per_image": fwd},
    }
