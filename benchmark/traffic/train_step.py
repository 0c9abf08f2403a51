"""Closed-loop training: ``Trainer.train_step`` back to back on batches
uploaded through ``Trainer.stage`` from a host pool drawn from the seed.

Parameters (``workloads/<cell>.json``): ``preset`` (a training preset of
the port), ``batch``, ``canvas`` (side of the uint8 pool images),
``pool_batches`` (distinct batches in the pool), ``check_steps`` (steps of
set-up that the reference follows), ``trace_steps`` (steps in the traced
window), ``ref_block`` (rows a reference block), ``rate_metric`` (the
end-to-end metric that reports the cell's img/s).

Set-up builds the trainer from the seed's weights and runs its first
``check_steps`` steps, which also warm every shape of the window; the
window then continues the same trainer. The reference follows those first
steps from the same weights and batches: each step's loss, every leaf's
first gradient (the optimizer's first moment after one step, over 1 - b1)
and every leaf's change over the steps are compared.
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from compare import leaf_norm_gap, moved_leaves, relative_gap
from programs import build_trainer
from reference.train_plain import BETA1, part_norms, train_steps
from roofline import train_step_flops, vit_forward_flops
from traced import TracedWindow
from weights import make_weights, vit_shape


def make_pool(p: dict, classes: int, seed: int, device):
    """``pool_batches`` batches of uint8 canvases and labels, drawn on the
    device from the seed, kept on the host."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    rows = p["pool_batches"] * p["batch"]
    images = torch.randint(0, 256, (rows, p["canvas"], p["canvas"], 3),
                           generator=gen, device=device, dtype=torch.uint8)
    labels = torch.randint(0, classes, (rows,), generator=gen, device=device)
    images, labels = images.cpu().numpy(), labels.cpu().numpy()
    b = p["batch"]
    return [{"image": images[i * b:(i + 1) * b],
             "label": labels[i * b:(i + 1) * b]}
            for i in range(p["pool_batches"])]


@torch.no_grad()
def program_norms(model, optimizer, w0=None) -> dict[str, float]:
    """Per part of a leaf: with ``w0``, the norm of the change from it;
    else the first gradient as AdamW got it (first moment / (1 - b1); zero
    where the optimizer holds no moment, having taken no step)."""
    if w0 is not None:
        return part_norms({name: param.float() - w0[name]
                           for name, param in model.named_parameters()})
    state = optimizer.inner.state
    return part_norms({name: state[param].get("exp_avg",
                                              torch.zeros_like(param))
                       / (1 - BETA1)
                       for name, param in model.named_parameters()})


def run(ctx) -> dict:
    from touhouimageclassification_tpu_torch.ops import attention
    p, cfg, dev = ctx.cell.params, ctx.cell.config, ctx.device
    shape = vit_shape(cfg)
    w0 = make_weights(shape, ctx.seed, dev)
    trainer, state = build_trainer(cfg, p["preset"], p["batch"], ctx.seed, w0,
                                   dev, ctx.scratch)
    pool = make_pool(p, shape["classes"], ctx.seed, dev)
    opt = trainer.cfg.optimizer
    losses = []
    for t in range(p["check_steps"]):
        metrics = trainer.train_step(state, trainer.stage(pool[t]))
        losses.append(metrics["loss"])
        if t == 0:
            grad1 = program_norms(state.model, state.optimizer)
    delta = program_norms(state.model, state.optimizer, w0)
    del w0
    setup_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    window = TracedWindow(ctx.trace, ctx.scratch)
    trace_from = 0.25 * ctx.seconds
    steps = failed = traced = 0
    calls = {}

    def stop_trace():
        if window.active:
            window.stop()
            calls.update(k1=attention.launches - calls["k1"],
                         k2=attention.bwd_launches - calls["k2"])

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_first = time.perf_counter()
    i = p["check_steps"]
    while True:
        if (ctx.trace and not window.done and not window.active
                and time.perf_counter() - t_first >= trace_from):
            calls.update(k1=attention.launches, k2=attention.bwd_launches)
            window.start()
        metrics = trainer.train_step(state, trainer.stage(pool[i % len(pool)]))
        i += 1
        steps += 1
        if not (math.isfinite(metrics["loss"])
                and math.isfinite(metrics["grad_norm"])):
            failed += 1
        if window.active:
            traced += 1
            if traced == p["trace_steps"]:
                stop_trace()
        if time.perf_counter() - t_first >= ctx.seconds:
            break
    t_end = time.perf_counter()
    stop_trace()
    window_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    images = steps * p["batch"]
    elapsed = t_end - t_first
    summary = window.finish()

    del trainer, state, metrics
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    w0 = make_weights(shape, ctx.seed, dev)
    batches = [(torch.from_numpy(b["image"]).to(dev),
                torch.from_numpy(b["label"]).to(dev))
               for b in pool[:p["check_steps"]]]
    ref = train_steps(w0, shape, ctx.seed, batches, opt.learning_rate,
                      opt.weight_decay, block=p["ref_block"])
    ctx.log(f"reference: {time.perf_counter() - t_ref:.3f} s; losses "
            f"program {losses} reference {ref['loss']}")
    g_gap, g_leaf = leaf_norm_gap(grad1, ref["grad1"])
    d_gap, d_leaf = leaf_norm_gap(delta, ref["delta"], moved_leaves(ref["grad1"]))
    ctx.log(f"worst leaves: first gradient {g_leaf}, change {d_leaf}")
    lim = ctx.cell.limits
    checks = [("loss_rel_gap", relative_gap(losses, ref["loss"]),
               lim["loss_rel_gap"]),
              ("grad1_leaf_gap", g_gap, lim["grad1_leaf_gap"]),
              ("change_leaf_gap", d_gap, lim["change_leaf_gap"])]
    fwd = vit_forward_flops(shape["hidden"], shape["layers"], shape["mlp"],
                            shape["image"], shape["patch"], shape["classes"])
    return {
        "t_first": t_first, "attempted": steps, "failed": failed,
        "metrics": {p["rate_metric"]: images / elapsed,
                    "train_peak_gib": window_peak / 2 ** 30},
        "memory_peak_bytes": max(setup_peak, window_peak),
        "checks": checks,
        "trace": summary,
        # the rate's window leaves out the profiled steps and the
        # profiler's starting and stopping
        "readings": {"kind": "train", "batch": p["batch"], "shape": shape,
                     "images": images - traced * p["batch"],
                     "window_s": elapsed - window.cost_s,
                     "trace": summary, "trace_steps": traced, "calls": calls,
                     "flops_per_image": train_step_flops(fwd)},
    }
