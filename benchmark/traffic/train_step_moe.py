"""Closed-loop V-MoE training: ``Trainer.train_step`` with ``VMoETask``
back to back on batches uploaded through ``Trainer.stage`` from a host
pool drawn from the seed, on one expert-parallel card's share of the
experts (``configs/<config>.json``: ``num_experts_held``).

Parameters (``workloads/<cell>.json``) as ``train_step``'s: ``preset``,
``batch``, ``canvas``, ``pool_batches``, ``check_steps``, ``trace_steps``,
``rate_metric`` (a reference block is a routing group).

Set-up builds the trainer from the seed's weights and runs its first
``check_steps`` steps, which also warm and capture every shape of the
window; the window then continues the same trainer. The reference
(``reference/train_moe_plain.py``) follows those first steps from the same
weights and batches, redrawing the router's noise: each step's loss, every
leaf's first gradient and every leaf's change are compared as
``train_step`` compares them, and ``route_flip_share``: the share of step
0's assignments (every MoE layer, group, choice and token) whose expert or
kept status differs from the reference's.
"""
from __future__ import annotations

import gc
import time

import torch

import harness
from compare import leaf_norm_gap, moved_leaves, relative_gap
from moe_programs import build_vmoe_trainer
from moe_weights import make_vmoe_weights, moe_spec, vmoe_shape
from reference.train_moe_plain import route_flip_share, train_steps
from roofline_moe import vmoe_dense_forward_flops
from train_window import closed_loop


def record_routes(model):
    """Wrap each MoE layer's ``route`` to keep (expert, kept) of its plan,
    in layer order; returns the list and a function that unwraps them."""
    from touhouimageclassification_tpu_torch.models.vmoe import MoEMlp
    layers = [m for m in model.modules() if isinstance(m, MoEMlp)]
    routes = []

    def wrap(route):
        def recorded(x, generator):
            plan, gates, aux = route(x, generator)
            routes.append((plan.expert.detach().clone(),
                           plan.kept.detach().clone()))
            return plan, gates, aux
        return recorded

    for layer in layers:
        layer.route = wrap(layer.route)

    def unwrap():
        for layer in layers:
            del layer.route
    return routes, unwrap


def run(ctx) -> dict:
    step_driver = harness.driver_module("train_step")
    p, cfg, dev = ctx.cell.params, ctx.cell.config, ctx.device
    shape = vmoe_shape(cfg)
    w0 = make_vmoe_weights(shape, ctx.seed, dev)
    trainer, state = build_vmoe_trainer(cfg, p["preset"], p["batch"],
                                        ctx.seed, w0, dev, ctx.scratch)
    pool = step_driver.make_pool(p, shape["classes"], ctx.seed, dev)
    opt = trainer.cfg.optimizer
    losses = []
    routes, unwrap = record_routes(state.model)
    for t in range(p["check_steps"]):
        metrics = trainer.train_step(state, trainer.stage(pool[t]))
        losses.append(metrics["loss"])
        if t == 0:
            unwrap()
            routes = [(e.cpu(), k.cpu()) for e, k in routes]
            grad1 = step_driver.program_norms(state.model, state.optimizer)
    delta = step_driver.program_norms(state.model, state.optimizer, w0)
    del w0
    setup_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    ctx.log(f"graph: captures {trainer.graph_captures}, fallbacks "
            f"{trainer.graph_fallbacks}")

    i = p["check_steps"]

    def next_batch():
        nonlocal i
        i += 1
        return pool[(i - 1) % len(pool)]

    w = closed_loop(ctx, trainer, state, next_batch, p["trace_steps"])
    ctx.log(f"window: {w['steps']} steps; peak allocated "
            f"{w['peak'] / 2 ** 30:.3f} GiB, reserved "
            f"{w['reserved_peak'] / 2 ** 30:.3f} GiB")
    images = w["steps"] * p["batch"]

    del trainer, state, metrics
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    w0 = make_vmoe_weights(shape, ctx.seed, dev)
    batches = [(torch.from_numpy(b["image"]).to(dev),
                torch.from_numpy(b["label"]).to(dev))
               for b in pool[:p["check_steps"]]]
    ref = train_steps(w0, shape, moe_spec(shape), ctx.seed, batches,
                      opt.learning_rate, opt.weight_decay)
    ctx.log(f"reference: {time.perf_counter() - t_ref:.3f} s; losses "
            f"program {losses} reference {ref['loss']}")
    g_gap, g_leaf = leaf_norm_gap(grad1, ref["grad1"])
    d_gap, d_leaf = leaf_norm_gap(delta, ref["delta"], moved_leaves(ref["grad1"]))
    ctx.log(f"worst leaves: first gradient {g_leaf}, change {d_leaf}")
    lim = ctx.cell.limits
    checks = [("loss_rel_gap", relative_gap(losses, ref["loss"]),
               lim["loss_rel_gap"]),
              ("grad1_leaf_gap", g_gap, lim["grad1_leaf_gap"]),
              ("change_leaf_gap", d_gap, lim["change_leaf_gap"]),
              ("route_flip_share", route_flip_share(routes, ref["routes"]),
               lim["route_flip_share"])]
    return {
        "t_first": w["t_first"], "attempted": w["steps"],
        "failed": w["failed"],
        "metrics": {p["rate_metric"]: images / w["elapsed"],
                    "train_peak_gib": w["peak"] / 2 ** 30},
        "memory_peak_bytes": max(setup_peak, w["peak"]),
        "checks": checks,
        "trace": w["summary"],
        # the rate's window leaves out the profiled steps and the
        # profiler's starting and stopping
        "readings": {"kind": "train", "batch": p["batch"], "shape": shape,
                     "images": images - w["traced"] * p["batch"],
                     "window_s": w["elapsed"] - w["cost_s"],
                     "trace": w["summary"], "trace_steps": w["traced"],
                     "calls": w["calls"],
                     "dense_flops_per_image": vmoe_dense_forward_flops(shape)},
    }
