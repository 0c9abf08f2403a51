"""Closed-loop training fed by the port's loader: ``Trainer.train_step`` on
the batches of ``HostImageLoader`` (``data/loader.py``) over a JPEG folder
written from the seed, epoch after epoch (``set_epoch``), as
``train/ntrain.py`` feeds its steps.

Parameters (``workloads/<cell>.json``): ``preset``, ``batch``, ``canvas``
(the loader's decode canvas), ``images``, ``side_min``/``side_max`` and
``quality`` of the JPEGs, ``check_steps``, ``trace_steps``, ``ref_block``,
``rate_metric``. The loader keeps its defaults (decode threads, two
batches prefetched, no canvas cache) and shuffles with the run's seed.

Set-up writes the folder, builds the loader and the trainer, and runs the
first ``check_steps`` steps on the loader's first batches, which also warm
and capture every shape of the window; the window continues the same
loader and trainer. After it, the reference decodes the files of those
batches itself (PIL, as ``reference/serve_plain.decode_canvas``), in the
order its own shuffle of the folder gives (``numpy.random.default_rng(
seed + epoch).permutation`` of the sorted files): ``canvas_gap`` is the
largest |program - reference| of a canvas's uint8 levels (a batch whose
labels differ reads 255), and the train checks of ``train_step`` follow the
first steps on the reference's own canvases and labels.
"""
from __future__ import annotations

import gc
import itertools
import os
import time

import numpy as np
import torch

import harness
from compare import leaf_norm_gap, moved_leaves, relative_gap
from images import write_folder
from programs import build_trainer, class_names
from reference.serve_plain import decode_canvas
from reference.train_plain import train_steps
from roofline import train_step_flops, vit_forward_flops
from train_window import closed_loop
from weights import make_weights, vit_shape


def reference_batches(root: str, seed: int, batch: int, count: int,
                      canvas: tuple[int, int]):
    """The first ``count`` batches of epoch 0 as the reference reads the
    folder: sorted class directories and files, shuffled by the seed."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d))
                     and not d.startswith("."))
    files = [(os.path.join(root, c, f), label)
             for label, c in enumerate(classes)
             for f in sorted(os.listdir(os.path.join(root, c)))]
    order = np.random.default_rng(seed).permutation(len(files))
    out = []
    for i in range(count):
        picked = [files[j] for j in order[i * batch:(i + 1) * batch]]
        out.append({"image": np.stack([decode_canvas(path, canvas)
                                       for path, _ in picked]),
                    "label": np.asarray([lab for _, lab in picked])})
    return out


def canvas_gap(program: list[dict], reference: list[dict]) -> float:
    gap = 0.0
    for got, want in zip(program, reference):
        if not np.array_equal(got["label"], want["label"]):
            return 255.0
        diff = np.abs(got["image"].astype(np.int16)
                      - want["image"].astype(np.int16))
        gap = max(gap, float(diff.max()))
    return gap


def run(ctx) -> dict:
    from touhouimageclassification_tpu_torch.data import (HostImageLoader,
                                                          scan_image_folder)
    from touhouimageclassification_tpu_torch.data import native_loader
    ctx.log("program's JPEG decoder: "
            + ("native" if native_loader.available() else "PIL"))
    step_driver = harness.driver_module("train_step")
    p, cfg, dev = ctx.cell.params, ctx.cell.config, ctx.device
    shape = vit_shape(cfg)
    root = str(ctx.scratch / "train_data")
    write_folder(root, p["images"], class_names(shape["classes"]),
                 p["side_min"], p["side_max"], p["quality"], ctx.seed)
    canvas = (p["canvas"], p["canvas"])
    loader = HostImageLoader(scan_image_folder(root, persist_class_map=False),
                             batch_size=p["batch"], canvas=canvas,
                             shuffle=True, seed=ctx.seed, drop_last=True)
    ctx.log(f"loader: {loader.num_threads} decode threads; host "
            f"{os.cpu_count()} CPUs, {len(os.sched_getaffinity(0))} usable")

    def epochs():
        for epoch in itertools.count():
            loader.set_epoch(epoch)
            yield from loader

    feed = epochs()
    w0 = make_weights(shape, ctx.seed, dev)
    trainer, state = build_trainer(cfg, p["preset"], p["batch"], ctx.seed, w0,
                                   dev, ctx.scratch)
    opt = trainer.cfg.optimizer
    losses, first = [], []
    for t in range(p["check_steps"]):
        batch = next(feed)
        first.append({"image": batch["image"].copy(),
                      "label": batch["label"].copy()})
        metrics = trainer.train_step(state, trainer.stage(batch))
        losses.append(metrics["loss"])
        if t == 0:
            grad1 = step_driver.program_norms(state.model, state.optimizer)
    delta = step_driver.program_norms(state.model, state.optimizer, w0)
    del w0
    setup_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    w = closed_loop(ctx, trainer, state, lambda: next(feed), p["trace_steps"])
    images = w["steps"] * p["batch"]
    feed.close()

    del trainer, state, metrics
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref_batches = reference_batches(root, ctx.seed, p["batch"],
                                    p["check_steps"], canvas)
    gap = canvas_gap(first, ref_batches)
    w0 = make_weights(shape, ctx.seed, dev)
    batches = [(torch.from_numpy(b["image"]).to(dev),
                torch.from_numpy(b["label"]).to(dev)) for b in ref_batches]
    ref = train_steps(w0, shape, ctx.seed, batches, opt.learning_rate,
                      opt.weight_decay, block=p["ref_block"])
    ctx.log(f"reference: {time.perf_counter() - t_ref:.3f} s; losses "
            f"program {losses} reference {ref['loss']}")
    g_gap, g_leaf = leaf_norm_gap(grad1, ref["grad1"])
    d_gap, d_leaf = leaf_norm_gap(delta, ref["delta"], moved_leaves(ref["grad1"]))
    ctx.log(f"worst leaves: first gradient {g_leaf}, change {d_leaf}")
    lim = ctx.cell.limits
    checks = [("canvas_gap", gap, lim["canvas_gap"]),
              ("loss_rel_gap", relative_gap(losses, ref["loss"]),
               lim["loss_rel_gap"]),
              ("grad1_leaf_gap", g_gap, lim["grad1_leaf_gap"]),
              ("change_leaf_gap", d_gap, lim["change_leaf_gap"])]
    fwd = vit_forward_flops(shape["hidden"], shape["layers"], shape["mlp"],
                            shape["image"], shape["patch"], shape["classes"])
    return {
        "t_first": w["t_first"], "attempted": w["steps"],
        "failed": w["failed"],
        "metrics": {p["rate_metric"]: images / w["elapsed"],
                    "train_peak_gib": w["peak"] / 2 ** 30},
        "memory_peak_bytes": max(setup_peak, w["peak"]),
        "checks": checks,
        "trace": w["summary"],
        "readings": {"kind": "train", "batch": p["batch"], "shape": shape,
                     "images": images - w["traced"] * p["batch"],
                     "window_s": w["elapsed"] - w["cost_s"],
                     "trace": w["summary"], "trace_steps": w["traced"],
                     "calls": w["calls"],
                     "flops_per_image": train_step_flops(fwd)},
    }
