"""The measured window of a closed-loop training cell, shared by the
drivers that feed ``Trainer.train_step`` from a source of their own: steps
back to back until ``--seconds``, a profiled part of them in a ``--trace
1`` run, the images of every step over the window's seconds."""
from __future__ import annotations

import math
import time

import torch

from traced import TracedWindow


def closed_loop(ctx, trainer, state, next_batch, trace_steps: int) -> dict:
    """Steps on ``next_batch()`` (a host batch) until ``ctx.seconds`` have
    passed; in a traced run the profiler covers ``trace_steps`` steps from
    a quarter of the window on. Returns the steps, the failed ones (a loss
    or gradient norm not finite), the traced ones, the first step's start
    and the window's seconds, the attention launches of the traced steps,
    the peak allocated over the window and the trace's reduction (None
    untraced). The profiler's own starting and stopping is ``cost_s``."""
    from touhouimageclassification_tpu_torch.ops import attention
    dev = ctx.device
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
    while True:
        if (ctx.trace and not window.done and not window.active
                and time.perf_counter() - t_first >= trace_from):
            calls.update(k1=attention.launches, k2=attention.bwd_launches)
            window.start()
        metrics = trainer.train_step(state, trainer.stage(next_batch()))
        steps += 1
        if not (math.isfinite(metrics["loss"])
                and math.isfinite(metrics["grad_norm"])):
            failed += 1
        if window.active:
            traced += 1
            if traced == trace_steps:
                stop_trace()
        if time.perf_counter() - t_first >= ctx.seconds:
            break
    elapsed = time.perf_counter() - t_first
    stop_trace()
    peak = reserved = 0
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.memory_stats().get("reserved_bytes.all.peak", 0)
    return {"steps": steps, "failed": failed, "traced": traced,
            "t_first": t_first, "elapsed": elapsed, "calls": calls,
            "peak": peak, "reserved_peak": reserved,
            "summary": window.finish(), "cost_s": window.cost_s}
