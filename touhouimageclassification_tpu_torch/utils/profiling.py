"""Tracing and step timing (counterpart of the JAX package's
``utils/profiling.py``): the trainer's ``TrainConfig.profile_dir`` knob
traces a window of steps with ``torch.profiler``, and :class:`StepTimer`
times steps to the device's completion."""
from __future__ import annotations

import contextlib
import os
import statistics
import time

import torch


@contextlib.contextmanager
def trace(logdir: str | None):
    """``torch.profiler`` trace (CPU activity, and CUDA where there is a
    GPU) of the enclosed code, written as a Chrome trace
    ``<logdir>/trace.<pid>.<ms>.json``; no-op when ``logdir`` is falsy."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace.{os.getpid()}.{int(time.time() * 1e3)}.json"))


class StepTimer:
    """Wall-clock step statistics with device-completion accounting.

    Call ``lap(value)`` once per step with a tensor the step produced; on a
    CUDA tensor the timer synchronises its device's current stream first,
    so a lap covers the device's work, not just its dispatch."""

    def __init__(self):
        self.times: list[float] = []
        self._last = None

    def start(self):
        self._last = time.perf_counter()

    def lap(self, value: torch.Tensor | None = None) -> float:
        if torch.is_tensor(value) and value.is_cuda:
            torch.cuda.current_stream(value.device).synchronize()
        now = time.perf_counter()
        dt = now - (self._last if self._last is not None else now)
        self._last = now
        self.times.append(dt)
        return dt

    def summary(self) -> dict:
        if not self.times:
            return {}
        xs = sorted(self.times)
        return {
            "steps": len(xs),
            "mean_s": statistics.fmean(xs),
            "p50_s": xs[len(xs) // 2],
            "p95_s": xs[int(len(xs) * 0.95)],
            "max_s": xs[-1],
        }
