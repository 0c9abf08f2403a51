"""The traced window of a ``--trace 1`` run: ``torch.profiler`` over a part
of the measured window, its Chrome trace reduced to what the per-layer
metrics read.

The window is marked by a ``record_function`` span, and its device time is
the union of the kernel, copy and set intervals inside it. Launches are
the CUDA runtime's and driver's launch calls. An idle gap of the device is
named by the innermost host operation running at its midpoint.
"""
from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict

WINDOW_SPAN = "bench.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch")
IDLE_LABEL = "host outside any torch op"
TOP = 10


def _profile():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


class TracedWindow:
    """``start()`` and ``stop()`` bracket the traced part of the window, once;
    ``finish()``, after the window, reduces the trace into ``summary``.
    ``cost_s`` is the host time from ``start()`` to the end of ``stop()``,
    the profiler's own starting and stopping included. Inactive when
    ``enabled`` is false."""

    def __init__(self, enabled: bool, scratch):
        self.enabled = enabled
        self.path = os.path.join(str(scratch), "trace.json")
        self.summary = None
        self.active = self.done = False
        self.cost_s = 0.0
        self._prof = self._span = None
        self._t_begin = 0.0
        if enabled:
            self._warm()

    @staticmethod
    def _warm() -> None:
        """The profiler's first start initialises CUPTI, which takes
        seconds: done here, in set-up, on a trivial kernel."""
        import torch
        with _profile():
            torch.ones(8, device="cuda").sum().item()

    def start(self) -> None:
        if not self.enabled or self.active or self.done:
            return
        import torch
        from torch.profiler import record_function
        self._t_begin = time.perf_counter()
        torch.cuda.synchronize()
        self._prof = _profile()
        self._prof.start()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()
        self.active = True

    def stop(self) -> None:
        if not self.active:
            return
        import torch
        torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._prof.stop()
        self.active, self.done = False, True
        self.cost_s = time.perf_counter() - self._t_begin

    def finish(self) -> dict | None:
        """The trace's reduction (``summarize``), once the window is over."""
        self.stop()
        if self._prof is not None:
            self._prof.export_chrome_trace(self.path)
            self._prof = self._span = None
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
            os.remove(self.path)
            self.summary = summarize(events)
        return self.summary


def _union(intervals):
    """Total length and merged list of (start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def summarize(events: list[dict]) -> dict:
    """The window's device busy time, kernel totals by name, launch count
    and idle gaps by host activity, all in seconds (trace times are us)."""
    spans = [e for e in events if e.get("name") == WINDOW_SPAN
             and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not spans:
        return {}
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    device, kernels = [], defaultdict(lambda: [0, 0.0])
    launches = 0
    host = defaultdict(list)   # tid -> [(start, end, name)]
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            s, t = max(ts, w0), min(ts + dur, w1)
            if t > s:
                device.append((s, t))
                k = kernels[e["name"]]
                k[0] += 1
                k[1] += (t - s) * 1e-6
        elif cat in ("cuda_runtime", "cuda_driver"):
            if w0 <= ts <= w1 and e["name"] in LAUNCH_NAMES:
                launches += 1
            host[e.get("tid")].append((ts, ts + dur, e["name"]))
        elif cat == "cpu_op":
            host[e.get("tid")].append((ts, ts + dur, e["name"]))
    busy_us, merged = _union(device)
    gaps = []
    edge = w0
    for s, e in merged + [[w1, w1]]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    by_label = defaultdict(float)
    lookup = {tid: (sorted(ops), [o[0] for o in sorted(ops)])
              for tid, ops in host.items()}
    for s, e in gaps:
        by_label[_host_label(lookup, 0.5 * (s + e))] += (e - s) * 1e-6
    top_kernels = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "launches": launches,
        "kernels": {name: {"count": c, "seconds": s}
                    for name, (c, s) in kernels.items()},
        "device_ops": [[name[:120], s] for name, (_, s) in top_kernels[:TOP]],
        "idle_gaps": [[label, s] for label, s in sorted(
            by_label.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def _host_label(lookup, t: float) -> str:
    """The innermost host op running at ``t`` on any thread: the one that
    started last among those that contain ``t``."""
    best = None
    for ops, starts in lookup.values():
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 64, -1), -1):
            s, e, name = ops[j]
            if e >= t:
                if best is None or s > best[0]:
                    best = (s, name)
                break
    return best[1] if best else IDLE_LABEL


def kernel_seconds(summary: dict, needle: str) -> tuple[int, float]:
    """(launches, seconds) of the kernels whose name contains ``needle``."""
    count, seconds = 0, 0.0
    for name, k in (summary or {}).get("kernels", {}).items():
        if needle in name:
            count += k["count"]
            seconds += k["seconds"]
    return count, seconds
