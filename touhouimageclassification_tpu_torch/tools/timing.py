"""Timing on one GPU for the measurement tools: CUDA-event medians, the
card's published peaks and its name and power limit."""
from __future__ import annotations

import statistics
import subprocess

PEAK_BF16 = 989e12  # H100 SXM tensor cores, dense (NVIDIA's data sheet)
PEAK_BYTES = 3.35e12
SPIN_CYCLES = 10_000_000  # ~5 ms of an H100's clock: covers 20 host launches


def cuda_ms(torch, fn, reps: int, calls: int = 1) -> float:
    """Median milliseconds per ``fn()`` between two CUDA events, after 5
    warm-up calls. With ``calls`` 1 the events take one call, its host
    launch time included where that is the longer; with ``calls`` > 1 a spin
    kernel first holds the card busy while the host enqueues the calls, which
    then run back to back: the device's time alone."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if calls > 1:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
