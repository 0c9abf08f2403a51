"""Milliseconds a judge sweep's main thread waits for the prep thread
(canvas-cache fetch, decode of the misses, staging) to hand it a batch:
the port's ``judge.prep_wait`` spans of the traced window over its
``judge.sweep`` spans."""
from touhouimageclassification_tpu_torch.utils import profiling


def read(readings: dict):
    spans = profiling.recorded() if hasattr(profiling, "recorded") else []
    sweeps = sum(s["name"] == "judge.sweep" for s in spans)
    if not sweeps:
        return None
    return sum(s["host_ms"] for s in spans
               if s["name"] == "judge.prep_wait") / sweeps
