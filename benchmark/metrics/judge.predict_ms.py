"""Milliseconds a judge sweep spends predicting its batches (the forward's
launches and the fetch of its results, which waits for the device): the
port's ``judge.predict`` spans of the traced window over its
``judge.sweep`` spans."""
from touhouimageclassification_tpu_torch.utils import profiling


def read(readings: dict):
    spans = profiling.recorded() if hasattr(profiling, "recorded") else []
    sweeps = sum(s["name"] == "judge.sweep" for s in spans)
    if not sweeps:
        return None
    return sum(s["host_ms"] for s in spans
               if s["name"] == "judge.predict") / sweeps
