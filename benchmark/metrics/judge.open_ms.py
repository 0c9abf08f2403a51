"""Milliseconds a judge sweep takes to open: the folder walk, the canvas
cache's scan, fingerprint (an ``os.stat`` of every file) and open, and the
CSV's, up to the first batch's prep: the port's ``judge.open`` spans of the
traced window over its ``judge.sweep`` spans."""
from touhouimageclassification_tpu_torch.utils import profiling


def read(readings: dict):
    spans = profiling.recorded() if hasattr(profiling, "recorded") else []
    sweeps = sum(s["name"] == "judge.sweep" for s in spans)
    if not sweeps:
        return None
    return sum(s["host_ms"] for s in spans
               if s["name"] == "judge.open") / sweeps
