"""The share of a judge sweep's images that the canvas cache did not hold
and that were decoded: the ``misses`` over ``hits`` + ``misses`` that the
port's ``judge.fetch`` spans of the traced window's sweeps counted."""
from touhouimageclassification_tpu_torch.utils import profiling


def read(readings: dict):
    spans = profiling.recorded() if hasattr(profiling, "recorded") else []
    fetches = [s["counts"] for s in spans if s["name"] == "judge.fetch"]
    looked = sum(c["hits"] + c["misses"] for c in fetches)
    if not any(s["name"] == "judge.sweep" for s in spans) or not looked:
        return None
    return 100.0 * sum(c["misses"] for c in fetches) / looked
