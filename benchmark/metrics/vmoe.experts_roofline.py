"""The held experts' share of the bf16 peak while they run, in %: the FLOPs
of the assignments kept on them (``kept_held`` of the traced window's
forward ``moe.route`` spans, each two products of hidden x mlp, three
times for the step; ``roofline_moe.experts_roofline``) over the device
time of the window's ``moe.experts`` spans, forward and backward."""
from roofline_moe import experts_roofline
from touhouimageclassification_tpu_torch.utils import profiling


def read(readings: dict):
    spans = profiling.recorded() if hasattr(profiling, "recorded") else []
    kept = sum(s["counts"].get("kept_held", 0) for s in spans
               if s["name"] == "moe.route")
    ms = [s["device_ms"] for s in spans if s["name"] == "moe.experts"]
    if not kept or not ms or None in ms or not sum(ms):
        return None
    shape = readings["shape"]
    return experts_roofline(kept, shape["hidden"], shape["mlp"],
                            sum(ms) / 1e3)
