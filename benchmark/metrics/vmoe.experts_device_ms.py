"""Device milliseconds a V-MoE training step spends in the held experts'
products: the port's ``moe.experts`` spans of the traced window, forward
and backward, over its ``trainer.step`` spans (on the step graph, the
device times between the graph's own timing nodes)."""
from touhouimageclassification_tpu_torch.utils import profiling


def read(readings: dict):
    spans = profiling.recorded() if hasattr(profiling, "recorded") else []
    steps = sum(s["name"] == "trainer.step" for s in spans)
    ms = [s["device_ms"] for s in spans if s["name"] == "moe.experts"]
    if not steps or not ms or None in ms:
        return None
    return sum(ms) / steps
