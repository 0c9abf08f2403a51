"""Device milliseconds a V-MoE training step spends moving tokens to and
from the experts: the port's ``moe.route`` (router, noise, top-k, plan),
``moe.dispatch`` and ``moe.combine`` spans of the traced window, forward
and backward, over its ``trainer.step`` spans."""
from touhouimageclassification_tpu_torch.utils import profiling

PHASES = ("moe.route", "moe.dispatch", "moe.combine")


def read(readings: dict):
    spans = profiling.recorded() if hasattr(profiling, "recorded") else []
    steps = sum(s["name"] == "trainer.step" for s in spans)
    ms = [s["device_ms"] for s in spans if s["name"] in PHASES]
    if not steps or not ms or None in ms:
        return None
    return sum(ms) / steps
