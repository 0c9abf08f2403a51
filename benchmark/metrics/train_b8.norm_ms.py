"""Host milliseconds a batch-8 training step spends launching the
gradients' global norm (a square, a sum and an add for each parameter
tensor): the port's ``trainer.norm`` spans of the traced window over its
``trainer.step`` spans."""
from touhouimageclassification_tpu_torch.utils import profiling


def read(readings: dict):
    spans = profiling.recorded() if hasattr(profiling, "recorded") else []
    steps = sum(s["name"] == "trainer.step" for s in spans)
    if not steps:
        return None
    return sum(s["host_ms"] for s in spans
               if s["name"] == "trainer.norm") / steps
