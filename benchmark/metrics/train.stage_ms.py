"""Host milliseconds a training step spends in ``Trainer.stage`` (the
batch's pinned host copy and the start of its upload): the port's
``trainer.stage`` spans of the traced window over its ``trainer.step``
spans."""
from touhouimageclassification_tpu_torch.utils import profiling


def read(readings: dict):
    spans = profiling.recorded() if hasattr(profiling, "recorded") else []
    steps = sum(s["name"] == "trainer.step" for s in spans)
    if not steps:
        return None
    return sum(s["host_ms"] for s in spans
               if s["name"] == "trainer.stage") / steps
