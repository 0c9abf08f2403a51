"""Host milliseconds a training step waits in the guard's fetch (the
device -> host copy of the step's loss and gradient norm, which waits for
the device to finish the step's forward, backward and norm): the port's
``trainer.fetch`` spans of the traced window over its ``trainer.step``
spans."""
from touhouimageclassification_tpu_torch.utils import profiling


def read(readings: dict):
    spans = profiling.recorded() if hasattr(profiling, "recorded") else []
    steps = sum(s["name"] == "trainer.step" for s in spans)
    if not steps:
        return None
    return sum(s["host_ms"] for s in spans
               if s["name"] == "trainer.fetch") / steps
