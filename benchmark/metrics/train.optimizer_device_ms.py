"""Device milliseconds a training step spends in the optimizer: the CUDA
events of the port's ``trainer.norm`` (the gradients' global norm) and
``trainer.update`` (AdamW) spans of the traced window over its
``trainer.step`` spans."""
from touhouimageclassification_tpu_torch.utils import profiling


def read(readings: dict):
    spans = profiling.recorded() if hasattr(profiling, "recorded") else []
    steps = sum(s["name"] == "trainer.step" for s in spans)
    ms = [s["device_ms"] for s in spans
          if s["name"] in ("trainer.norm", "trainer.update")]
    if not steps or not ms or None in ms:
        return None
    return sum(ms) / steps
