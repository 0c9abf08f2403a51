"""Device milliseconds a training step spends on its inputs (augmentation,
one-hot labels, mixup or cutmix): the CUDA events of the port's
``trainer.inputs`` spans of the traced window over its ``trainer.step``
spans. The events time the stream from the span's start to its end, so
launch gaps on an idle stream count too."""
from touhouimageclassification_tpu_torch.utils import profiling


def read(readings: dict):
    spans = profiling.recorded() if hasattr(profiling, "recorded") else []
    steps = sum(s["name"] == "trainer.step" for s in spans)
    ms = [s["device_ms"] for s in spans if s["name"] == "trainer.inputs"]
    if not steps or not ms or None in ms:
        return None
    return sum(ms) / steps
