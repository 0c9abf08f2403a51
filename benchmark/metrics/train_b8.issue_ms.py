"""Host milliseconds a batch-8 training step spends issuing work, its
``trainer.step`` span less the ``trainer.fetch`` inside it (the wait for
the device), over the traced window's steps: where a host-bound step's
time goes."""
from touhouimageclassification_tpu_torch.utils import profiling


def read(readings: dict):
    spans = profiling.recorded() if hasattr(profiling, "recorded") else []
    steps = [i for i, s in enumerate(spans) if s["name"] == "trainer.step"]
    if not steps:
        return None
    roots = set(steps)
    waits = sum(s["host_ms"] for s in spans
                if s["name"] == "trainer.fetch" and s["parent"] in roots)
    return (sum(spans[i]["host_ms"] for i in steps) - waits) / len(steps)
