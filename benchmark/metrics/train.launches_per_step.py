"""Kernel launches a training step: the CUDA runtime's and driver's launch
calls in the traced window over the steps it holds."""


def read(readings: dict):
    trace = readings.get("trace") or {}
    steps = readings.get("trace_steps", 0)
    if not trace.get("launches") or not steps:
        return None
    return trace["launches"] / steps
