"""The device's idle share in training steps: the share of the traced window in which no kernel, copy or set
ran on the device (the union of the profiler's device intervals)."""


def read(readings: dict):
    trace = readings.get("trace") or {}
    if not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
