"""K1's share of its roofline: its bytes bound at the judge's batch
(roofline.k1_bound_s) over its mean device time a launch, the time of the
``'wgmma'`` forward kernel in the traced window over the launches the port
counted (``ops.attention.launches``)."""
from roofline import k1_bound_s
from traced import kernel_seconds

KERNEL = "attention_fwd_wgmma_kernel"


def read(readings: dict):
    _, seconds = kernel_seconds(readings.get("trace"), KERNEL)
    calls = (readings.get("calls") or {}).get("k1", 0)
    if not seconds or not calls:
        return None
    s = readings["shape"]
    return 100.0 * k1_bound_s(readings["batch"], s["n"], s["hidden"]) / (
        seconds / calls)
