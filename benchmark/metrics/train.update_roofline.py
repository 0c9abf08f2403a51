"""AdamW's kernel against its bytes bound, in %: 28 bytes an element (f32
p, g, m and v read; p, m and v written, whatever the implementation) times
the elements a launch wrote (the traced window's ``trainer.update`` spans'
``elements`` over their ``launches``), over the mean device time of the
window's ``adamw_kernel`` launches in the trace, at 3.35 TB/s. The span's
host work before the launch is left out, as an idle card waits through it;
a launch whose record the trace lost leaves the reading as it was. A
program whose update span counts no elements or launches, or whose trace
holds no such kernel, reads nothing."""
from roofline import bytes_bound_s
from traced import kernel_seconds
from touhouimageclassification_tpu_torch.utils import profiling

BYTES_PER_ELEMENT = 28
KERNEL = "adamw_kernel"


def read(readings: dict):
    spans = profiling.recorded() if hasattr(profiling, "recorded") else []
    updates = [s["counts"] for s in spans if s["name"] == "trainer.update"]
    written = sum(c.get("elements", 0) for c in updates)
    launched = sum(c.get("launches", 0) for c in updates)
    count, seconds = kernel_seconds(readings.get("trace"), KERNEL)
    if not written or not launched or not count or not seconds:
        return None
    return 100.0 * bytes_bound_s(BYTES_PER_ELEMENT * written / launched) / (
        seconds / count)
