"""The LayerNorm pair's share of its bytes bound, in %: 10 bytes an element
(bf16 x read and y written in the forward, x and dy read and dx written in
the backward, whatever the implementation) times the elements of one
LayerNorm (the step's batch x tokens x width), over the time of one
LayerNorm's forward and backward on the card, the sum of the mean traced
time of a launch of each of the pair's three kernels (the forward, the
backward and the sum of the scale's and bias's gradients), at 3.35 TB/s. A
trace that holds none of one of them, as a program without the pair's
kernels gives, reads nothing."""
from roofline import bytes_bound_s
from traced import kernel_seconds

BYTES_PER_ELEMENT = 10
KERNELS = ("tic_layernorm_fwd_kernel", "tic_layernorm_bwd_kernel",
           "tic_layernorm_dparams_kernel")


def read(readings: dict):
    shape = readings.get("shape") or {}
    elements = (readings.get("batch") or 0) * shape.get("n", 0) * shape.get(
        "hidden", 0)
    seconds = 0.0
    for name in KERNELS:
        count, total = kernel_seconds(readings.get("trace"), name)
        if not count or not total:
            return None
        seconds += total / count
    if not elements:
        return None
    return 100.0 * bytes_bound_s(BYTES_PER_ELEMENT * elements) / seconds
