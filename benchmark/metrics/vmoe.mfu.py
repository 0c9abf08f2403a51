"""The whole V-MoE training step's share of the card's bf16 peak, in %:
three forwards an image of the dense part (``roofline_moe.
vmoe_dense_forward_flops``, the routers included) and of the experts'
kept assignments (a step's ``kept_held``, the mean over the traced
window's steps of its forward ``moe.route`` counts), over the window's
seconds less its profiled part."""
from roofline import PEAK_BF16_FLOPS
from roofline_moe import experts_step_flops
from touhouimageclassification_tpu_torch.utils import profiling


def read(readings: dict):
    if not readings.get("window_s") or not readings.get("images"):
        return None
    spans = profiling.recorded() if hasattr(profiling, "recorded") else []
    steps = sum(s["name"] == "trainer.step" for s in spans)
    kept = sum(s["counts"].get("kept_held", 0) for s in spans
               if s["name"] == "moe.route")
    if not steps or not kept or "dense_flops_per_image" not in readings:
        return None
    shape = readings["shape"]
    images = readings["images"]
    flops = (3.0 * readings["dense_flops_per_image"] * images
             + images / readings["batch"]
             * experts_step_flops(kept / steps, shape["hidden"], shape["mlp"]))
    return 100.0 * flops / readings["window_s"] / PEAK_BF16_FLOPS
