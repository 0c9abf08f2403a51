"""The whole sweep's share of the card's bf16 peak: one forward's FLOPs an
image (roofline.vit_forward_flops) times the images scored in the window,
over its seconds."""
from roofline import PEAK_BF16_FLOPS


def read(readings: dict):
    if not readings.get("window_s") or not readings.get("images"):
        return None
    rate = readings["flops_per_image"] * readings["images"] / readings["window_s"]
    return 100.0 * rate / PEAK_BF16_FLOPS
