"""The work of V-MoE's step, beside ``roofline.py``: the forward FLOPs of
its dense part and of one kept expert assignment, and the experts' share
of their roofline. FLOPs are multiply-adds times two; the step is three
forwards (``roofline.train_step_flops``)."""
from __future__ import annotations

from roofline import PEAK_BF16_FLOPS, vit_forward_flops


def vmoe_dense_forward_flops(shape: dict) -> float:
    """One image's forward without the experts: the ViT's
    (``roofline.vit_forward_flops``) less the MLPs of the MoE layers, plus
    each MoE layer's router (hidden x E a token)."""
    n = (shape["image"] // shape["patch"]) ** 2 + 1
    vit = vit_forward_flops(shape["hidden"], shape["layers"], shape["mlp"],
                            shape["image"], shape["patch"], shape["classes"])
    moe = len(shape["moe_layers"])
    mlp = 2 * 2 * n * shape["hidden"] * shape["mlp"]
    router = 2 * n * shape["hidden"] * shape["experts"]
    return float(vit - moe * mlp + moe * router)


def expert_assignment_flops(hidden: int, mlp: int) -> float:
    """One kept assignment's forward through its expert: two products of
    hidden x mlp."""
    return float(2 * 2 * hidden * mlp)


def experts_step_flops(kept: float, hidden: int, mlp: int) -> float:
    """The held experts' FLOPs of a step with ``kept`` kept assignments on
    them (summed over the MoE layers): three forwards."""
    return 3.0 * kept * expert_assignment_flops(hidden, mlp)


def experts_roofline(kept: float, hidden: int, mlp: int,
                     seconds: float) -> float:
    """The experts' share of the bf16 peak, in %: their step FLOPs over
    ``seconds`` of their device time (the products are compute-bound: an
    expert's weights serve its G x C slot rows)."""
    return 100.0 * experts_step_flops(kept, hidden, mlp) / seconds \
        / PEAK_BF16_FLOPS
