"""Seeded weights and shapes of a V-MoE configuration file, made by the
benchmark and handed alike to the program and to the plain reference.

The state dict uses the parameter names of the port's ``VMoE``: the ViT's
(``weights.leaf_specs``), with a MoE layer's ``mlp`` leaves replaced by
``moe.router.weight`` (E, hidden) and the held experts' stacked ``moe.w1``
(E_h, hidden, mlp), ``moe.b1``, ``moe.w2`` (E_h, mlp, hidden) and
``moe.b2``. All values come from one normal draw of a ``torch.Generator``
on the device, split into leaves, in float32, as ``weights.make_weights``
does.
"""
from __future__ import annotations

import torch

from weights import leaf_specs, vit_shape


def vmoe_shape(cfg: dict) -> dict:
    """The ViT's sizes (``weights.vit_shape``) and the MoE layers': which
    layers, E, k, the capacity factor, the noise (in units of 1/E), the
    two loss weights, the routing group in images and the held experts
    (the first ``num_experts_held``)."""
    shape = vit_shape(cfg)
    shape.update(moe_layers=tuple(cfg["moe_layers"]),
                 experts=cfg["num_experts"], top_k=cfg["num_selected_experts"],
                 capacity_factor=cfg["capacity_factor"],
                 noise_std=cfg["router_noise_std"],
                 importance_weight=cfg["importance_loss_weight"],
                 load_weight=cfg["load_loss_weight"],
                 group_images=cfg["group_size_images"],
                 held=(0, cfg["num_experts_held"]))
    return shape


def moe_spec(shape: dict) -> dict:
    """The MoE part of a shape as ``reference.vmoe_plain.PlainVMoE`` and
    ``reference.train_moe_plain.train_steps`` take it."""
    return {"layers": shape["moe_layers"], "experts": shape["experts"],
            "top_k": shape["top_k"],
            "capacity_factor": shape["capacity_factor"],
            "noise_std": shape["noise_std"],
            "importance_weight": shape["importance_weight"],
            "load_weight": shape["load_weight"], "held": shape["held"],
            "group_images": shape["group_images"]}


def vmoe_leaf_specs(shape: dict) -> list[tuple[str, tuple[int, ...], str, float]]:
    """(name, shape, kind, scale) of every parameter, in a fixed order; the
    experts' projections at the fan-in scale of the dense MLP's, the router
    at its fan-in scale."""
    c, m = shape["hidden"], shape["mlp"]
    h = shape["held"][1] - shape["held"][0]
    moe = {f"layer.{i}." for i in shape["moe_layers"]}
    specs = []
    for name, s, kind, scale in leaf_specs(shape):
        pre = name[:name.index("mlp.")] if ".mlp." in name else None
        if pre not in moe:
            specs.append((name, s, kind, scale))
        elif name.endswith("mlp.fc1.weight"):
            specs += [(pre + "moe.router.weight", (shape["experts"], c), "w",
                       c ** -0.5),
                      (pre + "moe.w1", (h, c, m), "w", c ** -0.5),
                      (pre + "moe.b1", (h, m), "w", 0.02),
                      (pre + "moe.w2", (h, m, c), "w", m ** -0.5),
                      (pre + "moe.b2", (h, c), "w", 0.02)]
    return specs


@torch.no_grad()
def make_vmoe_weights(shape: dict, seed: int,
                      device: str | torch.device) -> dict[str, torch.Tensor]:
    """The float32 state dict of ``seed``: one normal draw on ``device``,
    split and scaled."""
    specs = vmoe_leaf_specs(shape)
    sizes = [int(torch.Size(s).numel()) for _, s, _, _ in specs]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, s, kind, scale), chunk in zip(specs, flat.split(sizes)):
        leaf = chunk.view(s).mul_(scale)
        if kind == "one":
            leaf.add_(1.0)
        out[name] = leaf
    return out
