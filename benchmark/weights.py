"""Seeded weights and shapes of a ViT configuration file, made by the
benchmark and handed alike to the program and to the plain reference.

The state dict uses the parameter names of the port's ``ViT`` (the
reference reads the same names). All values come from one normal draw of a
``torch.Generator`` on the device, split into leaves, in float32; a side
that serves in bfloat16 casts them.
"""
from __future__ import annotations

import torch


def vit_shape(cfg: dict) -> dict:
    """The sizes the benchmark uses, from a configuration file."""
    image, patch = cfg["image_size"], cfg["patch_size"]
    return {"hidden": cfg["hidden_size"], "layers": cfg["num_hidden_layers"],
            "heads": cfg["num_attention_heads"],
            "mlp": cfg["intermediate_size"], "image": image, "patch": patch,
            "classes": cfg["port"]["num_labels"],
            "n": (image // patch) ** 2 + 1, "eps": cfg["layer_norm_eps"]}


def leaf_specs(shape: dict) -> list[tuple[str, tuple[int, ...], str, float]]:
    """(name, shape, kind, scale) of every parameter, in a fixed order.
    ``kind`` is ``'w'`` (normal times scale), ``'one'`` (1 + normal times
    scale) for LayerNorm weights."""
    c, m, p = shape["hidden"], shape["mlp"], shape["patch"]
    specs = [("patch_embed.proj.weight", (c, p * p * 3), "w", (p * p * 3) ** -0.5),
             ("patch_embed.proj.bias", (c,), "w", 0.02),
             ("cls_token", (1, 1, c), "w", 0.02),
             ("pos_embed", (1, shape["n"], c), "w", 0.02)]
    for i in range(shape["layers"]):
        pre = f"layer.{i}."
        specs += [(pre + "ln1.weight", (c,), "one", 0.1),
                  (pre + "ln1.bias", (c,), "w", 0.05),
                  (pre + "attn.qkv.weight", (3 * c, c), "w", c ** -0.5),
                  (pre + "attn.qkv.bias", (3 * c,), "w", 0.02),
                  (pre + "attn.out.weight", (c, c), "w", c ** -0.5),
                  (pre + "attn.out.bias", (c,), "w", 0.02),
                  (pre + "ln2.weight", (c,), "one", 0.1),
                  (pre + "ln2.bias", (c,), "w", 0.05),
                  (pre + "mlp.fc1.weight", (m, c), "w", c ** -0.5),
                  (pre + "mlp.fc1.bias", (m,), "w", 0.02),
                  (pre + "mlp.fc2.weight", (c, m), "w", m ** -0.5),
                  (pre + "mlp.fc2.bias", (c,), "w", 0.02)]
    # a head at twice the fan-in scale spreads the logits, so that the
    # served confidences are far from uniform
    specs += [("final_ln.weight", (c,), "one", 0.1),
              ("final_ln.bias", (c,), "w", 0.05),
              ("head.weight", (shape["classes"], c), "w", 2.0 * c ** -0.5),
              ("head.bias", (shape["classes"],), "w", 0.02)]
    return specs


@torch.no_grad()
def make_weights(shape: dict, seed: int,
                 device: str | torch.device) -> dict[str, torch.Tensor]:
    """The float32 state dict of ``seed``: one normal draw on ``device``,
    split and scaled."""
    specs = leaf_specs(shape)
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
