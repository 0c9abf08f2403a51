"""V-MoE's training step in plain float32 PyTorch: ``train_plain``'s step
(the ``nvit`` inputs, mean cross entropy on the soft labels, the gradient
norm's guard, AdamW written out) over ``vmoe_plain``'s forward, with the
model's auxiliary loss added to the loss.

The batch runs one routing group at a time (a group's tokens share the
experts' capacity, so a block is a whole group): each group adds its rows'
share of the mean cross entropy and its auxiliary loss over the number of
groups (the program averages each layer's losses over the groups).

The router noise is redrawn by the program's recipe: the step's numpy
generator ``default_rng([seed, step])`` gives, in order, the augmentation's
seed, the CutMix/MixUp draw (``augment_plain``), the dropout seed and the
task's seed; a ``torch.Generator`` on the batch's device seeded with the
task's seed draws one standard normal (G, T, E) tensor a MoE layer, in
layer order, for the whole batch.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .augment_plain import augment, mix
from .train_plain import BETA1, BETA2, EPS, part_norms
from .vit_plain import exact_fp32
from .vmoe_plain import PlainVMoE


def step_inputs_and_noise(seed: int, step: int, images_u8: torch.Tensor,
                          labels: torch.Tensor, classes: int,
                          out: tuple[int, int], moe: dict, tokens: int,
                          groups: int):
    """The step's mixed images, soft labels and router noise."""
    rng = np.random.default_rng([seed, step])
    gen = torch.Generator(device=images_u8.device)
    gen.manual_seed(int(rng.integers(2 ** 63)))
    x = augment(gen, images_u8.float() / 255.0, out)
    y = torch.nn.functional.one_hot(labels.long(), classes).float()
    x, y = mix(rng, x, y)
    rng.integers(2 ** 63)                     # the dropout seed
    task = torch.Generator(device=images_u8.device)
    task.manual_seed(int(rng.integers(2 ** 63)))
    noise = [torch.randn((groups, tokens, moe["experts"]), generator=task,
                         device=images_u8.device)
             for _ in moe["layers"]]
    return x, y, noise


def train_steps(w0: dict[str, torch.Tensor], shape: dict, moe: dict,
                seed: int, batches: list[tuple[torch.Tensor, torch.Tensor]],
                lr: float, weight_decay: float, precision: str = "fp32",
                loss_rows: int | None = None) -> dict:
    """One step per (uint8 images, labels) batch from ``w0``. ``moe`` as
    ``PlainVMoE`` takes it, plus ``group_images``. ``loss_rows`` plants the
    fault of a batch half left out (the cross entropy over the first rows
    only). Returns each step's loss, the first gradient and the change of
    every part of a leaf (``train_plain.part_norms``) and the routing of
    step 0: [(expert, kept) (G, K, T) of each MoE layer]."""
    exact_fp32()
    params = {k: v.detach().float().clone().requires_grad_(True)
              for k, v in w0.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    out_size = (shape["image"], shape["image"])
    losses, grad1, routes0, t = [], None, None, 0
    for step, (images, labels) in enumerate(batches):
        b = images.shape[0]
        group = min(moe["group_images"], b)
        groups = b // group
        x, y, noise = step_inputs_and_noise(
            seed, step, images, labels, shape["classes"], out_size, moe,
            group * shape["n"], groups)
        model = PlainVMoE(params, shape, moe, precision)
        rows = loss_rows or b
        loss = torch.zeros((), device=x.device)
        routes = []
        for gi in range(groups):
            i, j = gi * group, (gi + 1) * group
            logits, aux, route = model.forward(x[i:j],
                                               [n[gi] for n in noise])
            routes.append(route)
            logp = torch.log_softmax(logits[:max(0, min(j, rows) - i)], dim=-1)
            part = (-(y[i:min(j, rows)] * logp).sum() / rows
                    + aux / groups)
            part.backward()
            loss += part.detach()
        if routes0 is None:
            routes0 = [tuple(torch.stack([r[layer][which] for r in routes])
                             for which in (0, 1))
                       for layer in range(len(routes[0]))]
        losses.append(float(loss))
        with torch.no_grad():
            names = list(params)
            if grad1 is None:
                grad1 = part_norms({k: params[k].grad for k in names})
            total = float(torch.stack([params[k].grad.norm() for k in names])
                          .square().sum().sqrt())
            if math.isfinite(losses[-1]) and math.isfinite(total):
                t += 1
                bc1, bc2 = 1 - BETA1 ** t, 1 - BETA2 ** t
                for k in names:
                    p, g = params[k], params[k].grad
                    p.mul_(1 - lr * weight_decay)
                    m[k].lerp_(g, 1 - BETA1)
                    v[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                    denom = v[k].sqrt() / math.sqrt(bc2) + EPS
                    p.addcdiv_(m[k], denom, value=-lr / bc1)
            for p in params.values():
                p.grad = None
    with torch.no_grad():
        delta = part_norms({k: p - w0[k].float() for k, p in params.items()})
    return {"loss": losses, "grad1": grad1, "delta": delta,
            "routes": routes0}


def route_flip_share(program: list, reference: list) -> float:
    """The share of the reference's step-0 assignments whose expert or kept
    status the program's differs from (an assignment the program lacks
    counts as differing): (expert, kept) (G, K, T) pairs a MoE layer."""
    flips = total = 0
    for i, (re, rk) in enumerate(reference):
        total += re.numel()
        if i >= len(program):
            flips += re.numel()
            continue
        pe, pk = program[i]
        k = min(pe.shape[1], re.shape[1])
        same = ((pe[:, :k].to(re.device) == re[:, :k])
                & (pk[:, :k].to(re.device) == rk[:, :k]))
        flips += re.numel() - int(same.sum())
    return flips / max(total, 1)
