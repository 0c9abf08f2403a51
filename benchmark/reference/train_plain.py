"""The training step in plain float32 PyTorch: the ``nvit`` recipe's
inputs (``augment_plain``), the ViT forward and backward (``vit_plain``),
the mean cross entropy on the soft labels, the global gradient norm and
its guard, and AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled decay)
written out.

The batch is cut into row blocks that each add their share of the mean
loss to the gradients, so a large batch fits; the augmentation and the mix
see the whole batch, as the mix pairs each row with the one before it.
"""
from __future__ import annotations

import math

import torch

from .augment_plain import step_inputs
from .vit_plain import PlainViT, exact_fp32

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def leaf_parts(name: str, t: torch.Tensor):
    """The parts of a leaf that the comparison takes one by one: a fused
    QKV bias as its query, key and value thirds (the key's bias has no
    gradient under softmax but round-off), every other leaf whole."""
    if name.endswith("attn.qkv.bias"):
        return [(f"{name}[{part}]", chunk)
                for part, chunk in zip("qkv", t.chunk(3))]
    return [(name, t)]


def part_norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    """The norm of every part (:func:`leaf_parts`), in one fetch."""
    parts = [pair for k, t in tensors.items() for pair in leaf_parts(k, t)]
    values = torch.stack([t.float().norm() for _, t in parts]).tolist()
    return dict(zip([k for k, _ in parts], values))


def train_steps(w0: dict[str, torch.Tensor], shape: dict, seed: int,
                batches: list[tuple[torch.Tensor, torch.Tensor]], lr: float,
                weight_decay: float, precision: str = "fp32",
                block: int = 32, loss_rows: int | None = None) -> dict:
    """One step per (uint8 images, labels) batch from ``w0``. ``loss_rows``
    plants the fault of a batch half left out: the loss is the mean over
    the first ``loss_rows`` rows only (None: all rows). Returns each
    step's loss, the gradient norm of every part of a leaf
    (:func:`leaf_parts`) at the first step and every part's change over all
    the steps."""
    exact_fp32()
    params = {k: v.detach().float().clone().requires_grad_(True)
              for k, v in w0.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    out_size = (shape["image"], shape["image"])
    losses, grad1, t = [], None, 0
    for step, (images, labels) in enumerate(batches):
        x, y = step_inputs(seed, step, images, labels, shape["classes"],
                           out_size)
        model = PlainViT(params, shape, precision)
        rows = loss_rows or x.shape[0]
        loss = torch.zeros((), device=x.device)
        for i in range(0, rows, block):
            j = min(i + block, rows)
            logp = torch.log_softmax(model.logits(x[i:j]), dim=-1)
            part = -(y[i:j] * logp).sum() / rows
            part.backward()
            loss += part.detach()
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
    return {"loss": losses, "grad1": grad1, "delta": delta}
