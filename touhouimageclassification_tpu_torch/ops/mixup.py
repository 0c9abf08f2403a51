"""Batch-level CutMix-or-MixUp (counterpart of the JAX package's
``ops/mixup.py``).

torchvision's ``RandomChoice([CutMix, MixUp])`` semantics, as there: one coin
per batch picks CutMix or MixUp, lambda ~ Beta(alpha, alpha), the partner of
each sample is the batch rolled by 1, CutMix's box has sides sqrt(1 - lambda)
of the image around a uniform centre and lambda is recomputed from the
clipped box, and the labels become ``lam * y + (1 - lam) * y_rolled``.

The few batch-level scalars (coin, lambda, box centre) are drawn on the host
from a ``numpy.random.Generator``: ``torch.distributions.Beta`` takes no
generator, and a host draw picks the branch without waiting for the device.
The scalars are f32, as the JAX package computes them.
"""
from __future__ import annotations

import numpy as np
import torch


def mixup(images: torch.Tensor, labels: torch.Tensor,
          lam: float) -> tuple[torch.Tensor, torch.Tensor]:
    lam = np.float32(lam)
    rest = float(np.float32(1.0) - lam)
    mixed = float(lam) * images + rest * images.roll(1, dims=0)
    soft = float(lam) * labels + rest * labels.roll(1, dims=0)
    return mixed.to(images.dtype), soft


def cutmix_box(lam: float, cy: float, cx: float, h: int,
               w: int) -> tuple[float, float, float, float, float]:
    """The clipped box (y0, y1, x0, x1) around the centre (cy, cx), in
    pixels, and lambda recomputed from its area, all in f32."""
    f32 = np.float32
    cut = np.sqrt(f32(1.0) - f32(lam))
    half_h, half_w = cut * f32(h) / f32(2), cut * f32(w) / f32(2)
    y0 = np.clip(f32(cy) - half_h, f32(0), f32(h))
    y1 = np.clip(f32(cy) + half_h, f32(0), f32(h))
    x0 = np.clip(f32(cx) - half_w, f32(0), f32(w))
    x1 = np.clip(f32(cx) + half_w, f32(0), f32(w))
    lam_eff = f32(1.0) - ((y1 - y0) * (x1 - x0)) / f32(h * w)
    return tuple(float(v) for v in (y0, y1, x0, x1, lam_eff))


def cutmix(images: torch.Tensor, labels: torch.Tensor, lam: float, cy: float,
           cx: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Paste the partner's box centred at (cy, cx) pixels into each image."""
    _, h, w, _ = images.shape
    y0, y1, x0, x1, lam_eff = cutmix_box(lam, cy, cx, h, w)
    rows = torch.arange(h, dtype=torch.float32, device=images.device)
    cols = torch.arange(w, dtype=torch.float32, device=images.device)
    in_box = (((rows >= y0) & (rows < y1))[:, None]
              & ((cols >= x0) & (cols < x1))[None, :])
    mixed = torch.where(in_box[None, :, :, None], images.roll(1, dims=0),
                        images)
    rest = float(np.float32(1.0) - np.float32(lam_eff))
    soft = lam_eff * labels + rest * labels.roll(1, dims=0)
    return mixed.to(images.dtype), soft


def sample_cutmix_or_mixup(rng: np.random.Generator, h: int, w: int,
                           mixup_alpha: float = 1.0,
                           cutmix_alpha: float = 1.0) -> dict:
    """The batch's draws: ``{"cutmix": bool, "lam": float}``, plus the box
    centre ``cy``, ``cx`` in pixels for CutMix."""
    if rng.random() < 0.5:
        lam = rng.beta(cutmix_alpha, cutmix_alpha)
        return {"cutmix": True, "lam": float(lam),
                "cy": float(np.float32(rng.random()) * np.float32(h)),
                "cx": float(np.float32(rng.random()) * np.float32(w))}
    return {"cutmix": False, "lam": float(rng.beta(mixup_alpha, mixup_alpha))}


def apply_cutmix_or_mixup(images: torch.Tensor, labels: torch.Tensor,
                          draw: dict) -> tuple[torch.Tensor, torch.Tensor]:
    if draw["cutmix"]:
        return cutmix(images, labels, draw["lam"], draw["cy"], draw["cx"])
    return mixup(images, labels, draw["lam"])


def cutmix_or_mixup(rng: np.random.Generator, images: torch.Tensor,
                    labels_onehot: torch.Tensor, mixup_alpha: float = 1.0,
                    cutmix_alpha: float = 1.0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One batch-level RandomChoice between CutMix and MixUp: (B, H, W, C)
    images and (B, classes) one-hot labels -> mixed images, soft labels."""
    _, h, w, _ = images.shape
    return apply_cutmix_or_mixup(images, labels_onehot, sample_cutmix_or_mixup(
        rng, h, w, mixup_alpha, cutmix_alpha))
