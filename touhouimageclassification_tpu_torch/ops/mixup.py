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
The scalars are f32, as the JAX package computes them. The trainer mixes
with :func:`apply_mix_params`, which takes the draw as a small device vector
(:func:`mix_params`), so that a replayed CUDA graph, which cannot take host
floats, mixes as an eager step does. :func:`apply_cutmix_or_mixup` is the same
mix with the draw as host floats, one branch at a time: the form the tests
hold against the JAX package and :func:`apply_mix_params` against. Under
data parallelism the roll crosses ranks (``parallel.collectives.roll_rows``):
each rank's first sample mixes with the previous rank's last, as in the
global batch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..parallel.collectives import roll_rows


def mixup(images: torch.Tensor, labels: torch.Tensor,
          lam: float) -> tuple[torch.Tensor, torch.Tensor]:
    lam = np.float32(lam)
    rest = float(np.float32(1.0) - lam)
    mixed = float(lam) * images + rest * roll_rows(images)
    soft = float(lam) * labels + rest * roll_rows(labels)
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
    mixed = torch.where(in_box[None, :, :, None], roll_rows(images),
                        images)
    rest = float(np.float32(1.0) - np.float32(lam_eff))
    soft = lam_eff * labels + rest * roll_rows(labels)
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
    """The mix of a :func:`sample_cutmix_or_mixup` draw, its branch alone
    (module docstring)."""
    if draw["cutmix"]:
        return cutmix(images, labels, draw["lam"], draw["cy"], draw["cx"])
    return mixup(images, labels, draw["lam"])


def mix_params(draw: dict, h: int, w: int) -> np.ndarray:
    """A draw of :func:`sample_cutmix_or_mixup` as the f32 vector that
    :func:`apply_mix_params` reads: ``[cutmix, a, b, y0, y1, x0, x1]``.
    The labels mix as ``a * y + b * y_rolled`` (lambda, or CutMix's lambda
    recomputed from the clipped box, and 1 - it in f32), MixUp's images the
    same way, and CutMix pastes the box (y0, y1, x0, x1), empty for MixUp."""
    if draw["cutmix"]:
        y0, y1, x0, x1, lam = cutmix_box(draw["lam"], draw["cy"], draw["cx"],
                                         h, w)
    else:
        y0 = y1 = x0 = x1 = 0.0
        lam = draw["lam"]
    lam = np.float32(lam)
    return np.array([draw["cutmix"], lam, np.float32(1.0) - lam, y0, y1, x0,
                     x1], np.float32)


def apply_mix_params(images: torch.Tensor, labels: torch.Tensor,
                     params: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`apply_cutmix_or_mixup` with the draw as a (7,) f32 tensor of
    :func:`mix_params` on the images' device, so that the branch and its
    numbers are data: a captured CUDA graph replays either. Both branches'
    images are formed and one is selected, which gives the same values as
    the branch alone."""
    _, h, w, _ = images.shape
    cut, a, b, y0, y1, x0, x1 = params.unbind()
    rolled = roll_rows(images)
    rows = torch.arange(h, dtype=torch.float32, device=images.device)
    cols = torch.arange(w, dtype=torch.float32, device=images.device)
    in_box = (((rows >= y0) & (rows < y1))[:, None]
              & ((cols >= x0) & (cols < x1))[None, :])
    blend = torch.where(cut > 0, images, a * images + b * rolled)
    mixed = torch.where(in_box[None, :, :, None], rolled, blend)
    soft = a * labels + b * roll_rows(labels)
    return mixed.to(images.dtype), soft


def cutmix_or_mixup(rng: np.random.Generator, images: torch.Tensor,
                    labels_onehot: torch.Tensor, mixup_alpha: float = 1.0,
                    cutmix_alpha: float = 1.0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One batch-level RandomChoice between CutMix and MixUp: (B, H, W, C)
    images and (B, classes) one-hot labels -> mixed images, soft labels."""
    _, h, w, _ = images.shape
    draw = sample_cutmix_or_mixup(rng, h, w, mixup_alpha, cutmix_alpha)
    return apply_mix_params(images, labels_onehot, torch.from_numpy(
        mix_params(draw, h, w)).to(images.device))
