"""Deterministic image ops of the serve path: ``resize`` and ``normalize``.

Counterparts of ``touhouimageclassification_tpu/ops/augment.py``'s functions
of the same names, on NHWC float images in [0, 1]. Resize is two matmuls with
antialiased-linear interpolation-weight matrices, as there, so the port
resamples exactly as the JAX package does. The random training augmentations
come with the train slice.
"""
from __future__ import annotations

import torch


def _linear_resize_weights(in_size: int, out_size: int,
                           device: torch.device) -> torch.Tensor:
    """(out_size, in_size) antialiased-linear interpolation matrix: triangle
    kernel with support max(in/out, 1), rows renormalised (PIL-style edges)."""
    scale = in_size / out_size
    support = max(scale, 1.0)
    o = torch.arange(out_size, dtype=torch.float32, device=device)
    centers = (o + 0.5) * scale - 0.5                             # (out,)
    i = torch.arange(in_size, dtype=torch.float32, device=device)
    dist = (i - centers[:, None]).abs() / support                 # (out, in)
    w = (1.0 - dist).clamp(min=0.0)
    return w / w.sum(-1, keepdim=True).clamp(min=1e-8)


def resize(images: torch.Tensor, out_size: tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) -> (B, out_h, out_w, C), computed in f32, returned in the
    input dtype."""
    _, h, w, _ = images.shape
    wh = _linear_resize_weights(h, out_size[0], images.device)   # (oh, H)
    ww = _linear_resize_weights(w, out_size[1], images.device)   # (ow, W)
    y = torch.einsum("oi,bijc->bojc", wh, images.float())
    y = torch.einsum("pj,bojc->bopc", ww, y)
    return y.to(images.dtype)


def normalize(images: torch.Tensor, mean, std) -> torch.Tensor:
    mean = torch.as_tensor(mean, dtype=images.dtype, device=images.device)
    std = torch.as_tensor(std, dtype=images.dtype, device=images.device)
    return (images - mean) / std
