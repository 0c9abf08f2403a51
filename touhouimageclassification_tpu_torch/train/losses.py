"""Loss functions (counterpart of the JAX package's ``train/losses.py``).

``cross_entropy`` on soft (one-hot or mixed) targets and ``accuracy``. The
ResMoE losses (symmetric CE, the balance losses) come with ResMoE.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _weighted_mean(per_sample: torch.Tensor,
                   w: torch.Tensor | None) -> torch.Tensor:
    if w is None:
        return per_sample.mean()
    w = w.to(per_sample.dtype)
    return (per_sample * w).sum() / w.sum().clamp(min=1.0)


def cross_entropy(logits: torch.Tensor, soft_targets: torch.Tensor,
                  sample_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean CE over the batch, in f32; targets are probabilities summing to
    1. ``sample_weights`` (B,) makes it a weighted mean."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return _weighted_mean(-(soft_targets * logp).sum(-1), sample_weights)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor | None = None):
    """(correct_count, total_count), so callers can aggregate exactly;
    ``mask`` (B,) bool drops padded samples."""
    correct = logits.argmax(-1) == labels
    if mask is None:
        return correct.sum(), labels.shape[0]
    return (correct & mask).sum(), mask.sum()
