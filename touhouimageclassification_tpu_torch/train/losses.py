"""Loss functions (counterpart of the JAX package's ``train/losses.py``).

``cross_entropy`` on soft (one-hot or mixed) targets and ``accuracy``; the
ResMoE objective (``TIC/ResMoE/train.py:21-36``): ``symmetric_cross_entropy``
(SCE, alpha 0.1, beta 1.0) plus 0.5 times a gate-usage penalty, the
reference's quadratic ``load_balance_loss`` or the Switch Transformer's
``switch_load_balance_loss``; ``moe_total_loss`` sums SCE and the quadratic
one.

Under data parallelism every batch reduction is global: the sums of a mean
(its numerator and its denominator) are summed over the data group
(``parallel.collectives.sum_over_data``) before they divide, so each rank
holds the loss of the global batch and the backward carries the gradient of
that loss.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.collectives import data_group, global_count, sum_over_data


def _weighted_mean(per_sample: torch.Tensor,
                   w: torch.Tensor | None) -> torch.Tensor:
    if data_group() is None:
        if w is None:
            return per_sample.mean()
        w = w.to(per_sample.dtype)
        return (per_sample * w).sum() / w.sum().clamp(min=1.0)
    if w is None:
        return (sum_over_data(per_sample.sum())
                / global_count(per_sample.shape[0]))
    w = w.to(per_sample.dtype)
    sums = sum_over_data(torch.stack([(per_sample * w).sum(), w.sum()]))
    return sums[0] / sums[1].clamp(min=1.0)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean(0)`` over the global batch."""
    if data_group() is None:
        return x.mean(0)
    return sum_over_data(x.sum(0)) / global_count(x.shape[0])


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


def symmetric_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                            alpha: float = 0.1, beta: float = 1.0,
                            sample_weights: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """alpha * CE(logits, targets) + beta * reverse CE, as the reference
    computes it: -sum(softmax(logits) * log_softmax(targets)), the log-softmax
    of the (one-hot) targets themselves."""
    ce = cross_entropy(logits, targets, sample_weights)
    log_t = F.log_softmax(targets.float(), dim=-1)
    p = F.softmax(logits.float(), dim=-1)
    rce = _weighted_mean(-(p * log_t).sum(-1), sample_weights)
    return alpha * ce + beta * rce


def load_balance_loss(gate_weights: torch.Tensor) -> torch.Tensor:
    """The reference's quadratic gate-usage penalty: the mean over samples
    of <gate_weights_i, mean gate usage>."""
    return _weighted_mean(gate_weights @ batch_mean(gate_weights), None)


def switch_load_balance_loss(gate_weights: torch.Tensor,
                             top_idx: torch.Tensor,
                             num_experts: int) -> torch.Tensor:
    """The Switch Transformer's balance loss, E * sum_e f_e * P_e: f_e the
    share of routed (sample, k) assignments on expert e (counts, detached),
    P_e the mean router probability of e (the differentiable half); 1.0 for
    a uniform router."""
    routed = top_idx.reshape(-1)
    if data_group() is None:
        f = torch.zeros(num_experts, device=routed.device).index_add_(
            0, routed.long(), torch.full(routed.shape, 1.0 / routed.numel(),
                                         device=routed.device)).detach()
    else:
        counts = torch.zeros(num_experts, device=routed.device).index_add_(
            0, routed.long(), torch.ones(routed.shape, device=routed.device))
        f = (sum_over_data(counts) / global_count(routed.numel())).detach()
    p = batch_mean(gate_weights.float())
    return num_experts * (f * p).sum()


def moe_total_loss(logits: torch.Tensor, targets: torch.Tensor,
                   gate_weights: torch.Tensor, balance_alpha: float = 0.5,
                   sce_alpha: float = 0.1, sce_beta: float = 1.0
                   ) -> torch.Tensor:
    """The reference's ``total_loss`` without its NaN asserts (the train
    step's guard covers those)."""
    return (symmetric_cross_entropy(logits, targets, sce_alpha, sce_beta)
            + balance_alpha * load_balance_loss(gate_weights))
