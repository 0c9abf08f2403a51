"""The numbers that decide ``correct``: gaps between what the program
produced and what the plain reference works out from the same inputs."""
from __future__ import annotations

import math
import statistics

import torch


def relative_gap(program: list[float], reference: list[float]) -> float:
    """The largest |program - reference| / |reference| over the entries."""
    return max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(program, reference))


def leaf_norm_gap(program: dict[str, float], reference: dict[str, float],
                  keep=None) -> tuple[float, str]:
    """The worst leaf's |program norm - reference norm| over the larger of
    the reference leaf's norm and the median leaf's; leaves for which
    ``keep(name)`` is false are left out. Returns (gap, leaf)."""
    names = [k for k in reference if keep is None or keep(k)]
    median = statistics.median(reference[k] for k in names)
    worst = (-1.0, "")
    for k in names:
        p = program.get(k, math.nan)
        gap = abs(p - reference[k]) / max(reference[k], median, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        worst = max(worst, (gap, k))
    return worst


def moved_leaves(grad1: dict[str, float], share: float = 1e-3):
    """A rule on the reference's first gradient: leaves whose gradient norm
    is under ``share`` of the median leaf's move under Adam by round-off
    alone, and are left out of the change's comparison."""
    median = statistics.median(grad1.values())
    return lambda name: grad1[name] >= share * median


def served_gaps(ref_logits: torch.Tensor, served: torch.Tensor,
                confidence: torch.Tensor) -> tuple[float, float]:
    """For served (class index, confidence) pairs: the widest gap by which
    the served class's reference logit lies below the reference's best, and
    the widest |confidence - reference probability of the served class|."""
    ref = ref_logits.float()
    idx = served.long().to(ref.device)[:, None]
    gap = ref.max(dim=-1).values - ref.gather(1, idx)[:, 0]
    prob = torch.softmax(ref, dim=-1).gather(1, idx)[:, 0]
    err = (confidence.float().to(ref.device) - prob).abs()
    return float(gap.max()), float(err.max())
