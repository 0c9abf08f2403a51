"""Capacity-based top-k dispatch and combine for the mixture models
(counterpart of the JAX package's ``ops/moe_dispatch.py``).

ResMoE's sparse routing and TreeViT's son dispatch share it: B samples, K
choices a sample, E experts, capacity C slots an expert. Assignments past
an expert's capacity are dropped (their combine weight is zero). Shapes are
static, as in JAX: the plan is built on the device from the (B, K) top-k
indices with no device -> host copy, and every expert runs on its C slots
whether or not they are filled.

- positions: a one-hot (B*K, E) cumsum counts the earlier assignments to
  the same expert, as JAX's; ``gather`` picks each assignment's own count
  (the one-hot is a ``scatter_``: ``F.one_hot`` checks its indices on the
  host, a device -> host sync in the middle of a forward);
- the (E, C) slot table is an (E, C+1) tensor written with ``index_put_``
  and then sliced: column C collects the dropped assignments (the only
  place two writes can meet) and is cut off, so the plan's integers equal
  JAX's exactly;
- ``jax.ops.segment_sum`` becomes ``index_add_`` in f32.

Indices are int64 (what torch indexes with); their values are JAX's.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


class DispatchPlan(NamedTuple):
    gather_idx: torch.Tensor   # (E, C) int64: sample feeding each slot
    slot_valid: torch.Tensor   # (E, C) bool: slot actually used
    flat_expert: torch.Tensor  # (B*K,) int64: expert of each assignment
    flat_pos: torch.Tensor     # (B*K,) int64: slot of each (C if dropped)
    flat_keep: torch.Tensor    # (B*K,) bool: assignment survived capacity
    flat_sample: torch.Tensor  # (B*K,) int64: sample of each assignment


def capacity_for(batch: int, top_k: int, num_experts: int,
                 factor: float) -> int:
    """Static capacity: ceil(B*K/E * factor), at least 1."""
    return max(1, math.ceil(batch * top_k / num_experts * factor))


def make_dispatch_plan(top_k_idx: torch.Tensor, num_experts: int,
                       capacity: int) -> DispatchPlan:
    """(B, K) expert indices -> the static-shape routing plan."""
    b, k = top_k_idx.shape
    dev = top_k_idx.device
    flat_e = top_k_idx.reshape(-1).long()
    flat_sample = torch.arange(b * k, device=dev) // k
    onehot = torch.zeros(b * k, num_experts, dtype=torch.long,
                         device=dev).scatter_(1, flat_e[:, None], 1)
    # position of each assignment within its expert (count of earlier ones)
    before = onehot.cumsum(0) - onehot
    pos = before.gather(1, flat_e[:, None])[:, 0]
    keep = pos < capacity
    pos_c = torch.where(keep, pos, torch.full_like(pos, capacity))
    gather_idx = torch.zeros(num_experts, capacity + 1, dtype=torch.long,
                             device=dev)
    slot_valid = torch.zeros(num_experts, capacity + 1, dtype=torch.bool,
                             device=dev)
    gather_idx.index_put_((flat_e, pos_c), flat_sample)
    slot_valid.index_put_((flat_e, pos_c), keep)
    return DispatchPlan(gather_idx=gather_idx[:, :capacity],
                        slot_valid=slot_valid[:, :capacity],
                        flat_expert=flat_e, flat_pos=pos_c, flat_keep=keep,
                        flat_sample=flat_sample)


def dispatch(plan: DispatchPlan, x: torch.Tensor) -> torch.Tensor:
    """Per-expert inputs: x (B, ...) -> (E, C, ...)."""
    return x[plan.gather_idx]


def kept_mass(plan: DispatchPlan, weights: torch.Tensor,
              batch: int) -> torch.Tensor:
    """Per-sample combine mass that survived capacity, (B,) f32 in [0, 1]:
    0 where every routed copy of the sample was dropped (its ``combine``
    row is all zero)."""
    w = weights.reshape(-1).float() * plan.flat_keep
    return torch.zeros(batch, device=w.device).index_add_(0, plan.flat_sample,
                                                          w)


def combine(plan: DispatchPlan, expert_outputs: torch.Tensor,
            weights: torch.Tensor, batch: int) -> torch.Tensor:
    """Weighted scatter-add of (E, C, D) expert outputs back to the samples
    with the (B, K) combine weights -> (B, D) f32."""
    e_pad = F.pad(expert_outputs.float(), (0, 0, 0, 1))  # overflow slot
    per_assign = e_pad[plan.flat_expert, plan.flat_pos]   # (BK, D)
    w = weights.reshape(-1).float() * plan.flat_keep      # dropped -> 0
    return torch.zeros(batch, per_assign.shape[-1],
                       device=per_assign.device).index_add_(
        0, plan.flat_sample, per_assign * w[:, None])
