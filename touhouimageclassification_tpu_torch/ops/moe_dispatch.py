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

Under data parallelism the capacity plan is the global batch's
(:func:`make_shard_plan`): the (B, K) top-k of every data rank are
gathered, the global plan decides which assignments survive capacity, and
each rank dispatches only its own samples' surviving assignments, on at
most min(C, B) slots an expert.

V-MoE routes single tokens (:func:`make_group_plan`): G routing groups of
T tokens, K choices a token, placed choice-major (every token's first
choice before any token's second, as V-MoE places them), E experts of
which a rank holds a contiguous range. One plan serves all held experts:
their slots are laid out expert-major, G x C slots an expert, so a single
gather (:func:`dispatch_held`) feeds a batched product over the held
experts, and the combine reads each assignment's slot back. Assignments to
experts that the rank does not hold are planned (they take their place in
the queues) and leave no slot.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..parallel.collectives import data_shard, gather_rows


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
                       capacity: int,
                       keep: torch.Tensor | None = None) -> DispatchPlan:
    """(B, K) expert indices -> the static-shape routing plan. ``keep``
    (B*K,) bool, when given, decides which assignments survive (at most
    ``capacity`` an expert); the others are dropped and take no slot."""
    b, k = top_k_idx.shape
    dev = top_k_idx.device
    flat_e = top_k_idx.reshape(-1).long()
    flat_sample = torch.arange(b * k, device=dev) // k
    onehot = torch.zeros(b * k, num_experts, dtype=torch.long,
                         device=dev).scatter_(1, flat_e[:, None], 1)
    if keep is not None:
        onehot = onehot * keep[:, None]
    # position of each assignment within its expert (count of earlier ones)
    before = onehot.cumsum(0) - onehot
    pos = before.gather(1, flat_e[:, None])[:, 0]
    keep = pos < capacity if keep is None else keep
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


def make_shard_plan(top_k_idx: torch.Tensor, num_experts: int,
                    capacity: int) -> DispatchPlan:
    """:func:`make_dispatch_plan` of the global batch, for this data rank's
    (B, K) rows: the global plan's survivors among them, on min(capacity,
    B) slots an expert (an expert takes a sample at most once). One process
    gets :func:`make_dispatch_plan` itself."""
    index, count = data_shard()
    if count == 1:
        return make_dispatch_plan(top_k_idx, num_experts, capacity)
    b, k = top_k_idx.shape
    whole = make_dispatch_plan(gather_rows(top_k_idx), num_experts, capacity)
    keep = whole.flat_keep[index * b * k:(index + 1) * b * k]
    return make_dispatch_plan(top_k_idx, num_experts, min(capacity, b), keep)


def dispatch(plan: DispatchPlan, x: torch.Tensor, expert: int) -> torch.Tensor:
    """Expert ``expert``'s inputs: x (B, ...) -> (C, ...), row c the sample
    in its slot c (sample 0 where the slot is empty). One expert at a
    time, so a rank gathers only its own experts' rows."""
    return x[plan.gather_idx[expert]]


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


class GroupPlan(NamedTuple):
    """The routing of G groups of T tokens, K choices a token, onto the
    held experts (``E_h`` of them, C slots a group each, ``S = G * C``
    slots an expert). Assignment ``a = (g * K + k) * T + t`` is choice
    ``k`` of token ``t`` of group ``g``; a token's row is ``g * T + t``."""
    expert: torch.Tensor       # (G, K, T) int64: expert of each assignment
    position: torch.Tensor     # (G, K, T) int64: place in its expert's queue
    kept: torch.Tensor         # (G, K, T) bool: within capacity
    held: torch.Tensor         # (G, K, T) bool: on a held expert
    assign_slot: torch.Tensor  # (G*K*T,) int64: slot, E_h*S if none
    slot_assign: torch.Tensor  # (E_h*S,) int64: assignment, G*K*T if empty
    slot_token: torch.Tensor   # (E_h, S) int64: token row, 0 if empty
    counts: torch.Tensor       # (G, E) int64: assignments an expert got


def make_group_plan(top_k_idx: torch.Tensor, num_experts: int,
                    capacity: int, held: range) -> GroupPlan:
    """(G, T, K) expert indices -> the choice-major plan of the held
    experts ``held`` (a contiguous range). An expert takes the first
    ``capacity`` assignments of a group in choice-major order; the rest
    are dropped. Static shapes, no device -> host copy."""
    g, t, k = top_k_idx.shape
    dev = top_k_idx.device
    flat_e = top_k_idx.transpose(1, 2).reshape(g, k * t).long()
    # (G, E, KT) one-hot, counted along its last axis: a scan along the
    # innermost axis, in int32 (an outer-axis int64 scan of the (G, KT, E)
    # one-hot takes milliseconds at 25,216 assignments a group)
    onehot = (flat_e[:, None, :] == torch.arange(
        num_experts, device=dev)[None, :, None]).int()
    before = onehot.cumsum(-1, dtype=torch.int32) - onehot
    pos = before.gather(1, flat_e[:, None, :])[:, 0].long()
    kept = pos < capacity
    on_held = (flat_e >= held.start) & (flat_e < held.stop)
    slots = len(held) * g * capacity
    local = (flat_e - held.start).clamp(0, len(held) - 1)
    group = torch.arange(g, device=dev)[:, None]
    slot = (local * g + group) * capacity + pos.clamp(max=capacity - 1)
    assign_slot = torch.where(kept & on_held, slot,
                              torch.full_like(slot, slots)).reshape(-1)
    n = g * k * t
    # the last entry collects every assignment that takes no slot and is
    # cut off: every other slot is written by exactly one assignment
    slot_assign = torch.full((slots + 1,), n, dtype=torch.long, device=dev)
    slot_assign.index_put_((assign_slot,), torch.arange(n, device=dev))
    slot_assign = slot_assign[:slots]
    token = (group * t + torch.arange(t, device=dev)).repeat(1, k).reshape(-1)
    token = torch.cat([token, token.new_zeros(1)])
    return GroupPlan(expert=flat_e.view(g, k, t), position=pos.view(g, k, t),
                     kept=kept.view(g, k, t), held=on_held.view(g, k, t),
                     assign_slot=assign_slot, slot_assign=slot_assign,
                     slot_token=token[slot_assign].view(len(held), -1),
                     counts=onehot.sum(-1, dtype=torch.long))


def dispatch_held(plan: GroupPlan, x: torch.Tensor) -> torch.Tensor:
    """Every held expert's inputs in one gather: x (G*T, D) token rows ->
    (E_h, S, D), slot s of expert e the token in it (row 0 where the slot
    is empty)."""
    return x[plan.slot_token]


def gather_assigned(plan: GroupPlan, slot_rows: torch.Tensor) -> torch.Tensor:
    """(E_h, S, D) per-slot rows -> (G*K*T, D), each assignment's slot row
    (zero for an assignment that takes no slot)."""
    flat = slot_rows.reshape(-1, slot_rows.shape[-1])
    return torch.cat([flat, flat.new_zeros(1, flat.shape[-1])])[
        plan.assign_slot]


def gather_slots(plan: GroupPlan, assign_rows: torch.Tensor) -> torch.Tensor:
    """(G*K*T, D) per-assignment rows -> (E_h, S, D), each slot's
    assignment row (zero in an empty slot): the transpose of
    :func:`gather_assigned`, as a gather."""
    d = assign_rows.shape[-1]
    return torch.cat([assign_rows, assign_rows.new_zeros(1, d)])[
        plan.slot_assign].view(*plan.slot_token.shape, d)
