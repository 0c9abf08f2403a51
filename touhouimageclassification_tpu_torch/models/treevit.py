"""TreeViT: a root ViT picks categories, son ViTs classify (counterpart of
the JAX package's ``models/treevit.py``).

The reference (``TIC/TreeViT/model.py:7-30``): ``root`` scores S
categories, each sample goes through its top-k sons, and the son logits
are combined with the softmaxed top-k weights. The layout is the
reference's: ``root`` and ``sons.{i}`` (an ``nn.ModuleList`` of the port's
:class:`ViT`; the JAX package stacks the sons with ``nn.vmap``).

- ``route_labels`` (B,): teacher-forced routing, each sample to the son of
  its category with weight 1 (the staged curriculum's sons stage);
- eval (``not self.training``) with ``eval_dense=True``: every son runs on
  the whole batch and the top-k weights pick the combination, the
  reference's per-sample loop, which never drops;
- otherwise capacity dispatch (``ops/moe_dispatch.py``), the combine
  divided by the weight mass that survived capacity, so a sample that lost
  one of its copies keeps reference-scale logits and a fully dropped one
  stays 0.

Returns ``(combined_logits, root_choice_logits, kept_mass)``.

Under an active mesh (``parallel.collectives``) the root is replicated and
each expert rank runs only its own sons, their stacked outputs summed over
the expert group; under data parallelism the capacity plan is the global
batch's (``moe_dispatch.make_shard_plan``).
"""
from __future__ import annotations

import dataclasses
import logging

import torch
from torch import nn

from ..config import VIT_BASE, TreeViTConfig
from ..ops import moe_dispatch as md
from ..parallel.collectives import global_count, stack_members
from .resmoe import member_seed, top_k
from .vit import ViT

_dense_eval_warned = False


def _warn_dense_once(num_categories: int, k: int) -> None:
    """Dense eval runs all S sons on the whole batch, S/K times the son
    compute of capacity dispatch: say so once a process."""
    global _dense_eval_warned
    if _dense_eval_warned:
        return
    _dense_eval_warned = True
    logging.getLogger(__name__).info(
        "TreeViT eval_dense=True: deterministic forwards run every son on the "
        "full batch (~%d/%d = %.1fx the son compute of capacity dispatch); "
        "set eval_dense=False for capacity-dispatch eval cost parity.",
        num_categories, k, num_categories / max(k, 1))


class TreeViT(nn.Module):
    """``root`` + ``sons``, each initialised from its own seed
    (:func:`member_seed`: the root index 0, son i index i + 1)."""

    def __init__(self, cfg: TreeViTConfig, compute_dtype: str = "bfloat16",
                 device=None, param_dtype: str | None = None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        base = cfg.vit or VIT_BASE
        self.root = ViT(dataclasses.replace(base,
                                            num_classes=cfg.num_categories),
                        compute_dtype, device, param_dtype,
                        member_seed(seed, 0))
        son_cfg = dataclasses.replace(base, num_classes=cfg.num_classes)
        self.sons = nn.ModuleList(
            ViT(son_cfg, compute_dtype, device, param_dtype,
                member_seed(seed, i + 1)) for i in range(cfg.num_categories))

    def forward(self, x: torch.Tensor,
                route_labels: torch.Tensor | None = None):
        cfg = self.cfg
        b = x.shape[0]
        choice = self.root(x)                                   # (B, S)
        if route_labels is not None:
            top_i = route_labels.reshape(b, 1).long()
            smoothed = torch.ones(b, 1, device=x.device)
        else:
            top_w, top_i = top_k(choice, cfg.top_k)             # (B, K)
            smoothed = torch.softmax(top_w, dim=-1)
        if not self.training and route_labels is None and cfg.eval_dense:
            _warn_dense_once(cfg.num_categories, cfg.top_k)
            son_logits = stack_members(lambda i: self.sons[i](x),
                                       cfg.num_categories)
            # the top-k weights scattered to (B, S), JAX's sum over k of
            # one_hot(top_i) * smoothed (no F.one_hot: its index check
            # syncs with the host)
            w = torch.zeros(b, cfg.num_categories,
                            device=x.device).scatter_add_(1, top_i, smoothed)
            combined = torch.einsum("bs,sbc->bc", w, son_logits.float())
            return combined, choice, torch.ones(b, device=x.device)
        capacity = md.capacity_for(global_count(b), cfg.top_k,
                                   cfg.num_categories, cfg.capacity_factor)
        plan = md.make_shard_plan(top_i, cfg.num_categories, capacity)
        son_logits = stack_members(
            lambda i: self.sons[i](md.dispatch(plan, x, i)),
            cfg.num_categories)
        combined = md.combine(plan, son_logits, smoothed, b)
        kept = md.kept_mass(plan, smoothed, b)
        return combined / kept.clamp(min=1e-9)[:, None], choice, kept

