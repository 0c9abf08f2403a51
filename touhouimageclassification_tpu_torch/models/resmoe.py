"""ResMoE: a mixture of ViT experts with a ViT gate (counterpart of the JAX
package's ``models/resmoe.py``).

The reference (``TIC/ResMoE/model.py:11-72``): E full ViT-Base experts and a
ViT-Base gate scoring them (top-k, N(0, ``gateway_t``) noise on its logits
in training, softmax over the top k). The module layout is the reference's
torch one: ``gate.vit`` and ``experts.{i}`` (an ``nn.ModuleList`` of the
port's :class:`ViT`), where the JAX package stacks the experts on a leading
axis with ``nn.vmap``; ``utils.convert.from_jax_params`` maps one onto the
other. Every member is a ViT on its config's ``attention_impl``, so on the
default ``'fused'`` each member's forward runs K1 once an encoder layer and
its backward K2.

- ``routing='dense'`` (the reference's numerics): every expert runs on the
  whole batch, combined with the scattered (B, E) top-k weights;
- ``routing='sparse'`` dispatches by capacity (``ops/moe_dispatch.py``):
  with ``dispatch_level='feature'`` every expert embeds the whole batch with
  its own weights and encodes only its C routed token sequences; with
  ``'image'`` it runs on its C routed images.

The forward returns ``(combined_logits, gate_for_loss, top_k_indices)``:
``gate_for_loss`` is the full f32 router softmax under
``balance_loss='switch'`` (its gradient must reach unselected experts), else
the scattered top-k weights, as in JAX.

Under an active mesh (``parallel.collectives``) the gate is replicated and
each expert rank runs only its own experts; the stacked expert outputs are
summed over the expert group before the combine, which every rank then
computes whole. Under data parallelism the gate noise is drawn for the
global batch and the capacity plan is the global batch's
(``moe_dispatch.make_shard_plan``). The JAX package's ``_constrain``
(sharding constraints over a device mesh) has no counterpart.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..config import MoEConfig, ViTConfig, vit_config
from ..ops import moe_dispatch as md
from ..parallel.collectives import global_count, global_rows, stack_members
from .vit import ViT


def member_seed(seed: int, index: int) -> int:
    """The init seed of member ``index`` of a model seeded with ``seed``:
    each member draws its own weights, as JAX's ``nn.vmap`` splits the
    params key."""
    return int(np.random.default_rng([seed, index]).integers(2 ** 63))


def top_k(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest values of each row and their indices, ties to the lower
    index as ``jax.lax.top_k`` breaks them (a stable descending sort;
    ``torch.topk`` promises no order among equal values)."""
    values, indices = torch.sort(logits, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _member_vit_cfg(cfg: MoEConfig, num_classes: int) -> ViTConfig:
    base = cfg.expert_vit or vit_config(cfg.expert_model_name)
    return dataclasses.replace(base, num_classes=num_classes)


class GatingNetwork(nn.Module):
    """ViT gate: logits over the experts -> (softmaxed top-k weights,
    indices, f32 router softmax over all experts). In training the logits
    get N(0, ``gateway_t``) noise drawn from the ``generator`` the caller
    passes (the reference's ``TIC/ResMoE/model.py:33-38``)."""

    def __init__(self, cfg: MoEConfig, compute_dtype: str = "bfloat16",
                 device=None, param_dtype: str | None = None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.vit = ViT(_member_vit_cfg(cfg, cfg.num_experts), compute_dtype,
                       device, param_dtype, seed)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None):
        logits = self.vit(x)
        if self.training:
            if generator is None:
                raise ValueError("a training forward of the gate needs a "
                                 "torch.Generator for its logit noise")
            noise = global_rows(lambda n: torch.randn(
                (n, *logits.shape[1:]), generator=generator,
                device=logits.device, dtype=logits.dtype), logits.shape[0])
            logits = logits + noise * self.cfg.gateway_t
        top_w, top_i = top_k(logits, self.cfg.top_k)
        router_probs = torch.softmax(logits.float(), dim=-1)
        return torch.softmax(top_w, dim=-1), top_i, router_probs


class MoEClassifier(nn.Module):
    """``gate`` + ``experts``, each member initialised from its own seed
    (:func:`member_seed`: the gate index 0, expert i index i + 1)."""

    def __init__(self, cfg: MoEConfig, compute_dtype: str = "bfloat16",
                 device=None, param_dtype: str | None = None, seed: int = 0):
        super().__init__()
        if cfg.routing not in ("dense", "sparse"):
            raise ValueError(f"Unknown routing {cfg.routing!r}")
        if cfg.dispatch_level not in ("feature", "image"):
            raise ValueError(f"Unknown dispatch_level {cfg.dispatch_level!r}")
        self.cfg = cfg
        self.gate = GatingNetwork(cfg, compute_dtype, device, param_dtype,
                                  member_seed(seed, 0))
        expert_cfg = _member_vit_cfg(cfg, cfg.num_classes)
        self.experts = nn.ModuleList(
            ViT(expert_cfg, compute_dtype, device, param_dtype,
                member_seed(seed, i + 1)) for i in range(cfg.num_experts))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None):
        cfg = self.cfg
        b = x.shape[0]
        gate_w, top_i, router_probs = self.gate(x, generator)
        # the dense (B, E) gate for the combine and the quadratic penalty
        gate_dense = torch.zeros(b, cfg.num_experts, dtype=gate_w.dtype,
                                 device=gate_w.device).scatter(1, top_i,
                                                               gate_w)
        gate_for_loss = (router_probs if cfg.balance_loss == "switch"
                         else gate_dense)
        if cfg.routing == "dense":
            expert_logits = stack_members(lambda i: self.experts[i](x),
                                          cfg.num_experts)
            combined = torch.einsum("be,ebc->bc", gate_dense.float(),
                                    expert_logits.float())
            return combined, gate_for_loss, top_i
        capacity = md.capacity_for(global_count(b), cfg.top_k,
                                   cfg.num_experts, cfg.capacity_factor)
        plan = md.make_shard_plan(top_i, cfg.num_experts, capacity)
        if cfg.dispatch_level == "feature":
            def run(i):
                e = self.experts[i]
                return e.encode(md.dispatch(plan, e.embed(x), i))
        else:
            def run(i):                                  # (C, H, W, 3) in
                return self.experts[i](md.dispatch(plan, x, i))
        expert_logits = stack_members(run, cfg.num_experts)
        combined = md.combine(plan, expert_logits, gate_w, b)
        return combined, gate_for_loss, top_i


def make_vit_moe(num_classes: int, num_experts: int = 8, top_k: int = 2,
                 gateway_t: float = 0.01, routing: str = "dense",
                 model_name: str = "google/vit-base-patch16-224",
                 **kwargs) -> MoEClassifier:
    """The reference's ``make_ViTMoE`` (``TIC/ResMoE/model.py:60-72``);
    ``kwargs`` go to :class:`MoEClassifier` (dtype, device, seed)."""
    return MoEClassifier(MoEConfig(
        num_experts=num_experts, top_k=top_k, expert_model_name=model_name,
        gateway_t=gateway_t, num_classes=num_classes, routing=routing),
        **kwargs)
