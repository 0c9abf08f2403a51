"""V-MoE's forward in plain float32 PyTorch operations (Riquelme et al.,
"Scaling Vision with Sparse Mixture of Experts", NeurIPS 2021,
arXiv:2106.05974), on one expert-parallel rank's share of the experts.

The dense layers are ``vit_plain``'s ViT. In each MoE layer the MLP is

    MoE(x) = sum_{i in top-k} g_i(x) e_i(x),   g(x) = softmax(W x + eps),

written out one step at a time:

- the router: ``x W^T`` in float32 on the float32 output of the layer's
  second LayerNorm, no bias, over all E experts;
- training noise ``eps = (noise_std / E) z``, ``z`` standard normal, one
  (G, T, E) draw a MoE layer in layer order (``noise``, drawn by the
  caller);
- top-k of the softmax of the noisy logits by a stable descending sort
  (ties to the lower expert), the k gates kept as they are (no
  renormalisation);
- capacity: the group's assignments listed choice-major (every token's
  first choice, in token order, then every second choice); an expert keeps
  its first ``ceil(k T capacity_factor / E)``, counted one expert at a time
  by a running sum over that list;
- each held expert (``held``, a range of expert indices) runs
  ``gelu(x w1 + b1) w2 + b2`` on the rows of its kept assignments, in
  their order, and its outputs times their gates are added to their
  tokens; assignments to experts outside ``held`` are planned and add
  nothing (this rank's share of the layer);
- the auxiliary loss of a group: ``importance_weight (std/mean)^2`` of the
  clean softmax summed over the tokens, plus ``load_weight (std/mean)^2``
  of the load, each token's probability ``1 - Phi((eta_k - l_i) / sigma)``
  that expert i's clean logit ``l_i`` beats the k-th largest noisy logit
  ``eta_k`` under fresh noise, summed over the tokens (population std over
  the experts).

Departures from the paper, all shared with the program: the router's
noise, capacity and loss weights are those listed under ``assumed`` in the
configuration file, not read from the vmoe repository; the load uses one
threshold for every expert (the k-th largest noisy logit, as the vmoe code
does, where Shazeer et al. take the k-th largest of the other experts);
the rank's share keeps the router's E outputs and drops the assignments of
the experts it does not hold instead of sending them to another card; the
head has the cell's 120 classes.

``precision='fp8'`` rounds every operand of every product, the experts'
and the router's included, to float8 e4m3 as ``vit_plain`` does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .vit_plain import PlainViT


def capacity(tokens: int, k: int, experts: int, factor: float) -> int:
    return max(1, math.ceil(tokens * k / experts * factor))


class PlainVMoE(PlainViT):
    """The forward of one group of images. ``moe`` holds ``layers``,
    ``experts``, ``top_k``, ``capacity_factor``, ``noise_std``,
    ``importance_weight``, ``load_weight`` and ``held`` (first, last + 1)."""

    def __init__(self, params, shape, moe: dict, precision: str = "fp32"):
        super().__init__(params, shape, precision)
        self.moe = moe

    def _route(self, x, logits, noise, train):
        """Kept assignments of one group and its auxiliary loss."""
        m = self.moe
        t, e = logits.shape
        k = m["top_k"]
        sigma = m["noise_std"] / e
        noisy = logits + sigma * noise if train and sigma > 0 else logits
        probs = torch.softmax(noisy, dim=-1)
        order = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate = order.values[:, :k].t().reshape(-1)          # choice-major
        expert = order.indices[:, :k].t().reshape(-1)
        token = torch.arange(t, device=x.device).repeat(k)
        cap = capacity(t, k, e, m["capacity_factor"])
        kept = torch.zeros_like(expert, dtype=torch.bool)
        for i in range(e):
            mine = expert == i
            kept |= mine & (torch.cumsum(mine.long(), 0) <= cap)
        aux = logits.new_zeros(())
        if train:
            importance = torch.softmax(logits, dim=-1).sum(0)
            eta = torch.sort(noisy, dim=-1, descending=True).values[:, k - 1:k]
            if sigma > 0:
                z = (eta - logits) / sigma
                p = 1.0 - 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))
            else:
                p = (logits >= eta).float()
            load = p.sum(0)
            aux = (m["importance_weight"] * _cv2(importance)
                   + m["load_weight"] * _cv2(load))
        return gate, expert, token, kept, aux

    def _moe(self, x, pre, noise, train):
        """One group's (T, C) rows -> (output, aux, (expert, kept))."""
        m = self.moe
        h = F.layer_norm(x, (x.shape[-1],), self.p[pre + "ln2.weight"],
                         self.p[pre + "ln2.bias"], self.s["eps"])
        logits = self.q(h) @ self.q(self.p[pre + "moe.router.weight"]).t()
        gate, expert, token, kept, aux = self._route(h, logits, noise, train)
        out = torch.zeros_like(x)
        first, last = m["held"]
        for i in range(first, last):
            rows = torch.nonzero(kept & (expert == i))[:, 0]
            if not len(rows):
                continue
            j = i - first
            a = F.gelu(self.q(h[token[rows]]) @ self.q(self.p[pre + "moe.w1"][j])
                       + self.p[pre + "moe.b1"][j])
            y = self.q(a) @ self.q(self.p[pre + "moe.w2"][j]) + self.p[pre + "moe.b2"][j]
            out = out.index_add(0, token[rows], y * gate[rows, None])
        k = m["top_k"]
        return out, aux, (expert.view(k, -1), kept.view(k, -1))

    def forward(self, images: torch.Tensor, noise: list | None,
                train: bool = True):
        """(B, S, S, 3) normalised images of one routing group -> (logits,
        the group's auxiliary loss, [(expert, kept) (K, T) of each MoE
        layer]); ``noise`` one (T, E) standard normal a MoE layer."""
        s = self.s
        b, size, _, ch = images.shape
        p = s["patch"]
        g = size // p
        x = images.reshape(b, g, p, g, p, ch).permute(0, 1, 3, 2, 4, 5)
        x = self._linear(x.reshape(b, g * g, p * p * ch), "patch_embed.proj")
        cls = self.p["cls_token"].expand(b, -1, -1)
        x = torch.cat([cls, x], dim=1) + self.p["pos_embed"]
        aux, routes = x.new_zeros(()), []
        layers = list(self.moe["layers"])
        for i in range(s["layers"]):
            pre = f"layer.{i}."
            x = x + self._attention(self._ln(x, pre + "ln1"), pre)
            if i in layers:
                n = x.shape[1]
                y, a, route = self._moe(
                    x.reshape(b * n, -1), pre,
                    None if noise is None else noise[layers.index(i)], train)
                x = x + y.view(b, n, -1)
                aux = aux + a
                routes.append(route)
            else:
                h = F.gelu(self._linear(self._ln(x, pre + "ln2"),
                                        pre + "mlp.fc1"))
                x = x + self._linear(h, pre + "mlp.fc2")
        x = self._ln(x, "final_ln")
        return self._linear(x[:, 0], "head"), aux, routes


def _cv2(v: torch.Tensor) -> torch.Tensor:
    """(std / mean)^2 of a vector, population std."""
    mean = v.mean()
    return ((v - mean).square().mean().sqrt() / mean).square()
