"""V-MoE: a ViT whose MLP in every other encoder layer is a sparse mixture
of expert MLPs routed token by token (Riquelme et al., "Scaling Vision with
Sparse Mixture of Experts", NeurIPS 2021, arXiv:2106.05974).

The dense layers, the attention, the LayerNorms, the patch embedding and
the head are the port's ViT modules (``models/vit.py``) unchanged. In a MoE
layer (``VMoEConfig.layers``, by default 1, 3, 5, ...) the MLP becomes

    MoE(x) = sum_i g(x)_i e_i(x),    g(x) = TOP_k(softmax(W x + eps)),

each expert ``e_i`` a GELU MLP of the ViT's widths, ``W`` a router with no
bias, ``eps ~ N(0, (noise_std / E)^2)`` drawn in training only, from the
``generator`` the caller passes (the train step's task generator). TOP_k
keeps the k largest gates and does not renormalise them. The router, its
softmax and the auxiliary losses run in float32 on the float32 output of
the layer's second LayerNorm; the experts run in the compute dtype.

Routing is per token in groups of ``group_images`` images (``T`` tokens):
an expert takes at most ``C = ceil(k T capacity_factor / E)`` assignments
of a group, every token's first choice placed before any token's second
(``ops/moe_dispatch.py::make_group_plan``); assignments past capacity are
dropped and the residual carries their tokens. Evaluation draws no noise
and keeps the same capacity rule.

A model holds the experts ``VMoEConfig.held()`` of the E (the share of one
expert-parallel rank, ``parallel/sharding.py::owned_members``): their
weights stacked as ``w1`` (E_h, hidden, mlp), ``b1``, ``w2`` (E_h, mlp,
hidden), ``b2``. The router keeps all E outputs: assignments to experts
the model does not hold are planned, take their places in the queues, and
add nothing to its output. One gather feeds every held expert
(``dispatch_held``), two batched products with the GELU between them run
all of them at once, and a weighted gather combines each token's kept
assignments (:class:`_HeldExperts`, whose backward is written out).

The training forward returns ``(logits, aux)``: ``aux`` is the weighted sum
over MoE layers of each layer's importance and load losses (Shazeer et
al. 2017, as V-MoE uses them), each the squared coefficient of variation
over the experts of a group, averaged over the groups. Importance sums the
clean softmax; load sums each token's probability of beating the k-th
largest noisy logit under a fresh draw of the noise.

Spans (``utils/profiling.py``), each timed on the device: ``moe.route``
(router, noise, top-k, plan; counts ``assignments``, ``kept_held``
(assignments kept on held experts), ``dropped`` (assignments past
capacity, all experts), ``load_max`` (the largest queue of a group over
the capacity)), ``moe.dispatch``, ``moe.experts``, ``moe.combine``; the
same names with ``backward=1`` in the backward. The counts are computed
only while a span records.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ViTConfig
from ..ops import moe_dispatch as md
from ..ops.gelu import gelu
from ..parallel.sharding import owned_members
from ..utils.profiling import span
from .resmoe import top_k
from .vit import (_DTYPES, _TRUNCATED_STD, EncoderLayer, LayerNorm,
                  PatchEmbed, _truncated_normal_)


@dataclasses.dataclass(frozen=True)
class VMoEConfig:
    """V-MoE's knobs over a ViT's. ``moe_layers`` None: every odd layer.
    ``noise_std`` is in units of 1/E. The model holds the experts of rank
    ``expert_index`` of ``num_expert_shards`` (all of them with one)."""

    vit: ViTConfig = ViTConfig()
    moe_layers: tuple[int, ...] | None = None
    num_experts: int = 32
    top_k: int = 2
    capacity_factor: float = 1.05
    noise_std: float = 1.0
    importance_weight: float = 0.005
    load_weight: float = 0.005
    group_images: int = 64
    num_expert_shards: int = 1
    expert_index: int = 0

    @property
    def num_classes(self) -> int:
        return self.vit.num_classes

    def layers(self) -> tuple[int, ...]:
        if self.moe_layers is not None:
            return tuple(self.moe_layers)
        return tuple(range(1, self.vit.num_layers, 2))

    def held(self) -> range:
        return owned_members(self.num_experts, self.num_expert_shards,
                             self.expert_index)


def group_count(batch: int, group_images: int) -> int:
    """Routing groups of a batch: one under ``group_images`` images, else
    ``batch / group_images``, which must divide."""
    if batch <= group_images:
        return 1
    if batch % group_images:
        raise ValueError(f"a batch of {batch} images does not split into "
                         f"routing groups of {group_images}")
    return batch // group_images


class _BackwardPhase:
    """A span over the backward of a stretch of autograd ops: opened when
    the gradient reaches the stretch's output (:class:`_OpenInBackward`),
    closed when it leaves its input (:class:`_CloseInBackward`)."""

    def __init__(self, name: str, device: torch.device):
        self.name, self.device, self.handle = name, device, None


class _OpenInBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, phase):
        ctx.phase = phase
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        phase = ctx.phase
        phase.handle = span(phase.name, device=phase.device, backward=1)
        phase.handle.__enter__()
        return grad, None


class _CloseInBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, phase):
        ctx.phase = phase
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        phase = ctx.phase
        if phase.handle is not None:
            phase.handle.__exit__(None, None, None)
            phase.handle = None
        return grad, None


class _HeldExperts(torch.autograd.Function):
    """Dispatch, the held experts and the combine of one MoE layer.

    Forward: the (G, T, D) token rows gathered into (E_h, S, D) slots, the
    experts ``gelu(x w1 + b1) w2 + b2`` as two batched products, and each
    token's output the float32 sum over its K assignments of gate times
    the assignment's slot row (zero for one that took no slot). Backward,
    in the reverse order: the gates' gradient (the slot row dotted with the
    output's gradient) and each slot's gradient (its assignment's gate
    times the output's gradient, a gather); the experts' products; each
    token's gradient, the float32 sum of its assignments' slot gradients (a
    gather: an empty slot's gradient is exactly zero, so the rows it read
    get nothing from it)."""

    @staticmethod
    def forward(ctx, x, gates, w1, b1, w2, b2, plan, k, variant):
        g, t, d = x.shape
        with span("moe.dispatch", device=x.device):
            xd = md.dispatch_held(plan, x.reshape(g * t, d))  # (E_h, S, D)
        with span("moe.experts", device=x.device):
            h1 = torch.baddbmm(b1[:, None], xd, w1)
            ye = torch.baddbmm(b2[:, None], gelu(h1, variant), w2)
        with span("moe.combine", device=x.device):
            picked = md.gather_assigned(plan, ye).view(g, k, t, d)
            y = (picked.float() * gates.view(g, k, t, 1)).sum(1)
        ctx.save_for_backward(xd, h1, ye, gates, w1, w2)
        ctx.plan, ctx.k, ctx.variant = plan, k, variant
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        xd, h1, ye, gates, w1, w2 = ctx.saved_tensors
        plan, k, variant = ctx.plan, ctx.k, ctx.variant
        g, t, d = dy.shape
        dev = dy.device
        with span("moe.combine", device=dev, backward=1):
            dy_k = dy.float()[:, None].expand(g, k, t, d).reshape(-1, d)
            picked = md.gather_assigned(plan, ye).float()
            d_gates = (picked * dy_k).sum(-1)
            del picked
            d_ye = md.gather_slots(plan, (dy_k * gates[:, None]).to(ye.dtype))
            del dy_k
        with span("moe.experts", device=dev, backward=1):
            a = gelu(h1, variant)
            d_w2 = torch.bmm(a.transpose(1, 2), d_ye)
            d_b2 = d_ye.sum(1)
            del a
            d_h1 = torch.ops.aten.gelu_backward(
                torch.bmm(d_ye, w2.transpose(1, 2)), h1,
                approximate="tanh" if variant == "tanh" else "none")
            d_w1 = torch.bmm(xd.transpose(1, 2), d_h1)
            d_b1 = d_h1.sum(1)
            d_xd = torch.bmm(d_h1, w1.transpose(1, 2))
        with span("moe.dispatch", device=dev, backward=1):
            dx = md.gather_assigned(plan, d_xd).view(g, k, t, d).float().sum(1)
        return (dx.to(dy.dtype), d_gates, d_w1, d_b1, d_w2, d_b2, None, None,
                None)


def _coefficient_of_variation_sq(v: torch.Tensor) -> torch.Tensor:
    """(G, E) -> (G,): (std / mean)^2 over the experts (population std)."""
    return (v.std(-1, unbiased=False) / v.mean(-1)).square()


class MoEMlp(nn.Module):
    """The sparse MLP of a MoE layer: a float32 router over all E experts
    and the held experts' stacked weights (in ``param_dtype``, computed in
    ``dtype``)."""

    def __init__(self, cfg: VMoEConfig, dtype: torch.dtype,
                 param_dtype: torch.dtype, device=None):
        super().__init__()
        vit = cfg.vit
        c, m, h = vit.hidden_size, vit.mlp_dim, len(cfg.held())
        self.cfg, self.compute_dtype, self.gelu = cfg, dtype, vit.gelu
        self.router = nn.Linear(c, cfg.num_experts, bias=False,
                                dtype=torch.float32, device=device)
        kw = dict(dtype=param_dtype, device=device)
        self.w1 = nn.Parameter(torch.empty(h, c, m, **kw))
        self.b1 = nn.Parameter(torch.zeros(h, m, **kw))
        self.w2 = nn.Parameter(torch.empty(h, m, c, **kw))
        self.b2 = nn.Parameter(torch.zeros(h, c, **kw))

    def capacity(self, tokens: int) -> int:
        cfg = self.cfg
        return md.capacity_for(tokens, cfg.top_k, cfg.num_experts,
                               cfg.capacity_factor)

    def route(self, x: torch.Tensor, generator: torch.Generator | None):
        """(G, T, D) float32 rows -> (plan, (G*K*T,) float32 gates, aux
        loss). Training draws the noise from ``generator``."""
        cfg = self.cfg
        g, t, _ = x.shape
        k, e = cfg.top_k, cfg.num_experts
        sigma = cfg.noise_std / e
        phase = _BackwardPhase("moe.route", x.device)
        with span("moe.route", device=x.device) as record:
            logits = F.linear(_CloseInBackward.apply(x, phase),
                              self.router.weight)
            noisy = logits
            if self.training and sigma > 0:
                if generator is None:
                    raise ValueError("a training forward of V-MoE needs a "
                                     "torch.Generator for its router noise")
                noisy = logits + sigma * torch.randn(
                    logits.shape, generator=generator, device=x.device)
            top_p, top_i = top_k(torch.softmax(noisy, dim=-1), k)
            capacity = self.capacity(t)
            plan = md.make_group_plan(top_i, e, capacity, cfg.held())
            gates = _OpenInBackward.apply(
                top_p.transpose(1, 2).reshape(-1), phase)
            aux = (self._aux_loss(logits, noisy, sigma) if self.training
                   else logits.new_zeros(()))
            if record.recording:
                live = plan.kept & plan.held
                record.set(assignments=g * k * t, kept_held=live.sum(),
                           dropped=(~plan.kept).sum(),
                           load_max=plan.counts.max() / capacity)
        return plan, gates, aux

    def _aux_loss(self, logits, noisy, sigma):
        """The weighted importance and load losses, averaged over groups."""
        cfg = self.cfg
        importance = torch.softmax(logits, dim=-1).sum(1)
        threshold = noisy.topk(cfg.top_k, dim=-1).values[..., -1:]
        if sigma > 0:
            p = 1.0 - torch.special.ndtr((threshold - logits) / sigma)
        else:
            p = (logits >= threshold).float()
        return (cfg.importance_weight
                * _coefficient_of_variation_sq(importance).mean()
                + cfg.load_weight
                * _coefficient_of_variation_sq(p.sum(1)).mean())

    def forward(self, x: torch.Tensor, generator=None):
        """(B, N, D) float32 normalised rows -> ((B, N, D) in the compute
        dtype, aux loss)."""
        b, n, d = x.shape
        g = group_count(b, self.cfg.group_images)
        plan, gates, aux = self.route(x.reshape(g, b // g * n, d), generator)
        dt = self.compute_dtype
        y = _HeldExperts.apply(
            x.reshape(g, -1, d).to(dt), gates, self.w1.to(dt),
            self.b1.to(dt), self.w2.to(dt), self.b2.to(dt), plan,
            self.cfg.top_k, self.gelu)
        return y.reshape(b, n, d), aux


class MoEEncoderLayer(EncoderLayer):
    """Pre-LN block whose MLP is :class:`MoEMlp`; the second LayerNorm's
    output stays float32 for the router."""

    def __init__(self, cfg: VMoEConfig, dtype: torch.dtype,
                 param_dtype: torch.dtype, device=None):
        super().__init__(cfg.vit, dtype, param_dtype, device)
        del self.mlp
        self.moe = MoEMlp(cfg, dtype, param_dtype, device)

    def forward(self, x: torch.Tensor, generator=None):
        x = x + self.attn(self.ln1(x))
        y, aux = self.moe(self.ln2(x, out_dtype=torch.float32), generator)
        return x + y, aux


class VMoE(nn.Module):
    """V-MoE classifier: ``forward(images, generator=None)`` maps (B, S, S,
    3) images to ``((B, classes) f32 logits, aux loss)``. The parameter
    names are the ViT's, with ``layer.{i}.moe.{router.weight, w1, b1, w2,
    b2}`` in place of a MoE layer's ``mlp``. ``seed`` seeds the
    initialisation: the ViT's (``models/vit.py``), and each expert's
    projections ``lecun_normal`` of their fan-in with zero biases."""

    def __init__(self, cfg: VMoEConfig, compute_dtype: str = "bfloat16",
                 device=None, param_dtype: str | None = None, seed: int = 0):
        super().__init__()
        param_dtype = param_dtype or compute_dtype
        vit = cfg.vit
        if vit.remat:
            raise ValueError("V-MoE runs without remat")
        bad = [i for i in cfg.layers() if not 0 <= i < vit.num_layers]
        if bad:
            raise ValueError(f"MoE layers {bad} outside 0..{vit.num_layers}")
        self.cfg = cfg
        self.dtype = dtype = _DTYPES[compute_dtype]
        pdtype = _DTYPES[param_dtype]
        self.patch_embed = PatchEmbed(vit, dtype, pdtype, device)
        self.cls_token = nn.Parameter(
            torch.zeros(1, 1, vit.hidden_size, dtype=pdtype, device=device))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, vit.seq_len, vit.hidden_size, dtype=pdtype,
                        device=device))
        moe = set(cfg.layers())
        self.layer = nn.ModuleList(
            MoEEncoderLayer(cfg, dtype, pdtype, device) if i in moe
            else EncoderLayer(vit, dtype, pdtype, device)
            for i in range(vit.num_layers))
        self.final_ln = LayerNorm(vit.hidden_size, eps=vit.layer_norm_eps,
                                  device=device)
        self.head = nn.Linear(vit.hidden_size, vit.num_classes,
                              dtype=torch.float32, device=device)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        gen = torch.Generator(device=self.pos_embed.device).manual_seed(seed)
        for module in self.modules():
            if isinstance(module, nn.LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)
            elif isinstance(module, nn.Linear):
                _truncated_normal_(module.weight,
                                   module.in_features ** -0.5 / _TRUNCATED_STD,
                                   gen)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)
            elif isinstance(module, MoEMlp):
                for w in (module.w1, module.w2):
                    _truncated_normal_(w, w.shape[1] ** -0.5 / _TRUNCATED_STD,
                                       gen)
                nn.init.zeros_(module.b1)
                nn.init.zeros_(module.b2)
        nn.init.zeros_(self.cls_token)
        self.pos_embed.copy_(0.02 * torch.randn(
            self.pos_embed.shape, generator=gen, device=self.pos_embed.device))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None):
        vit = self.cfg.vit
        if x.shape[1] != vit.image_size or x.shape[2] != vit.image_size:
            raise ValueError(f"Input spatial size {tuple(x.shape[1:3])} != "
                             f"configured {(vit.image_size,) * 2}")
        x = self.patch_embed(x.to(self.dtype))
        cls = self.cls_token.to(self.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        if vit.dropout_rate > 0 and self.training:
            x = F.dropout(x, vit.dropout_rate)
        aux = torch.zeros((), device=x.device)
        for layer in self.layer:
            if isinstance(layer, MoEEncoderLayer):
                x, a = layer(x, generator)
                aux = aux + a
            else:
                x = layer(x)
        x = self.final_ln(x)
        return self.head(x[:, 0].float()), aux
