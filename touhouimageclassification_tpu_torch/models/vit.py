"""Vision Transformer forward (counterpart of the JAX package's ``models/vit.py``).

Same architecture and numerics as the JAX ``ViT``:

- patch embedding is space-to-depth in (ph, pw, c) order on NHWC images, then
  one matmul + bias (the stride-P conv): with ``patch_embed_impl='xla'`` a
  library matmul in the compute dtype, with ``'pallas'`` the patch-embed
  kernel (``ops/patch_embed.py``, K5: f32 sum and bias, one rounding);
- pre-LN encoder layers with a fused QKV projection; with
  ``attention_impl='fused'`` the (B, N, 3C) projection goes straight to the
  slab attention kernels (``ops/attention.py``: K1 forward, K2 backward),
  with ``'flash'`` its q, k, v views to the (B, N, H, D) attention (K4
  forward, plain recomputed backward), with ``'xla'`` or ``'xla_remat'`` to
  the plain version (``'xla_remat'`` recomputes it in the backward instead
  of saving the probabilities);
- LayerNorms compute in f32 with f32 weights and return the compute dtype,
  as flax's ``LayerNorm(dtype=..., param_dtype=float32)`` does, on CUDA as
  one pair of kernels that read and write the compute dtype
  (``ops/layernorm.py``, N1); the head runs in f32.

Weights other than the LayerNorms and the head are held in ``param_dtype``
and cast to ``compute_dtype`` per op, as the JAX model does with its f32
parameters. Training uses f32 parameters (``param_dtype='float32'``), so
gradients land in f32; serving keeps the default ``param_dtype`` =
``compute_dtype``, where the casts are no-ops and launch nothing.

In ``train()`` mode dropout runs where the JAX model applies it when not
``deterministic``: on the embeddings, after the MLP's GELU and on the
attention probabilities of the plain attention. As in JAX, ``'fused'`` with
``attention_dropout_rate > 0`` takes the plain attention, and ``'flash'``
and ``'xla_remat'`` refuse attention dropout. ``remat=True``
recomputes each encoder layer in the backward (``torch.utils.checkpoint``,
non-reentrant). ``remat_policy='dots'`` is JAX's ``dots_saveable``: the
outputs of the layer's matrix products (``mm``, ``addmm``, ``bmm``,
``baddbmm``) are kept from the forward and everything else is recomputed,
the attention kernels included (K1 is no product, as its custom call is
none to JAX); any other policy recomputes the whole layer, as in JAX.

A new model holds flax's initialisation of the JAX model, drawn from a
``torch.Generator`` on the parameters' device seeded with ``seed``: every
Dense kernel (the patch projection, qkv, out, fc1, fc2 and the head) by
``lecun_normal``, a normal truncated at +-2 standard deviations and scaled
so that its standard deviation is 1/sqrt(fan_in), with zero biases; a zero
class token; the position embedding from normal(0, 0.02); LayerNorm scale 1
and bias 0. The JAX package draws from ``jax.random``, so the two agree in
distribution, not bit for bit; one seed gives the same weights on one
device type.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..config import ViTConfig
from ..ops.attention import (flash_attention, slab_attention,
                             slab_attention_reference)
from ..ops.gelu import gelu
from ..ops.layernorm import layer_norm
from ..ops.patch_embed import patch_embed

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# flax's truncated_normal(-2, 2) has standard deviation 0.8796...; lecun_normal
# divides by it so that the drawn standard deviation is 1/sqrt(fan_in)
_TRUNCATED_STD = 0.87962566103423978
ATTENTION_IMPLS = ("fused", "flash", "xla", "xla_remat")
PATCH_EMBED_IMPLS = ("xla", "pallas")
# the matrix products whose outputs remat_policy='dots' keeps
_DOTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default))


def _dots_saveable(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """JAX's ``dots_saveable`` as a selective-checkpoint policy. Buffers that
    a kernel wrapper allocates (``empty``) are recomputed, so the kernel
    writes into a fresh one on the recompute."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _truncated_normal_(t: torch.Tensor, std: float,
                       gen: torch.Generator) -> None:
    """Fill ``t`` with ``std`` times a standard normal truncated to
    [-2, 2], as ``jax.random.truncated_normal(key, -2, 2)``: draws outside
    the interval are drawn again."""
    x = torch.randn(t.shape, generator=gen, device=t.device)
    bad = x.abs() > 2
    while bad.any():
        x[bad] = torch.randn(int(bad.sum()), generator=gen, device=t.device)
        bad = x.abs() > 2
    t.copy_(x.mul_(std))


class LayerNorm(nn.LayerNorm):
    """f32 statistics and weights, output in the input dtype or
    ``out_dtype`` (``ops/layernorm.py``: its kernel pair on CUDA)."""

    def forward(self, x: torch.Tensor,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps, out_dtype)


class Linear(nn.Linear):
    """Parameters in ``param_dtype``, computed in ``dtype`` (flax's
    ``Dense(dtype=..., param_dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype,
                 param_dtype: torch.dtype, device=None):
        super().__init__(in_features, out_features, dtype=param_dtype,
                         device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(self.compute_dtype),
                        self.bias.to(self.compute_dtype))


class PatchEmbed(nn.Module):
    """(B, S, S, 3) NHWC -> (B, N, hidden)."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype,
                 param_dtype: torch.dtype, device=None):
        super().__init__()
        if cfg.patch_embed_impl not in PATCH_EMBED_IMPLS:
            raise ValueError(f"Unknown patch_embed_impl "
                             f"{cfg.patch_embed_impl!r}; expected one of "
                             f"{PATCH_EMBED_IMPLS}")
        self.kernel = cfg.patch_embed_impl == "pallas"
        self.patch_size = cfg.patch_size
        self.proj = Linear(cfg.patch_size ** 2 * 3, cfg.hidden_size, dtype,
                           param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        if self.kernel:
            dtype = self.proj.compute_dtype
            return patch_embed(x, self.proj.weight.to(dtype),
                               self.proj.bias.to(dtype), p)
        b, h, w, c = x.shape
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        return self.proj(x.reshape(b, (h // p) * (w // p), p * p * c))


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype: torch.dtype,
                 param_dtype: torch.dtype, device=None):
        super().__init__()
        if cfg.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"Unknown attention_impl {cfg.attention_impl!r}; "
                             f"expected one of {ATTENTION_IMPLS}")
        if cfg.attention_dropout_rate > 0 and cfg.attention_impl in (
                "flash", "xla_remat"):
            raise ValueError(f"attention_impl={cfg.attention_impl!r} does not "
                             "support attention_dropout_rate > 0; use 'xla'")
        self.num_heads = cfg.num_heads
        self.dropout = cfg.attention_dropout_rate
        # the JAX rule (models/vit.py): the slab kernels only without
        # attention dropout; 'fused' with dropout takes the plain attention
        self.fused = cfg.attention_impl == "fused" and self.dropout == 0.0
        self.flash = cfg.attention_impl == "flash"
        self.remat = cfg.attention_impl == "xla_remat"
        d = cfg.hidden_size
        self.qkv = Linear(d, 3 * d, dtype, param_dtype, device)
        self.out = Linear(d, d, dtype, param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = self.qkv(x)
        if self.fused:
            out = slab_attention(qkv, self.num_heads)
        elif self.flash:
            # the q, k, v views of the slab (row stride 3C), as vit.py:123-124
            b, n, c3 = qkv.shape
            q, k, v = qkv.reshape(b, n, 3, self.num_heads, -1).unbind(2)
            out = flash_attention(q, k, v).reshape(b, n, c3 // 3)
        elif self.remat and torch.is_grad_enabled():
            # the probabilities are recomputed in the backward, not saved
            out = checkpoint(slab_attention_reference, qkv, self.num_heads,
                             use_reentrant=False)
        else:
            out = slab_attention_reference(
                qkv, self.num_heads, self.dropout if self.training else 0.0)
        return self.out(out)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype: torch.dtype,
                 param_dtype: torch.dtype, device=None):
        super().__init__()
        self.gelu = cfg.gelu
        self.dropout = cfg.dropout_rate
        self.fc1 = Linear(cfg.hidden_size, cfg.mlp_dim, dtype, param_dtype,
                          device)
        self.fc2 = Linear(cfg.mlp_dim, cfg.hidden_size, dtype, param_dtype,
                          device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = gelu(self.fc1(x), self.gelu)
        if self.dropout > 0 and self.training:
            x = F.dropout(x, self.dropout)
        return self.fc2(x)


class EncoderLayer(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype,
                 param_dtype: torch.dtype, device=None):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.ln1 = LayerNorm(cfg.hidden_size, eps=eps, device=device)
        self.attn = Attention(cfg, dtype, param_dtype, device)
        self.ln2 = LayerNorm(cfg.hidden_size, eps=eps, device=device)
        self.mlp = Mlp(cfg, dtype, param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class ViT(nn.Module):
    """ViT classifier: ``forward`` maps (B, S, S, 3) images to (B, classes)
    f32 logits. ``embed`` and ``encode`` stay split as in the JAX model.
    ``param_dtype`` (default: ``compute_dtype``) is the storage type of the
    patch embedding, the encoder's projections and the class and position
    embeddings. ``seed`` seeds the initialisation (:meth:`reset_parameters`)."""

    def __init__(self, cfg: ViTConfig, compute_dtype: str = "bfloat16",
                 device=None, param_dtype: str | None = None, seed: int = 0):
        super().__init__()
        param_dtype = param_dtype or compute_dtype
        for name, value in (("compute_dtype", compute_dtype),
                            ("param_dtype", param_dtype)):
            if value not in _DTYPES:
                raise ValueError(f"{name} must be one of {tuple(_DTYPES)}, "
                                 f"got {value!r}")
        self.cfg = cfg
        self.dtype = dtype = _DTYPES[compute_dtype]
        pdtype = _DTYPES[param_dtype]
        self.patch_embed = PatchEmbed(cfg, dtype, pdtype, device)
        self.cls_token = nn.Parameter(
            torch.zeros(1, 1, cfg.hidden_size, dtype=pdtype, device=device))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.seq_len, cfg.hidden_size, dtype=pdtype,
                        device=device))
        self.layer = nn.ModuleList(EncoderLayer(cfg, dtype, pdtype, device)
                                   for _ in range(cfg.num_layers))
        self.final_ln = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                  device=device)
        self.head = nn.Linear(cfg.hidden_size, cfg.num_classes,
                              dtype=torch.float32, device=device)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """flax's initialisation of the JAX model (module docstring), drawn
        in module order from a generator seeded with ``seed``."""
        gen = torch.Generator(device=self.pos_embed.device).manual_seed(seed)
        for module in self.modules():
            if isinstance(module, nn.LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)
            elif isinstance(module, nn.Linear):
                _truncated_normal_(module.weight,
                                   module.in_features ** -0.5 / _TRUNCATED_STD,
                                   gen)
                nn.init.zeros_(module.bias)
        nn.init.zeros_(self.cls_token)
        self.pos_embed.copy_(0.02 * torch.randn(
            self.pos_embed.shape, generator=gen, device=self.pos_embed.device))

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """Images (B, S, S, 3) -> positioned tokens (B, N+1, hidden)."""
        size = self.cfg.image_size
        if x.shape[1] != size or x.shape[2] != size:
            raise ValueError(f"Input spatial size {tuple(x.shape[1:3])} != "
                             f"configured {(size, size)}")
        x = self.patch_embed(x.to(self.dtype))
        cls = self.cls_token.to(self.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        if self.cfg.dropout_rate > 0 and self.training:
            x = F.dropout(x, self.cfg.dropout_rate)
        return x

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Positioned tokens (B, N+1, hidden) -> logits (B, num_classes)."""
        remat = self.cfg.remat and self.training and torch.is_grad_enabled()
        extra = ({"context_fn": partial(create_selective_checkpoint_contexts,
                                        _dots_saveable)}
                 if self.cfg.remat_policy == "dots" else {})
        for layer in self.layer:
            x = (checkpoint(layer, x, use_reentrant=False, **extra) if remat
                 else layer(x))
        x = self.final_ln(x)
        return self.head(x[:, 0].float())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.encode(self.embed(x))
