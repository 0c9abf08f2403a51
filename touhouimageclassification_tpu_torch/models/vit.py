"""Vision Transformer forward (counterpart of the JAX package's ``models/vit.py``).

Same architecture and numerics as the JAX ``ViT``:

- patch embedding is space-to-depth in (ph, pw, c) order on NHWC images, then
  one matmul + bias (the stride-P conv, written as a library matmul);
- pre-LN encoder layers with a fused QKV projection; with
  ``attention_impl='fused'`` the (B, N, 3C) projection goes straight to the
  slab attention kernels (``ops/attention.py``: K1 forward, K2 backward),
  with ``'xla'`` or ``'xla_remat'`` to the plain version (``'xla_remat'``
  recomputes it in the backward instead of saving the probabilities);
- LayerNorms compute in f32 with f32 weights and return the compute dtype,
  as flax's ``LayerNorm(dtype=..., param_dtype=float32)`` does; the head runs
  in f32.

Weights other than the LayerNorms and the head are held in ``param_dtype``
and cast to ``compute_dtype`` per op, as the JAX model does with its f32
parameters. Training uses f32 parameters (``param_dtype='float32'``), so
gradients land in f32; serving keeps the default ``param_dtype`` =
``compute_dtype``, where the casts are no-ops and launch nothing.

In ``train()`` mode dropout runs where the JAX model applies it when not
``deterministic``: on the embeddings, after the MLP's GELU and on the
attention probabilities of the plain attention. As in JAX, ``'fused'`` with
``attention_dropout_rate > 0`` takes the plain attention. ``remat=True``
recomputes each encoder layer in the backward (``torch.utils.checkpoint``);
the ``'dots'`` policy is not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import ViTConfig
from ..ops.attention import slab_attention, slab_attention_reference
from ..ops.gelu import gelu

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
ATTENTION_IMPLS = ("fused", "xla", "xla_remat")


class LayerNorm(nn.LayerNorm):
    """f32 statistics and weights, output in the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


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
        if cfg.patch_embed_impl == "pallas":
            raise NotImplementedError(
                "patch_embed_impl='pallas' needs kernel K5 (ops/patch_embed.py"
                "::_kernel), still to be ported: ROADMAP.md queue 2")
        self.patch_size = cfg.patch_size
        self.proj = Linear(cfg.patch_size ** 2 * 3, cfg.hidden_size, dtype,
                           param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        b, h, w, c = x.shape
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        return self.proj(x.reshape(b, (h // p) * (w // p), p * p * c))


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype: torch.dtype,
                 param_dtype: torch.dtype, device=None):
        super().__init__()
        if cfg.attention_impl == "flash":
            raise NotImplementedError(
                "attention_impl='flash' needs kernel K4 (ops/attention.py"
                "::_attention_kernel), still to be ported: ROADMAP.md queue 2")
        if cfg.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"Unknown attention_impl {cfg.attention_impl!r}; "
                             f"expected one of {ATTENTION_IMPLS} or 'flash'")
        if cfg.attention_dropout_rate > 0 and cfg.attention_impl == "xla_remat":
            raise ValueError("attention_impl='xla_remat' does not support "
                             "attention_dropout_rate > 0; use 'xla'")
        self.num_heads = cfg.num_heads
        self.dropout = cfg.attention_dropout_rate
        # the JAX rule (models/vit.py): the slab kernels only without
        # attention dropout; 'fused' with dropout takes the plain attention
        self.fused = cfg.attention_impl == "fused" and self.dropout == 0.0
        self.remat = cfg.attention_impl == "xla_remat"
        d = cfg.hidden_size
        self.qkv = Linear(d, 3 * d, dtype, param_dtype, device)
        self.out = Linear(d, d, dtype, param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = self.qkv(x)
        if self.fused:
            out = slab_attention(qkv, self.num_heads)
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
    embeddings."""

    def __init__(self, cfg: ViTConfig, compute_dtype: str = "bfloat16",
                 device=None, param_dtype: str | None = None):
        super().__init__()
        param_dtype = param_dtype or compute_dtype
        for name, value in (("compute_dtype", compute_dtype),
                            ("param_dtype", param_dtype)):
            if value not in _DTYPES:
                raise ValueError(f"{name} must be one of {tuple(_DTYPES)}, "
                                 f"got {value!r}")
        if cfg.remat and cfg.remat_policy != "full":
            raise NotImplementedError(
                f"remat_policy={cfg.remat_policy!r} is not ported (ROADMAP.md "
                "'Not ported'); use 'full'")
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
        for layer in self.layer:
            x = checkpoint(layer, x, use_reentrant=False) if remat else layer(x)
        x = self.final_ln(x)
        return self.head(x[:, 0].float())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.encode(self.embed(x))
