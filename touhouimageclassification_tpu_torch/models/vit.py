"""Vision Transformer forward (counterpart of the JAX package's ``models/vit.py``).

Same architecture and numerics as the JAX ``ViT``:

- patch embedding is space-to-depth in (ph, pw, c) order on NHWC images, then
  one matmul + bias (the stride-P conv, written as a library matmul);
- pre-LN encoder layers with a fused QKV projection; with
  ``attention_impl='fused'`` the (B, N, 3C) projection goes straight to the
  slab attention kernel (``ops/attention.py``), with ``'xla'`` or
  ``'xla_remat'`` to the plain version (their forwards are the same; remat
  only matters to training);
- LayerNorms compute in f32 with f32 weights and return the compute dtype,
  as flax's ``LayerNorm(dtype=..., param_dtype=float32)`` does; the head runs
  in f32.

Weights other than the LayerNorms and the head are held in ``compute_dtype``
(the JAX model keeps f32 parameters and casts them to the compute dtype per
op, which rounds the same way). This is the inference forward: dropout is the
identity, and training comes with the train slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from touhouimageclassification_tpu.config import ViTConfig

from ..ops.attention import slab_attention, slab_attention_reference
from ..ops.gelu import gelu

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
ATTENTION_IMPLS = ("fused", "xla", "xla_remat")


class LayerNorm(nn.LayerNorm):
    """f32 statistics and weights, output in the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class PatchEmbed(nn.Module):
    """(B, S, S, 3) NHWC -> (B, N, hidden)."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype, device=None):
        super().__init__()
        if cfg.patch_embed_impl == "pallas":
            raise NotImplementedError(
                "patch_embed_impl='pallas' needs kernel K5 (ops/patch_embed.py"
                "::_kernel), still to be ported: ROADMAP.md queue 2")
        self.patch_size = cfg.patch_size
        self.proj = nn.Linear(cfg.patch_size ** 2 * 3, cfg.hidden_size,
                              dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        b, h, w, c = x.shape
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        return self.proj(x.reshape(b, (h // p) * (w // p), p * p * c))


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype: torch.dtype, device=None):
        super().__init__()
        if cfg.attention_impl == "flash":
            raise NotImplementedError(
                "attention_impl='flash' needs kernel K4 (ops/attention.py"
                "::_attention_kernel), still to be ported: ROADMAP.md queue 2")
        if cfg.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"Unknown attention_impl {cfg.attention_impl!r}; "
                             f"expected one of {ATTENTION_IMPLS} or 'flash'")
        self.num_heads = cfg.num_heads
        self.attend = (slab_attention if cfg.attention_impl == "fused"
                       else slab_attention_reference)
        d = cfg.hidden_size
        self.qkv = nn.Linear(d, 3 * d, dtype=dtype, device=device)
        self.out = nn.Linear(d, d, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(self.attend(self.qkv(x), self.num_heads))


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.gelu = cfg.gelu
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.mlp_dim, dtype=dtype,
                             device=device)
        self.fc2 = nn.Linear(cfg.mlp_dim, cfg.hidden_size, dtype=dtype,
                             device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x), self.gelu))


class EncoderLayer(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype, device=None):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.ln1 = LayerNorm(cfg.hidden_size, eps=eps, device=device)
        self.attn = Attention(cfg, dtype, device)
        self.ln2 = LayerNorm(cfg.hidden_size, eps=eps, device=device)
        self.mlp = Mlp(cfg, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class ViT(nn.Module):
    """ViT classifier: ``forward`` maps (B, S, S, 3) images to (B, classes)
    f32 logits. ``embed`` and ``encode`` stay split as in the JAX model."""

    def __init__(self, cfg: ViTConfig, compute_dtype: str = "bfloat16",
                 device=None):
        super().__init__()
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {tuple(_DTYPES)}, "
                             f"got {compute_dtype!r}")
        self.cfg = cfg
        self.dtype = dtype = _DTYPES[compute_dtype]
        self.patch_embed = PatchEmbed(cfg, dtype, device)
        self.cls_token = nn.Parameter(
            torch.zeros(1, 1, cfg.hidden_size, dtype=dtype, device=device))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.seq_len, cfg.hidden_size, dtype=dtype,
                        device=device))
        self.layer = nn.ModuleList(EncoderLayer(cfg, dtype, device)
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
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        return torch.cat([cls, x], dim=1) + self.pos_embed

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Positioned tokens (B, N+1, hidden) -> logits (B, num_classes)."""
        for layer in self.layer:
            x = layer(x)
        x = self.final_ln(x)
        return self.head(x[:, 0].float())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.encode(self.embed(x))
