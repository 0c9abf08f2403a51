"""Weight conversion for the port's ViT.

- :func:`from_jax_params` maps the JAX package's ViT parameter tree (numpy
  arrays, Dense kernels laid out (in, out)) onto the port's state dict. It is
  the bridge every parity test uses, and the one layout bridge of the loader.
- :func:`load_vit_weights` reads a reference or HF checkpoint (``.pth``,
  ``.pt``, ``.bin`` or ``.safetensors``) with the JAX package's own readers
  and its HF -> parameter-tree converter, then applies
  :func:`from_jax_params`. A classifier whose size disagrees with the class
  count is re-initialised there (``ignore_mismatched_sizes``).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from touhouimageclassification_tpu.config import ViTConfig
from touhouimageclassification_tpu.utils.convert import (_normalize_ckpt,
                                                         torch_vit_to_flax)
from touhouimageclassification_tpu.utils.pretrained import _load_state_dict


def _dense(tree: Mapping[str, Any]) -> tuple[np.ndarray, np.ndarray]:
    """Dense (in, out) kernel -> nn.Linear (out, in) weight, plus bias."""
    return np.asarray(tree["kernel"]).T, np.asarray(tree["bias"])


def _norm(tree: Mapping[str, Any]) -> tuple[np.ndarray, np.ndarray]:
    return np.asarray(tree["scale"]), np.asarray(tree["bias"])


def from_jax_params(params: Mapping[str, Any], cfg: ViTConfig) -> dict[str, torch.Tensor]:
    """JAX ``ViT`` parameters -> state dict of the port's ``ViT(cfg)``.

    Accepts the tree with or without its ``{"params": ...}`` wrapper. Raises
    if the tree's depth disagrees with ``cfg.num_layers``."""
    params = params.get("params", params)
    depth = sum(k.startswith("layer_") for k in params)
    if depth != cfg.num_layers:
        raise ValueError(f"parameter tree has {depth} encoder layers, the "
                         f"config {cfg.num_layers}")
    pairs: dict[str, tuple[np.ndarray, np.ndarray]] = {
        "patch_embed.proj": _dense(params["patch_embed"]["proj"]),
        "final_ln": _norm(params["final_ln"]),
        "head": _dense(params["head"]),
    }
    for i in range(depth):
        layer = params[f"layer_{i}"]
        pairs.update({
            f"layer.{i}.ln1": _norm(layer["ln1"]),
            f"layer.{i}.attn.qkv": _dense(layer["attn"]["qkv"]),
            f"layer.{i}.attn.out": _dense(layer["attn"]["out"]),
            f"layer.{i}.ln2": _norm(layer["ln2"]),
            f"layer.{i}.mlp.fc1": _dense(layer["mlp"]["fc1"]),
            f"layer.{i}.mlp.fc2": _dense(layer["mlp"]["fc2"]),
        })
    sd = {"cls_token": np.asarray(params["cls_token"]),
          "pos_embed": np.asarray(params["pos_embed"])}
    for name, (weight, bias) in pairs.items():
        sd[f"{name}.weight"], sd[f"{name}.bias"] = weight, bias
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in sd.items()}


def load_vit_weights(path: str, cfg: ViTConfig) -> dict[str, torch.Tensor]:
    """HF-layout ViT checkpoint at ``path`` -> state dict of ``ViT(cfg)``,
    with a fresh head when the checkpoint's has another class count."""
    if path.endswith(".safetensors"):
        ckpt = _load_state_dict(path)
    else:
        ckpt = _normalize_ckpt(path)
    return from_jax_params(torch_vit_to_flax(ckpt, cfg.num_classes), cfg)
