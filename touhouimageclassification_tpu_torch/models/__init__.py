"""Model factory (counterpart of the JAX package's ``models/__init__.py``):
ViT, ResNet, ResMoE and TreeViT; and V-MoE, which the JAX package does not
have (``models/vmoe.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from ..config import (NUM_CLASSES, MoEConfig, ResNetConfig, TreeViTConfig,
                      ViTConfig, vit_config)
from .resmoe import MoEClassifier
from .resnet import (ResNet, resnet, resnet18, resnet34, resnet50, resnet101,
                     resnet152)
from .treevit import TreeViT
from .vit import ViT
from .vmoe import VMoE, VMoEConfig

__all__ = ["ViT", "ResNet", "MoEClassifier", "TreeViT", "VMoE", "VMoEConfig",
           "resnet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "create_model",
           "EXPORT_CONFIGS", "model_config_key", "config_from_dict",
           "member_vit_config", "input_size"]

# a serving export's ``serving_meta.json`` keeps the model's config under
# its family's key
EXPORT_CONFIGS = {"vit_config": (ViT, ViTConfig),
                  "resnet_config": (ResNet, ResNetConfig),
                  "moe_config": (MoEClassifier, MoEConfig),
                  "treevit_config": (TreeViT, TreeViTConfig)}


def model_config_key(model) -> str | None:
    """The :data:`EXPORT_CONFIGS` key of ``model``'s family (None for a
    model of another kind)."""
    return next((key for key, (cls, _) in EXPORT_CONFIGS.items()
                 if isinstance(model, cls)), None)


def config_from_dict(config: type, fields: dict):
    """A config dataclass from its ``dataclasses.asdict`` form (an export's
    meta): a nested dict is a member ViT's config (``MoEConfig.expert_vit``,
    ``TreeViTConfig.vit``), rebuilt as a :class:`ViTConfig`."""
    return config(**{k: ViTConfig(**v) if isinstance(v, dict) else v
                     for k, v in fields.items()})


def member_vit_config(cfg) -> ViTConfig | None:
    """The ViT config a mixture's members are built from (None for a ViT
    or ResNet config): ``expert_vit`` or ``expert_model_name``'s, or
    ``vit`` or ViT-Base; V-MoE's ``vit``."""
    if isinstance(cfg, VMoEConfig):
        return cfg.vit
    if isinstance(cfg, MoEConfig):
        return cfg.expert_vit or vit_config(cfg.expert_model_name)
    if isinstance(cfg, TreeViTConfig):
        return cfg.vit or vit_config("vit-base")
    return None


def input_size(model) -> tuple[int, int]:
    """The (H, W) a model of any family takes."""
    size = (member_vit_config(model.cfg) or model.cfg).image_size
    return size, size


def create_model(model_type: str, num_classes: int = NUM_CLASSES,
                 compute_dtype: str = "bfloat16", device=None,
                 param_dtype: str | None = None, seed: int = 0,
                 **overrides: Any):
    """``vit-base``, ``vit-large`` or ``google/vit-*`` -> :class:`ViT`;
    ``resnet18`` ... ``resnet152`` (``resnet`` = ``resnet152``) ->
    :class:`ResNet`; ``vit-moe`` or ``resmoe`` -> :class:`MoEClassifier`,
    ``tree-vit`` or ``treevit`` -> :class:`TreeViT` (``overrides`` are
    fields of their ``MoEConfig`` / ``TreeViTConfig``); initialised from
    ``seed``. ``param_dtype`` defaults to ``compute_dtype`` (serving);
    training passes ``'float32'``."""
    mt = model_type.lower()
    kw = dict(compute_dtype=compute_dtype, device=device,
              param_dtype=param_dtype, seed=seed)
    if mt in ("vit-base", "vit-large") or mt.startswith("google/vit"):
        return ViT(vit_config(mt, num_classes=num_classes, **overrides), **kw)
    if mt.startswith("resnet"):
        return resnet(int(mt.removeprefix("resnet") or 152), num_classes,
                      **kw, **overrides)
    if mt in ("vit-moe", "resmoe"):
        return MoEClassifier(dataclasses.replace(
            MoEConfig(num_classes=num_classes), **overrides), **kw)
    if mt in ("tree-vit", "treevit"):
        return TreeViT(dataclasses.replace(
            TreeViTConfig(num_classes=num_classes), **overrides), **kw)
    raise ValueError(f"Unknown model type: {model_type}")
