"""Model factory (counterpart of the JAX package's ``models/__init__.py``).

The port has the ViT and ResNet families; the other families raise, naming
the ROADMAP.md item that brings them.
"""
from __future__ import annotations

from typing import Any

from ..config import NUM_CLASSES, ResNetConfig, ViTConfig, vit_config
from .resnet import (ResNet, resnet, resnet18, resnet34, resnet50, resnet101,
                     resnet152)
from .vit import ViT

__all__ = ["ViT", "ResNet", "resnet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "create_model", "EXPORT_CONFIGS",
           "model_config_key"]

_NOT_PORTED = {
    "vit-moe": "ResMoE (ROADMAP.md queue 1, item 10)",
    "resmoe": "ResMoE (ROADMAP.md queue 1, item 10)",
    "tree-vit": "TreeViT (ROADMAP.md queue 1, item 11)",
    "treevit": "TreeViT (ROADMAP.md queue 1, item 11)",
}

# a serving export's ``serving_meta.json`` keeps the model's config under
# its family's key
EXPORT_CONFIGS = {"vit_config": (ViT, ViTConfig),
                  "resnet_config": (ResNet, ResNetConfig)}


def model_config_key(model) -> str | None:
    """The :data:`EXPORT_CONFIGS` key of ``model``'s family (None for a
    model of another kind)."""
    return next((key for key, (cls, _) in EXPORT_CONFIGS.items()
                 if isinstance(model, cls)), None)


def create_model(model_type: str, num_classes: int = NUM_CLASSES,
                 compute_dtype: str = "bfloat16", device=None,
                 param_dtype: str | None = None, seed: int = 0,
                 **overrides: Any) -> ViT | ResNet:
    """``vit-base``, ``vit-large`` or ``google/vit-*`` -> :class:`ViT`;
    ``resnet18`` ... ``resnet152`` (``resnet`` = ``resnet152``) ->
    :class:`ResNet`; initialised from ``seed``. ``param_dtype`` defaults to
    ``compute_dtype`` (serving); training passes ``'float32'``."""
    mt = model_type.lower()
    kw = dict(compute_dtype=compute_dtype, device=device,
              param_dtype=param_dtype, seed=seed)
    if mt in ("vit-base", "vit-large") or mt.startswith("google/vit"):
        return ViT(vit_config(mt, num_classes=num_classes, **overrides), **kw)
    if mt.startswith("resnet"):
        return resnet(int(mt.removeprefix("resnet") or 152), num_classes,
                      **kw, **overrides)
    family = next((v for k, v in _NOT_PORTED.items() if mt.startswith(k)), None)
    if family is not None:
        raise NotImplementedError(f"model type {model_type!r} is not ported "
                                  f"yet: {family}")
    raise ValueError(f"Unknown model type: {model_type}")
