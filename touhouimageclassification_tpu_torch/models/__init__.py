"""Model factory (counterpart of the JAX package's ``models/__init__.py``).

The port has the ViT family so far; the other families raise, naming the
ROADMAP.md item that brings them.
"""
from __future__ import annotations

from typing import Any

from ..config import NUM_CLASSES, vit_config
from .vit import ViT

__all__ = ["ViT", "create_model"]

_NOT_PORTED = {
    "resnet": "ResNet (ROADMAP.md queue 1, item 9)",
    "vit-moe": "ResMoE (ROADMAP.md queue 1, item 10)",
    "resmoe": "ResMoE (ROADMAP.md queue 1, item 10)",
    "tree-vit": "TreeViT (ROADMAP.md queue 1, item 11)",
    "treevit": "TreeViT (ROADMAP.md queue 1, item 11)",
}


def create_model(model_type: str, num_classes: int = NUM_CLASSES,
                 compute_dtype: str = "bfloat16", device=None,
                 param_dtype: str | None = None, **overrides: Any) -> ViT:
    """``vit-base``, ``vit-large`` or ``google/vit-*`` -> :class:`ViT`.
    ``param_dtype`` defaults to ``compute_dtype`` (serving); training passes
    ``'float32'``."""
    mt = model_type.lower()
    if mt in ("vit-base", "vit-large") or mt.startswith("google/vit"):
        cfg = vit_config(mt, num_classes=num_classes, **overrides)
        return ViT(cfg, compute_dtype=compute_dtype, device=device,
                   param_dtype=param_dtype)
    family = next((v for k, v in _NOT_PORTED.items() if mt.startswith(k)), None)
    if family is not None:
        raise NotImplementedError(f"model type {model_type!r} is not ported "
                                  f"yet: {family}")
    raise ValueError(f"Unknown model type: {model_type}")
