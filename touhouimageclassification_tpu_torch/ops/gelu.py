"""GELU variants of the ViT MLP.

In the JAX package ``'fast'`` and ``'poly'`` are polynomial fits to erf GELU
(within 1.5e-6 and 8.3e-7 of it), written only because the TPU v5e vector unit
has no erf instruction. CUDA has one, so here ``'exact'``, ``'fast'`` and
``'poly'`` all compute erf GELU; ``'tanh'`` is the tanh approximation, a
different function.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

GELU_VARIANTS = ("exact", "fast", "poly", "tanh")


def gelu(x: torch.Tensor, variant: str) -> torch.Tensor:
    if variant not in GELU_VARIANTS:
        raise ValueError(f"Unknown gelu variant {variant!r}; expected one of "
                         f"{GELU_VARIANTS}")
    return F.gelu(x, approximate="tanh" if variant == "tanh" else "none")
