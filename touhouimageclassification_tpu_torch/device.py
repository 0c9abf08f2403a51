"""Explicit device resolution (counterpart of the JAX package's
``ops/_pallas_compat.py``, which picks interpret mode off the TPU).

The port never picks a device on its own: callers name one, ``cuda`` by
default at the entry points, and asking for CUDA on a machine without a GPU
is an error rather than a quiet move to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a GPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is not available; pass "
                "device='cpu' explicitly to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
