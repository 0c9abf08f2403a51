"""Host-side data for the train step: the JAX package's numpy ImageFolder
scan, seeded split and batch loader, which import no JAX as used here.

:func:`image_loader` is ``HostImageLoader`` for one process: it passes
``process_shard=(0, 1)``, because the loader's ``'auto'`` default asks JAX
for the process index. Batches are numpy arrays; ``Trainer.stage`` uploads
them.
"""
from __future__ import annotations

from typing import Any, Sequence

from touhouimageclassification_tpu.data.folder import (random_split,
                                                       scan_image_folder)
from touhouimageclassification_tpu.data.loader import HostImageLoader

__all__ = ["HostImageLoader", "image_loader", "random_split",
           "scan_image_folder"]


def image_loader(index, indices: Sequence[int], **kwargs: Any) -> HostImageLoader:
    """``HostImageLoader(index, indices, process_shard=(0, 1), **kwargs)``."""
    return HostImageLoader(index, indices, process_shard=(0, 1), **kwargs)
