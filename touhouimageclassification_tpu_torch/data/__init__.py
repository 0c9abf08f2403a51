"""Host-side data for the port (its own copies of the JAX package's numpy
data modules): ImageFolder indexing (``folder``), JPEG decode into fixed
uint8 canvases and the batch loader (``loader``, ``native_loader``), and the
decoded-canvas cache (``canvas_cache``). Batches are numpy arrays;
``Trainer.stage`` and ``Predictor.stage`` upload them.

:func:`image_loader` is ``HostImageLoader``; in a multi-process run each
rank loads its slice of every global batch (the ``'auto'`` view, which the
trainer's ``set_process_view`` refines from its mesh).
"""
from __future__ import annotations

from typing import Any, Sequence

from .folder import (ImageFolderIndex, get_class_to_idx, random_split,
                     scan_image_folder)
from .loader import HostImageLoader, decode_image

__all__ = ["HostImageLoader", "ImageFolderIndex", "decode_image",
           "get_class_to_idx", "image_loader", "random_split",
           "scan_image_folder"]


def image_loader(index, indices: Sequence[int], **kwargs: Any) -> HostImageLoader:
    """``HostImageLoader(index, indices, **kwargs)``."""
    return HostImageLoader(index, indices, **kwargs)
