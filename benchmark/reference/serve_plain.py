"""Serving's preprocessing and scores in plain float32 PyTorch: PIL's
decode and resize of the raw images, the antialiased-linear resize of a
canvas to the model's size, ImageNet normalisation, the ViT logits."""
from __future__ import annotations

import numpy as np
import torch

from .augment_plain import normalize, resize
from .vit_plain import PlainViT, exact_fp32, logits_in_blocks


def pil_canvas(image, size: tuple[int, int]) -> np.ndarray:
    """An in-memory PIL image as RGB uint8 (h, w, 3), bilinear resize."""
    from PIL import Image
    return np.asarray(image.convert("RGB").resize((size[1], size[0]),
                                                  Image.BILINEAR), np.uint8)


def decode_canvas(path: str, size: tuple[int, int]) -> np.ndarray:
    """A JPEG file as RGB uint8 (h, w, 3): PIL's draft decode at the
    smallest DCT scale not under ``size``, then a bilinear resize."""
    from PIL import Image
    with Image.open(path) as im:
        if im.format == "JPEG":
            im.draft("RGB", (size[1], size[0]))
        return np.asarray(im.convert("RGB").resize((size[1], size[0]),
                                                   Image.BILINEAR), np.uint8)


def serve_logits(w0: dict[str, torch.Tensor], shape: dict,
                 canvases: np.ndarray, device, precision: str = "fp32",
                 block: int = 32) -> torch.Tensor:
    """(K, H, W, 3) uint8 canvases -> (K, classes) float32 logits."""
    exact_fp32()
    model = PlainViT({k: t.float() for k, t in w0.items()}, shape, precision)
    out = (shape["image"], shape["image"])
    parts = []
    for i in range(0, len(canvases), block):
        x = torch.from_numpy(canvases[i:i + block]).to(device).float() / 255.0
        if tuple(x.shape[1:3]) != out:
            x = resize(x, out)
        parts.append(logits_in_blocks(model, normalize(x), block))
    return torch.cat(parts)
