"""Augmentation visualizer (counterpart of the JAX package's
``analysis/aug.py``).

Runs the named transform recipes (original / grey / colorjitter x8 / full
x16) on one image and saves a PNG grid per recipe under
``show_augmentation/``. The recipes are the trainer's own
(``ops/augment.py::build_augment_fn``), run on ``device`` (``cuda`` by
default; CUDA without a GPU raises), tile i drawing from a
``torch.Generator`` on that device seeded ``seed + i``, so what is shown is
what training sees. The normalisation is undone on the host, as the JAX
package undoes it, and the tiles are clipped to [0, 1].

CLI: ``python -m touhouimageclassification_tpu_torch.analysis.aug --image
x.jpg [--out-dir show_augmentation] [--device cuda]``
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..config import AugmentConfig
from ..device import resolve_device
from ..ops.augment import build_augment_fn

# (name, config, repeats): the JAX package's table
AUGS: list[tuple[str, AugmentConfig | None, int]] = [
    ("original", None, 1),
    ("grey", AugmentConfig(only_grey_augmentation=True), 8),
    ("colorjitter", AugmentConfig(enable_generalization=False), 8),
    ("full", AugmentConfig(), 16),
]


def load_base(image_path: str) -> np.ndarray:
    """The image as (256, 256, 3) f32 in [0, 1] (PIL's bilinear resize)."""
    from PIL import Image

    with Image.open(image_path) as im:
        im = im.convert("RGB").resize((256, 256), Image.BILINEAR)
        return np.asarray(im, np.float32) / 255.0


def augment_tiles(base: np.ndarray, cfg: AugmentConfig, repeats: int,
                  out_size: tuple[int, int], seed: int,
                  device: torch.device) -> np.ndarray:
    """``repeats`` draws of the recipe ``cfg`` on ``base`` (tile i from a
    generator seeded ``seed + i``), denormalised and clipped:
    (repeats, H, W, 3) on the host."""
    fn = build_augment_fn(cfg, out_size)
    images = torch.from_numpy(base[None]).to(device)
    tiles = []
    for i in range(repeats):
        gen = torch.Generator(device=device).manual_seed(seed + i)
        out = fn(gen, images).cpu().numpy()
        out = out * np.asarray(cfg.std) + np.asarray(cfg.mean)  # denorm
        tiles.append(np.clip(out, 0, 1))
    return np.concatenate(tiles, axis=0)


def visualize(image_path: str, out_dir: str = "show_augmentation",
              out_size: tuple[int, int] = (224, 224), seed: int = 0,
              device="cuda") -> list[str]:
    from PIL import Image

    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    base = load_base(image_path)
    written = []
    for name, cfg, repeats in AUGS:
        tiles = (base[None] if cfg is None else
                 augment_tiles(base, cfg, repeats, out_size, seed, device))
        grid = _to_grid(tiles)
        path = os.path.join(out_dir, f"{name}.png")
        Image.fromarray((grid * 255).astype(np.uint8)).save(path)
        written.append(path)
    return written


def _to_grid(batch: np.ndarray) -> np.ndarray:
    n, h, w, c = batch.shape
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    grid = np.ones((rows * h, cols * w, c), batch.dtype)
    for i in range(n):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = batch[i]
    return grid


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Visualize augmentation recipes")
    parser.add_argument("--image", required=True)
    parser.add_argument("--out-dir", default="show_augmentation")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)
    for p in visualize(args.image, args.out_dir, device=args.device):
        print(p)


if __name__ == "__main__":
    main()
