"""Seeded images for the serving cells: smooth RGB pictures (a random 8x8
grid, bicubic-upscaled) whose sides take a fixed set of sizes, spread
evenly over [side_min, side_max] and dealt out in the seed's order, so
that every seed decodes and resizes the same pixel counts."""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def sides(count: int, lo: int, hi: int, rng: np.random.Generator):
    """(width, height) pairs: each side an even quantile of [lo, hi],
    widths and heights each in a seeded order."""
    q = np.round(lo + (hi - lo) * (np.arange(count) + 0.5) / count).astype(int)
    return list(zip(rng.permutation(q).tolist(), rng.permutation(q).tolist()))


def picture(grid: np.ndarray, size: tuple[int, int]):
    from PIL import Image
    return Image.fromarray(grid).resize(size, Image.BICUBIC)


def make_pictures(count: int, lo: int, hi: int, seed: int,
                  order_seed: int | None = None):
    """``count`` in-memory PIL images: pixels from ``seed``, the order of
    their sizes from ``order_seed`` (default ``seed``)."""
    rng = np.random.default_rng([seed, 7])
    grids = rng.integers(0, 256, (count, 8, 8, 3), dtype=np.uint8)
    sizes = sides(count, lo, hi, np.random.default_rng(
        [seed if order_seed is None else order_seed, 8]))
    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(picture, grids, sizes))


def write_folder(root: str, count: int, classes: list[str], lo: int, hi: int,
                 quality: int, seed: int) -> list[str]:
    """An image folder of ``count`` JPEGs, one directory a class, image i in
    class i mod len(classes); returns the paths."""
    rng = np.random.default_rng([seed, 11])
    grids = rng.integers(0, 256, (count, 8, 8, 3), dtype=np.uint8)
    sizes = sides(count, lo, hi, rng)
    for name in classes:
        os.makedirs(os.path.join(root, name), exist_ok=True)
    paths = [os.path.join(root, classes[i % len(classes)], f"img_{i:05d}.jpg")
             for i in range(count)]

    def write(i):
        picture(grids[i], sizes[i]).save(paths[i], quality=quality)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(count)))
    return paths
