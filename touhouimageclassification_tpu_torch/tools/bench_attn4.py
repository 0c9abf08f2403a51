"""Whole images a block (S1) of the slab attention forward, on one GPU:

    python -m touhouimageclassification_tpu_torch.tools.bench_attn4 \\
        [--batch 128 64] [--reps 30]

Counterpart of the TPU study ``tools/bench_attn4.py`` (``fwd_blocked``:
``block_b`` 1, 2 or 4 whole images a grid step, each step all 16 heads and
all N rows), under its key ``block_b`` and its ``fwd_ms_per_app``. Here a
block of 4 warps walks ``block_b`` images, all their heads and all their
rows, one head's K and V staged at a time through a two-stage ``cp.async``
ring (``Tile(images=block_b)``, ``csrc/slab_attention_tile.cu``): a grid of
ceil(B / block_b) blocks, K1's arithmetic, K1's output bit for bit.
``block_b`` 1 is S3's ``loop`` and S4's ``splits`` 1, ``block_b`` 2 S3's
``loop-i2``. What each record holds beside the key: ``tools/attn_tiles.py``.
Exits 1 without a GPU.
"""
from __future__ import annotations

import sys

from . import attn_tiles

STUDY = "S1"


def measure(batches=(128, 64), reps: int = 30) -> list[dict]:
    return attn_tiles.measure(STUDY, batches, reps)


def main(argv=None) -> int:
    return attn_tiles.main(STUDY, "bench_attn4", __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
