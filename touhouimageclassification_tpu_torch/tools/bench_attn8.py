"""Heads split over blocks (S4) of the slab attention forward and backward,
on one GPU:

    python -m touhouimageclassification_tpu_torch.tools.bench_attn8 \\
        [--batch 128 64] [--reps 30]

Counterpart of the TPU study ``tools/bench_attn8.py`` (``fwd_split``,
``bwd_split``: grid (B, S), H / S heads a step read as lane-offset views of
one (B, N, 3C) slab), under its key ``splits`` and its ``fwd_ms_per_app`` and
``bwd_ms_per_app``. Here a block of 4 warps walks one image's H / S heads
and all their rows, one head's operands staged at a time through a two-stage
``cp.async`` ring, straight from the slab by column offset
(``Tile(splits=S)``, ``csrc/slab_attention_tile.cu``): a grid of S x B
blocks, K1's and K2's outputs bit for bit. ``splits`` 1 is S1's ``block_b``
1 and S3's ``loop``. What each record holds beside the key:
``tools/attn_tiles.py``. Exits 1 without a GPU.
"""
from __future__ import annotations

import sys

from . import attn_tiles

STUDY = "S4"


def measure(batches=(128, 64), reps: int = 30) -> list[dict]:
    return attn_tiles.measure(STUDY, batches, reps)


def main(argv=None) -> int:
    return attn_tiles.main(STUDY, "bench_attn8", __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
