"""Head batching (S3) of the slab attention forward and backward, on one GPU:

    python -m touhouimageclassification_tpu_torch.tools.bench_attn7 \\
        [--batch 128 64] [--reps 30]

Counterpart of the TPU study ``tools/bench_attn7.py``, under its key
``variant`` and its ``fwd_ms_per_app`` and ``bwd_ms_per_app``. Its grid step
is one image (two for ``loop-i2``), all 16 heads and all N rows; here a
block of 4 warps walks the same, one head's operands staged at a time
through a two-stage ``cp.async`` ring (``csrc/slab_attention_tile.cu``):

  loop     the shipped loop over heads: ``Tile()``, a block an image
  batched  the TPU study's one relayout (N, C) -> (H, N, D) and batched
           products: the heads sit in the TPU's vregs otherwise, while the
           Hopper kernels address a head by its column offset, so it is the
           ``loop`` tile, printed with ``loop``'s numbers and
           ``"same_kernel_as": "loop"``
  pairs    two adjacent heads staged together as one 256-byte row segment
           (the TPU study's 128-lane slices), one stage (two stages of two
           heads exceed a block's shared memory); forward only, as the study
  loop-i2  two images a block (S1's ``block_b`` 2)

Forward and backward (K2's two passes, each on the tile) are K1's and K2's
outputs bit for bit. The TPU study's ship threshold (its docstring: beat
``loop``'s fwd 1.65-1.71 and bwd ~2.9 ms/app) is a TPU number and no
yardstick here. What each record holds beside the key:
``tools/attn_tiles.py``. Exits 1 without a GPU.
"""
from __future__ import annotations

import sys

from . import attn_tiles

STUDY = "S3"


def measure(batches=(128, 64), reps: int = 30) -> list[dict]:
    return attn_tiles.measure(STUDY, batches, reps)


def main(argv=None) -> int:
    return attn_tiles.main(STUDY, "bench_attn7", __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
