"""The softmax variants (S2) of the slab attention forward, on one GPU:

    python -m touhouimageclassification_tpu_torch.tools.bench_attn6 \\
        [--batch 128 64] [--reps 30]

Counterpart of the TPU study ``tools/bench_attn6.py`` (``make_fwd``: exp or
exp2, and P = e / sum e before PV or O = (e V) * (1 / sum e) after it),
under its keys ``exp2`` and ``post_mul`` and its ``fwd_ms_per_app``. Here the
four variants run on K1's own tile, grid (ceil(N / 64), H, B)
(``softmax_variant_forward``, ``csrc/slab_attention_tile.cu``): ``exp2``
without ``post_mul`` is K1 bit for bit; ``post_mul`` rounds the
unnormalised e to bf16 and scales O's f32 fragments by each row's 1 / l, one
rounding of P apart from K1, and is held to its own plain version
(``softmax_variant_reference``). What each record holds beside the keys:
``tools/attn_tiles.py``. Exits 1 without a GPU.
"""
from __future__ import annotations

import sys

from . import attn_tiles

STUDY = "S2"


def measure(batches=(128, 64), reps: int = 30) -> list[dict]:
    return attn_tiles.measure(STUDY, batches, reps)


def main(argv=None) -> int:
    return attn_tiles.main(STUDY, "bench_attn6", __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
