"""Null copy of the attention slab through the slab kernels' tilings, on one
GPU:

    python -m touhouimageclassification_tpu_torch.tools.bench_dma \\
        [--batch 128 64] [--reps 30]

Counterpart of the TPU study ``tools/bench_dma.py`` (S6), under its keys.
Each variant reads every byte of a bf16 (B, n, 3C) slab (ViT-L: C 1024)
through shared memory and writes one (B, n, C) third
(``ops/attention_study.py::null_copy``, ``csrc/slab_null_copy.cu``):

  n197      the shipped shape, 64 rows of one image a block (as K1 tiles N)
  n208/n256 the same on a slab made at 208 / 256 rows
  img1/2/4  1, 2 or 4 whole images a block (the TPU study's fewer, bigger
            DMAs; img1 is its n197 block); at B 128, 128 / 64 / 32 blocks on
            the card's 132 SMs
  img4n208  4 images a block at 208 rows
  lanes     grid (B, 3), a block per third; the j = 2 blocks store
  torch_copy  ``qkv[..., :C] * 1.000001`` in PyTorch (the TPU study's
            ``xla_copy``): the card's streaming rate on an elementwise op,
            a library measurement beside the kernel

Per batch, one JSON line holding for each: ``ms`` (median of ``--reps``
CUDA-event timings of one launch, after 5 warm-ups) and ``device_ms`` (20
launches back to back behind a spin kernel, median of 10), the bound (the
slab read and one third written, 2 bytes each, at 3.35 TB/s), each time's
share of it and its effective GB/s over the same bytes, and whether the
output equals its plain version bit for bit. The reference's ``chain`` term
has no counterpart: nothing is chained. The card's name and power limit
last. Exits 1 without a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys

from .timing import PEAK_BYTES, card_line, cuda_ms

N, C = 197, 1024


def copy_bytes(b: int, n: int, c: int = C) -> int:
    """Bytes a null copy must move: the (B, n, 3C) slab read, one (B, n, C)
    third written, bf16."""
    return b * n * 4 * c * 2


def rates(ms: float, nbytes: int) -> dict:
    """A time's share of the bytes bound and its effective GB/s."""
    bound = 1e3 * nbytes / PEAK_BYTES
    return {"share_of_bound": bound / ms, "gb_per_s": nbytes / ms / 1e6}


def measure(batches=(128, 64), reps: int = 30) -> list[dict]:
    """Every variant and ``torch_copy`` at each batch (slabs from a seeded
    generator on the card), one dict per batch."""
    import torch

    from ..ops import attention_study as study

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = sorted({r or N for _, _, r in study.NULL_COPY_VARIANTS.values()})
    results = []
    for b in batches:
        slabs = {n: torch.randn(b, n, 3 * C, generator=gen, device=dev).to(
            torch.bfloat16) for n in rows}
        runs = {}
        for variant, (_, _, padded) in study.NULL_COPY_VARIANTS.items():
            qkv = slabs[padded or N]
            runs[variant] = (
                qkv, lambda qkv=qkv, v=variant: study.null_copy(qkv, C, v),
                lambda qkv=qkv, v=variant: study.null_copy_reference(qkv, C, v))
        runs["torch_copy"] = (slabs[N], lambda qkv=slabs[N]: qkv[..., :C] *
                              1.000001, None)
        out = {}
        for key, (qkv, run, plain) in runs.items():
            nbytes = copy_bytes(b, qkv.shape[1])
            rec = {"n": qkv.shape[1],
                   "bound_ms": 1e3 * nbytes / PEAK_BYTES}
            if plain is not None:
                got = run()
                torch.cuda.synchronize()
                rec["bit_equal"] = torch.equal(got, plain())
            rec["ms"] = cuda_ms(torch, run, reps)
            rec["device_ms"] = cuda_ms(torch, run, 10, calls=20)
            rec.update({f"{k}_launch": v for k, v in
                        rates(rec["ms"], nbytes).items()})
            rec.update(rates(rec["device_ms"], nbytes))
            out[key] = rec
        results.append({"batch": b, "c": C, "dtype": "bfloat16",
                        "variants": out})
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[128, 64])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_dma needs an NVIDIA GPU", file=sys.stderr)
        return 1
    for result in measure(args.batch, args.reps):
        print(json.dumps(result), flush=True)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
