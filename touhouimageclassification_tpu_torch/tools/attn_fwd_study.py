"""Design questions of the bf16 attention forward, measured on one GPU:

    python -m touhouimageclassification_tpu_torch.tools.attn_fwd_study \\
        [--reps 30]

Through ``tic_attention_fwd_variant`` (the forward kernel of K1, K3 and K4
with its block shape and exponential chosen by the caller; on no path of the
model) it times, on the (B, N, 3C) slab of ViT-L (N 197, C 1024, 16 heads of
64) at batch 64 (the train step and the serve bucket 64) and batch 1 (serve
bucket 1), each of

- 64, 32 or 16 query rows a block (4, 2 or 1 warps): a question of this
  port's own grid (the TPU study ``tools/bench_attn4.py`` asks another, how
  many whole images one grid step takes: the port's ``tools.bench_attn4``);
- ``exp2`` of scores scaled by log2(e) against ``exp``: half of the TPU
  study ``tools/bench_attn6.py``, whose four variants (with the divide of P
  before PV or 1 / l after it) the port's ``tools.bench_attn6`` times;

and holds each against the plain version (max |diff| and relative
difference in norm). It also times the model's own launch
(``slab_attention_forward``, on the route ``kernel_route`` names: the
Hopper ``wgmma`` kernel at these shapes, two products; the variants' kernel
issues three) and prints its achieved rates against the card's published
peaks (``tools.roofline_attn`` attributes the mma.sync kernel's time to its
parts). One JSON line
per measurement; the card's name and power limit last. Medians of ``--reps``
CUDA-event timings after 5 warm-up launches.
"""
from __future__ import annotations

import argparse
import json
import sys

from .timing import PEAK_BF16, PEAK_BYTES, card_line, cuda_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)

    import torch

    from ..ops import attention as attn
    from ..ops._build import load_library

    if not torch.cuda.is_available():
        print("attn_fwd_study needs an NVIDIA GPU", file=sys.stderr)
        return 1
    lib = load_library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    n, c, h = 197, 1024, 16
    d = c // h
    for b in (64, 1):
        qkv = torch.randn(b, n, 3 * c, generator=gen, device=dev).to(
            torch.bfloat16)
        ref = attn.slab_attention_reference(qkv, h).float()
        stream = torch.cuda.current_stream(dev).cuda_stream

        def variant(warps, exp2, out):
            err = lib.tic_attention_fwd_variant(
                qkv.data_ptr(), qkv.data_ptr() + 2 * c, qkv.data_ptr() + 4 * c,
                3 * n * c, 3 * c, out.data_ptr(), b, n, h, d, d ** -0.5, warps,
                exp2, stream)
            if err:
                raise RuntimeError(f"variant ({warps}, {exp2}): CUDA error {err}")

        for warps in (4, 2, 1):
            for exp2 in (1, 0):
                out = torch.empty((b, n, c), dtype=torch.bfloat16, device=dev)
                variant(warps, exp2, out)
                torch.cuda.synchronize()
                diff = out.float() - ref
                print(json.dumps({
                    "batch": b, "rows_per_block": 16 * warps,
                    "exp": "exp2" if exp2 else "exp",
                    "ms": cuda_ms(torch, lambda: variant(warps, exp2, out),
                                  args.reps),
                    "max_abs_err": diff.abs().max().item(),
                    "rel_err": (diff.norm() / ref.norm()).item()}), flush=True)
        ms = cuda_ms(torch, lambda: attn.slab_attention_forward(qkv, h),
                     args.reps)
        flops = 2 * 2 * b * h * n * n * d      # the bound's two products
        route = attn.kernel_route(torch.bfloat16, d, n)
        # mma.sync: S twice and PV once; wgmma: S once and PV once
        issued = (3 if route == "mma" else 2) * 2 * b * h * n * n * d
        nbytes = 4 * b * n * c * 2             # q, k, v read, o written
        print(json.dumps({
            "batch": b, "model_launch_ms": ms, "model_route": route,
            "tflops_issued": issued / ms / 1e9,
            "share_of_bf16_peak": issued / ms / 1e-3 / PEAK_BF16,
            "tb_per_s": nbytes / ms / 1e9,
            "share_of_memory_rate": nbytes / ms / 1e-3 / PEAK_BYTES,
            "bound_ms": 1e3 * max(flops / PEAK_BF16, nbytes / PEAK_BYTES)}),
            flush=True)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
