"""Roofline peels of the slab attention kernels K1 (forward) and K2
(backward) on one GPU:

    python -m touhouimageclassification_tpu_torch.tools.roofline_attn \\
        [--batch 128 64] [--reps 30]

Counterpart of the TPU study ``tools/roofline_attn.py`` (S5). It runs
cumulative peels of the shipped bf16 kernels (``ops/attention_study.py``),
each on the kernel's own grid (ceil(N / 64), H, B) with its 4 warps, shared
memory and ``cp.async`` staging, on the (B, N, 3C) slab of ViT-L (N 197,
C 1024, 16 heads of D 64):

  fwd:  dma    = stage K_h, V_h; the Q strip into A fragments; write it
        layout = dma + every ldmatrix / ldmatrix.trans of K and V of both
                 sweeps (the TPU's head relayout: here heads are strided
                 views, and the fragment loads move the data between shared
                 memory and the tensor cores)
        matmul = layout + the three products (S, S again, PV); the softmax
                 gives way to P = S * D^-1/2 / N
        full   = K1
  bwd:  dma    = both passes' staging and stores, out = [q | k | v]
        matmul = the nine products, P = S * D^-1/2 / N, dS = dP / N (pass
                 1's statistics still written and read)
        full   = K2

Differences of adjacent rows attribute the kernel's time, under the
reference's keys: ``fwd_grid_dma``, ``fwd_relayout``, ``fwd_matmuls``,
``fwd_softmax``, ``bwd_grid_dma``, ``bwd_matmuls_layout``, ``bwd_softmax``.
Floors come from the H100's published peaks (989 TFLOP/s dense bf16, 3.35
TB/s). The reference's ``chain`` term (the op that chained its reps inside
one jit, measured alone and subtracted) has no counterpart: here each launch
is timed between two CUDA events and nothing is chained.

Per batch, one JSON line: ``ms``, the median of ``--reps`` CUDA-event timings
of one launch after 5 warm-ups (the host's launch time included where it is
the longer); ``device_ms``, 20 launches back to back behind a spin kernel,
median of 10 (the device alone), and the decomposition of each; the two
passes of each backward level by ``torch.profiler``; max |diff| of every
level against its plain version. The card's name and power limit last.
Exits 1 without a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys

from .timing import PEAK_BF16, PEAK_BYTES, card_line, cuda_ms

N, C, HEADS = 197, 1024, 16


def floors(b: int, n: int = N, c: int = C, heads: int = HEADS) -> dict:
    """The least times (ms) of the forward and the backward at batch ``b``:
    bytes (slab in and (B, N, C) out; slab and g in, (B, N, 3C) out) over the
    memory rate, and the products the bound counts (forward two, backward
    five, 2 N^2 D each per image and head) over the bf16 rate."""
    d = c // heads
    product = 2 * b * heads * n * n * d
    fwd_bytes, bwd_bytes = b * n * 4 * c * 2, b * n * 7 * c * 2
    out = {"fwd_bytes_ms": 1e3 * fwd_bytes / PEAK_BYTES,
           "bwd_bytes_ms": 1e3 * bwd_bytes / PEAK_BYTES,
           "fwd_products_ms": 1e3 * 2 * product / PEAK_BF16,
           "bwd_products_ms": 1e3 * 5 * product / PEAK_BF16}
    out["fwd_bound_ms"] = max(out["fwd_bytes_ms"], out["fwd_products_ms"])
    out["bwd_bound_ms"] = max(out["bwd_bytes_ms"], out["bwd_products_ms"])
    return out


def decompose(t: dict) -> dict:
    """The reference's attribution from the levels' times ``t`` (keys
    ``fwd_<level>``, ``bwd_<level>``), each term also as a share of its
    kernel's time."""
    terms = {
        "fwd_grid_dma": t["fwd_dma"],
        "fwd_relayout": t["fwd_layout"] - t["fwd_dma"],
        "fwd_matmuls": t["fwd_matmul"] - t["fwd_layout"],
        "fwd_softmax": t["fwd_full"] - t["fwd_matmul"],
        "bwd_grid_dma": t["bwd_dma"],
        "bwd_matmuls_layout": t["bwd_matmul"] - t["bwd_dma"],
        "bwd_softmax": t["bwd_full"] - t["bwd_matmul"],
    }
    shares = {f"{k}_share": v / t[f"{k[:3]}_full"] for k, v in terms.items()}
    return {"fwd_kernel": t["fwd_full"], "bwd_kernel": t["bwd_full"], **terms,
            **shares}


def backward_pass_ms(torch, fn, calls: int = 10) -> dict:
    """Device milliseconds of each pass of one backward launch (``dq``:
    pass 1, ``dkv``: pass 2), from ``torch.profiler`` over ``calls``
    launches; a pass the profiler did not see is left out."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    passes = {}
    for e in prof.key_averages():
        for key, kernel in (("dq", "attention_bwd_dq_mma_kernel"),
                            ("dkv", "attention_bwd_dkv_mma_kernel")):
            if kernel in e.key and e.self_device_time_total > 0:
                passes[key] = e.self_device_time_total / e.count / 1e3
    return passes


def measure(batches=(128, 64), reps: int = 30) -> list[dict]:
    """Every level at each batch (inputs from a seeded generator on the
    card): times, decompositions, pass times and differences to the plain
    versions, one dict per batch."""
    import torch

    from ..ops import attention_study as study

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    results = []
    for b in batches:
        qkv = torch.randn(b, N, 3 * C, generator=gen, device=dev).to(
            torch.bfloat16)
        g = torch.randn(b, N, C, generator=gen, device=dev).to(torch.bfloat16)
        runs = {f"fwd_{level}": (
            lambda level=level: study.slab_attention_peel_forward(
                qkv, HEADS, level),
            lambda level=level: study.peel_forward_reference(
                qkv, HEADS, level)) for level in study.PEEL_LEVELS}
        runs.update({f"bwd_{level}": (
            lambda level=level: study.slab_attention_peel_backward(
                qkv, g, HEADS, level),
            lambda level=level: study.peel_backward_reference(
                qkv, g, HEADS, level)) for level in study.BWD_PEEL_LEVELS})
        ms, device, diffs, passes = {}, {}, {}, {}
        for key, (kernel, plain) in runs.items():
            out = kernel()
            torch.cuda.synchronize()
            diffs[key] = (out.float() - plain().float()).abs().max().item()
            ms[key] = cuda_ms(torch, kernel, reps)
            device[key] = cuda_ms(torch, kernel, 10, calls=20)
            if key.startswith("bwd_"):
                passes[key] = backward_pass_ms(torch, kernel)
        results.append({
            "batch": b, "n": N, "c": C, "heads": HEADS, "dtype": "bfloat16",
            "ms": ms, "device_ms": device, "floors": floors(b),
            "decomposition": decompose(ms),
            "decomposition_device": decompose(device),
            "bwd_pass_device_ms": passes, "max_abs_diff": diffs})
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[128, 64])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("roofline_attn needs an NVIDIA GPU", file=sys.stderr)
        return 1
    for result in measure(args.batch, args.reps):
        print(json.dumps(result), flush=True)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
