"""The bf16 patch embedding (K5's wgmma route) against the other ways to
compute it, measured on one GPU:

    python -m touhouimageclassification_tpu_torch.tools.patch_embed_study \\
        [--reps 10]

At the patch embedding of ViT-L (224x224 images, P 16, K 768, D 1024), at
batch 64 (the train step and the serve bucket 64) and batch 1 (serve bucket
1), it holds the model's launch (``patch_embed_forward``) against the plain
version (max |diff| and relative difference in norm) and times it beside the
f32 SIMT route, ``F.conv2d`` on the NCHW view, the model's ``'xla'`` patch
embedding (the unfold copy and ``F.linear``) and that GEMM alone on
already unfolded images (``gemm_only_ms``), and prints the launch's achieved
rate against the card's published peaks. One JSON line per batch; the card's
name and power limit last.

Times are device times: a spin kernel holds the card busy while the host
enqueues 20 calls, which then run back to back between two CUDA events
(median of ``--reps`` such runs). A kernel this short takes less time on
the device than its launch takes on the host, so CUDA events around one
call would time the host; that time is printed too, as ``launch_ms``
(median of 30 single calls).
"""
from __future__ import annotations

import argparse
import json
import sys

from .timing import PEAK_BF16, PEAK_BYTES, card_line, cuda_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from ..ops import patch_embed as pe

    if not torch.cuda.is_available():
        print("patch_embed_study needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    size, patch, c, d = 224, 16, 3, 1024
    k = patch * patch * c
    for b in (64, 1):
        images32 = torch.randn(b, size, size, c, generator=gen, device=dev)
        weight32 = 0.02 * torch.randn(d, k, generator=gen, device=dev)
        bias32 = 0.02 * torch.randn(d, generator=gen, device=dev)
        images, weight, bias = (x.to(torch.bfloat16)
                                for x in (images32, weight32, bias32))
        ref = pe.patch_embed_reference(images, weight, bias, patch).float()
        m = b * (size // patch) ** 2
        flops = 2 * m * k * d
        nbytes = 2 * (images.numel() + weight.numel() + d + m * d)

        def model_launch():
            return pe.patch_embed_forward(images, weight, bias, patch)

        diff = model_launch().float() - ref
        ms = cuda_ms(torch, model_launch, args.reps, calls=20)
        nchw = images.permute(0, 3, 1, 2)
        conv_w = weight.view(d, patch, patch, c).permute(0, 3, 1, 2)
        unfolded = pe.unfold(images, patch).contiguous()
        print(json.dumps({
            "batch": b, "model_launch_ms": ms,
            "max_abs_err": diff.abs().max().item(),
            "rel_err": (diff.norm() / ref.norm()).item(),
            "launch_ms": cuda_ms(torch, model_launch, 30),
            "tflops": flops / ms / 1e9,
            "share_of_bf16_peak": flops / ms / 1e-3 / PEAK_BF16,
            "tb_per_s": nbytes / ms / 1e9,
            "bound_ms": 1e3 * max(flops / PEAK_BF16, nbytes / PEAK_BYTES),
            "simt_f32_ms": cuda_ms(torch, lambda: pe.patch_embed_forward(
                images32, weight32, bias32, patch), args.reps, calls=20),
            "conv2d_ms": cuda_ms(torch, lambda: F.conv2d(
                nchw, conv_w, bias, stride=patch), args.reps, calls=20),
            "xla_path_ms": cuda_ms(torch, lambda: F.linear(
                pe.unfold(images, patch), weight, bias), args.reps,
                calls=20),
            "gemm_only_ms": cuda_ms(torch, lambda: F.linear(
                unfolded, weight, bias), args.reps, calls=20)}),
            flush=True)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
