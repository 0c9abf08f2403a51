#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's serve path and its train step
(``touhouimageclassification_tpu_torch``) at the full width and depth of
ViT-Large/16 at 224x224, and of ResNet-152 at 256x256, with random weights
made from a seed, through the entry points a user would call: with the default configuration
(``attention_impl='fused'``, ``patch_embed_impl='xla'``) and with
``attention_impl='flash'`` + ``patch_embed_impl='pallas'``. Phases, each
fatal on failure:

1. require CUDA; print the card's name and power limit, torch and CUDA;
2. build the CUDA kernels from ``touhouimageclassification_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) and print ptxas's report;
3. hold the slab attention forward kernel (K1) against its plain PyTorch
   version on the card at the serve path's shapes, and time it, its plain
   version and ``F.scaled_dot_product_attention``; then in bf16 at every N
   of ``SWEEP_N`` and D of ``SWEEP_D`` (B 1), checking that bf16 launches
   take the tensor-core route (``mma``) and f32 the SIMT route, and that a
   shape past shared memory raises;
4. the same for the backward kernel (K2) at the train path's shapes (the
   library call is SDPA's autograd backward), and check that autograd
   through the fused attention runs K1 then K2; measure how far the
   probabilities of K2's two passes differ;
5. the same for the three-operand attention (K3, forward and backward) and
   the (B, N, H, D) attention forward (K4, on the q, k, v views of a QKV
   slab, as the model hands them); the patch embedding (K5) at ViT-L's
   shapes and in a bf16 sweep (B 1, 3, 63; 224x224 at P 16 and 8, 224x160;
   D 64 to 1024), bf16 launches on the tensor-core route (``wgmma``) and
   f32 on ``simt``, timed against ``F.conv2d`` and the model's ``'xla'``
   patch embedding; then ``packed_attention`` (K3's op) once under
   autograd;
6. run ``infer.serve.main`` on a 120-class fixture ImageFolder: ``--full``
   without and with the canvas cache (which resizes on the device), then one
   single image; check the CSVs and that every forward launched K1 once per
   encoder layer;
7. compare the whole model on the same weights and images: plain attention
   and 'flash' + 'pallas' against the default; time bucket-1 latency and
   bucket-64 throughput of each, counting K4 and K5 launches per forward
   (every K5 launch on the ``wgmma`` route); profile one bucket-64 'fused'
   forward;
8. five ``nvit`` train steps (full augmentation, CutMix/MixUp, AdamW, bf16
   over f32 params, NaN guard) through the port's ``Trainer`` on batches of
   the fixture's 256x256 canvases from ``HostImageLoader``: finite, unskipped
   steps with K1 and K2 launched once per layer each, then ``evaluate`` on
   the val split;
9. one step 'xla' (plain attention) and one 'flash' + 'pallas' against
   'fused' (K1 + K2) from the same weights and batch: the loss, and every
   parameter's gradient (an SGD step with lr 1 moves each parameter by its
   gradient);
10. train img/s of the three at batches 8 and 64, peak device memory, K4
    and K5 launches per step (K5 on ``wgmma``), and profiles of one
    batch-64 step of 'fused' and of 'flash' + 'pallas' and one batch-8
    'fused' step;
11. the training loop end to end: ``train.ntrain.main`` (the ``nvit``
    preset, one epoch through ``HostImageLoader``, from a synthetic local
    HF snapshot of the random weights) with K1 and K2 launched once per
    layer per step on the ``mma`` route, its checkpoint restored, ``--test``,
    ``--transform`` to a serving export and the serve CLI on that export,
    whose judge CSV must equal the one of a ``Predictor`` on the restored
    model; a profiled ``Trainer.fit``; then exact resume from the seeded
    scratch initialisation: a run killed by SIGTERM after batch 3 and
    resumed must end with every parameter equal to an uninterrupted run's.
    Prints the seconds and bytes of a ViT-L save, a restore and the export;
12. the ResNet family and the pipeline: ResNet-152 at 256x256 (the
    ``resnet152`` preset: SGD 5e-2, step schedule, batch 80, bf16 over f32)
    in bf16 against the same weights in f32 (BN calibrated on the batch),
    every conv on ``channels_last`` on the card, bucket-1 p50 and bucket-64
    img/s, 10 staged train steps (img/s, peak memory), a NaN step skipped
    with its BN statistics kept, profiles of a forward and a step; the
    ``resnet_train`` CLI for one epoch through ``HostImageLoader``,
    ``--transform`` and serve ``--full`` from the export; then, with phase
    11's ViT-L export as the judge, ``infer.filter --model`` (the kept tree
    equals the judge CSV's correct rows), ``analysis.acc.run_sweep`` over
    the ViT-L and ResNet-152 exports, and the web app called in process
    (POSTs of 3 and 65 images, then 8 concurrent single-image requests that
    the daemon coalesces into fewer device calls), with K1's launches
    counted on each of the three;
13. the kernel studies, the study path: the roofline peels of K1 and K2
    (S5, ``tools.roofline_attn``: dma, layout, matmul, full) and the slab
    null copy (S6, ``tools.bench_dma``: n197, n208, n256, img1, img2, img4,
    img4n208, lanes) at ViT-L's width (N 197, C 1024, 16 heads, bf16) and
    B 64 and 128, their launches counted; then every level and variant held
    to its plain version (``dma``, ``layout`` and the copies bit for bit,
    ``matmul`` and ``full`` within the bf16 bounds) and the ``full`` peels
    to K1 and K2 bit for bit.

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout of the
repository, the script exits non-zero before printing either.
"""
from __future__ import annotations

import csv
import dataclasses
import io
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
NUM_CLASSES = 120
PER_CLASS = 2
# Kernel vs plain, elementwise. bf16 attention: P and O are rounded to bf16
# (relative step 2^-8 = 3.9e-3) and the two sides sum in different orders;
# the same bound as the JAX package's bf16 attention test (the patch
# embedding rounds once, at most one bf16 step apart). f32: summation order
# only.
TOL = {"bfloat16": dict(atol=2e-2, rtol=2e-2), "float32": dict(atol=1e-4, rtol=1e-4)}
# Whole ViT-L in bf16 against the default model: the plain attention
# differs by bf16 rounding of P and O in each of 24 layers, 'flash' +
# 'pallas' at most by the patch embedding's summation order (K4 is K1's
# device code; the default's cuBLAS GEMM also adds the bias in f32 and rounds
# once); the residual stream carries those differences to the head. Random
# weights give logits of order 1, so 5e-2 is a few percent of their spread;
# argmax must agree wherever the top-2 margin exceeds it.
LOGIT_TOL = 5e-2
# ResNet-152 at 256^2 in bf16 over f32 weights against the same weights in
# f32 (BN calibrated on the batch). One block on one input: its convs, BNs
# and add each round to bf16 (2^-8 relative), so the block's output
# differs in norm by well under 2%. End to end a random-init ResNet-152
# amplifies those roundings block after block (the JAX package's bf16 model
# is as far from its f32 model: tens of percent of the largest logit), so
# the end-to-end bound only catches a broken forward; the block bound holds
# the arithmetic.
RESNET_BLOCK_TOL = 2e-2
RESNET_LOGIT_TOL = 0.6
# One ViT-L train step, 'xla' (autograd of the plain attention, which rounds
# dP to bf16 where K2 keeps it in f32) or 'flash' + 'pallas' (the plain
# backward recomputed from bf16 scores) vs 'fused' (K1 + K2): the largest
# relative difference of any parameter's gradient. On an H100 'xla' reads
# 1.93e-2 (in the embeddings, where 24 layers' differences add up); K2 with
# its output scaled by 0.95, its last 8 token rows zeroed or one head
# zeroed reads 9.3e-2 to 0.35. Faults of 1% or less (2.5e-2 to 2.6e-2) lie
# inside the bf16 spread; REL_TOL in the kernel phase finds them.
GRAD_TOL = 3e-2
# Kernel vs plain, relative difference in norm: the two sides round the same
# f32 values to the output dtype and differ only where summation order moves
# a value across a rounding boundary, so this resolves a fault (a scaled or
# partly wrong output) far below the elementwise TOL. On an H100 the kernels
# read at most 4.7e-5 in bf16 and 5.5e-7 in f32; K2 with its output scaled
# by 0.995 reads 5.7e-3 and 5.0e-3.
REL_TOL = {"bfloat16": 1e-3, "float32": 1e-5}
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): tensor-core
# bf16 and plain f32 FLOP/s, and device-memory bytes/s. A kernel's bound is
# the larger of its operations over the peak rate for its type and its bytes
# (each input read once, each output written once) over the memory rate.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# The attention kernels' shape sweep in bf16 (B 1, two heads): N from one
# token to ViT at 384^2 (577), through a 16-row chunk, ragged edges and
# ViT-L's 197; every head dim the kernels take. At N 577, D 128 the operands
# exceed shared memory and the launch must raise.
SWEEP_N = (1, 16, 67, 197, 257, 577)
SWEEP_D = (32, 64, 128)
ROUTES = {"bfloat16": "mma", "float32": "simt"}
# The patch embedding's bf16 sweep: batches around the serve buckets and a
# ragged last 128-row tile (M 196, 588, 12,348), ViT's 224x224 at P 16 and 8
# and a non-square image (H, W, P), and output widths from one tile to
# ViT-L's, with a ragged edge (1000). Its routes by dtype.
PE_SWEEP_B = (1, 3, 63)
PE_SWEEP_SHAPES = ((224, 224, 16), (224, 224, 8), (224, 160, 16))
PE_SWEEP_D = (64, 768, 1000, 1024)
PE_ROUTES = {"bfloat16": "wgmma", "float32": "simt"}
# The kernel studies' batches (phase 13): the reference studies' B 128 and
# the B 64 of the K1 / K2 rows; the kernels line reports B 64.
STUDY_BATCHES = (64, 128)
# The model variants: the default configuration, the plain attention, and
# the slice of the three-operand kernels ('flash' = K4, 'pallas' = K5).
VARIANTS = {
    "fused": dict(attention_impl="fused"),
    "xla": dict(attention_impl="xla"),
    "flash+pallas": dict(attention_impl="flash", patch_embed_impl="pallas"),
}


def hf_vit_state_dict(hidden: int, layers: int, mlp: int, num_classes: int,
                      image_size: int = 224, patch: int = 16, seed: int = SEED):
    """Random HF ``ViTForImageClassification`` state dict, from numpy only:
    weights N(0, 0.02), biases N(0, 0.02), LayerNorm scales 1 + N(0, 0.02)."""
    import torch

    rng = np.random.default_rng(seed)

    def normal(*shape, mean=0.0):
        return torch.from_numpy(
            mean + 0.02 * rng.standard_normal(shape, dtype=np.float32))

    n = (image_size // patch) ** 2 + 1
    sd = {
        "vit.embeddings.cls_token": normal(1, 1, hidden),
        "vit.embeddings.position_embeddings": normal(1, n, hidden),
        "vit.embeddings.patch_embeddings.projection.weight":
            normal(hidden, 3, patch, patch),
        "vit.embeddings.patch_embeddings.projection.bias": normal(hidden),
        "vit.layernorm.weight": normal(hidden, mean=1.0),
        "vit.layernorm.bias": normal(hidden),
        "classifier.weight": normal(num_classes, hidden),
        "classifier.bias": normal(num_classes),
    }
    for i in range(layers):
        p = f"vit.encoder.layer.{i}."
        for name in ("query", "key", "value"):
            sd[p + f"attention.attention.{name}.weight"] = normal(hidden, hidden)
            sd[p + f"attention.attention.{name}.bias"] = normal(hidden)
        sd[p + "attention.output.dense.weight"] = normal(hidden, hidden)
        sd[p + "attention.output.dense.bias"] = normal(hidden)
        sd[p + "intermediate.dense.weight"] = normal(mlp, hidden)
        sd[p + "intermediate.dense.bias"] = normal(mlp)
        sd[p + "output.dense.weight"] = normal(hidden, mlp)
        sd[p + "output.dense.bias"] = normal(hidden)
        for ln in ("layernorm_before", "layernorm_after"):
            sd[p + f"{ln}.weight"] = normal(hidden, mean=1.0)
            sd[p + f"{ln}.bias"] = normal(hidden)
    return sd


def make_image_folder(root: str, num_classes: int, per_class: int,
                      size: int = 64, seed: int = SEED) -> str:
    """``num_classes`` class dirs of ``per_class`` small random JPEGs."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for c in range(num_classes):
        cdir = os.path.join(root, f"class_{c:03d}")
        os.makedirs(cdir)
        for i in range(per_class):
            img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
            Image.fromarray(img).save(os.path.join(cdir, f"{i}.jpg"), quality=90)
    return root


def cuda_ms(fn, warmup: int = 5, reps: int = 30) -> float:
    """Median milliseconds of ``fn()`` on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Median device milliseconds per ``fn()``: a spin kernel first holds
    the card busy for ~5 ms, long enough for the host to enqueue ``calls``
    calls, which then run back to back between two CUDA events. For a
    kernel shorter than its launch's host time, :func:`cuda_ms` (events
    around one call) times the host instead."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def dtype_key(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """The least time (ms) the card could take for ``flops`` operations of
    ``dtype`` moving ``nbytes``, and which of the two bounds it."""
    t_ops = flops / PEAK_FLOPS[dtype_key(dtype)]
    t_mem = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes"


def attention_bound(b, n, c, h, dtype, backward: bool):
    """K1-K4's work: per image and head S = QK^T and O = PV forward (two
    2 N^2 D products); the backward recomputes S and forms dP, dQ, dK and
    dV (five). Bytes: q, k, v (and g) read, the output (or three gradients)
    written."""
    d = c // h
    products = 5 if backward else 2
    elems = (3 + 1 + 3) * b * n * c if backward else (3 + 1) * b * n * c
    return bound(products * 2 * b * h * n * n * d,
                 elems * (2 if dtype_key(dtype) == "bfloat16" else 4), dtype)


def check_close(torch, what: str, out, ref, dtype, verbose: bool = True):
    """Kernel output against its plain version: elementwise within TOL and,
    in norm, within REL_TOL; returns the largest |difference| (and, quiet,
    the relative difference in norm)."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs().max().item()
    rel = ((out - ref).norm() / ref.norm()).item()
    key = dtype_key(dtype)
    if verbose:
        print(f"{what}, {key}: max |diff| {err:.3e} (atol {TOL[key]['atol']}, "
              f"rtol {TOL[key]['rtol']}), relative norm {rel:.3e} (bound "
              f"{REL_TOL[key]})")
    torch.testing.assert_close(out, ref, **TOL[key])
    if rel > REL_TOL[key]:
        raise AssertionError(f"{what} {key}: relative norm {rel:.3e}")
    return err if verbose else (err, rel)


def on_route(ops, dtype, launches: int, run, routes=ROUTES):
    """``run()``, which makes ``launches`` kernel launches of the module
    ``ops``: every one must take the dtype's route (``routes``: attention
    bf16 ``mma``, f32 ``simt``). Returns its result."""
    want = routes[dtype_key(dtype)]
    before = dict(ops.route_launches)
    out = run()
    made = {r: ops.route_launches[r] - before[r] for r in before}
    if made != {r: launches if r == want else 0 for r in made}:
        raise AssertionError(f"{dtype_key(dtype)} launches by route {made}, "
                             f"expected {launches} on {want}")
    return out


def sweep(torch, attn, what: str, backward: bool, make) -> None:
    """One kernel in bf16 over SWEEP_N x SWEEP_D (B 1, two heads): its
    shared memory as the wrapper computes it equals the C function's; a
    shape that fits runs on the mma route within TOL and REL_TOL of its
    plain version, a shape that does not raises before launching.
    ``make(n, c, h)`` returns (kernel call, plain call)."""
    torch.cuda.synchronize()
    lib = attn.load_library()
    limit = lib.tic_max_smem_optin(0)
    c_bytes = (lib.tic_slab_attention_bwd_smem_bytes if backward
               else lib.tic_slab_attention_fwd_smem_bytes)
    worst, raised = (0.0, 0.0), []
    for d in SWEEP_D:
        for n in SWEEP_N:
            need = attn.kernel_smem_bytes("mma", backward, n, d)
            if need != c_bytes(n, d, 1):
                raise AssertionError(f"{what} N {n} D {d}: shared memory "
                                     f"{need} (wrapper) vs {c_bytes(n, d, 1)}")
            kernel, plain = make(n, 2 * d, 2)
            if need > limit:
                before = dict(attn.route_launches)
                try:
                    kernel()
                except ValueError:
                    if attn.route_launches != before:
                        raise AssertionError(f"{what} N {n} D {d}: counted")
                    raised.append((n, d))
                    continue
                raise AssertionError(f"{what} N {n} D {d}: {need} bytes of "
                                     f"shared memory past {limit} launched")
            out = on_route(attn, torch.bfloat16, 1, kernel)
            torch.cuda.synchronize()
            if isinstance(out, tuple):
                out, ref = torch.cat(out, -1), torch.cat(plain(), -1)
            else:
                ref = plain()
            got = check_close(torch, f"{what} N {n} D {d}", out, ref,
                              torch.bfloat16, verbose=False)
            worst = tuple(max(a, b) for a, b in zip(worst, got))
    print(f"{what}, bf16 sweep N {SWEEP_N} x D {SWEEP_D} (B 1, H 2): every "
          f"launch on the mma route; worst max |diff| {worst[0]:.3e}, "
          f"relative norm {worst[1]:.3e} (bounds {TOL['bfloat16']}, "
          f"{REL_TOL['bfloat16']}); raised as past shared memory ({limit} "
          f"bytes): {raised}")


def sdpa(torch, q, k, v):
    """The library call that computes the attention of (B, N, H, D) q, k, v:
    ``F.scaled_dot_product_attention`` on their (B, H, N, D) views (timed
    here as a yardstick; the port never calls it)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))


def sdpa_backward_ms(torch, leaves, views, g) -> float:
    """Milliseconds of SDPA's autograd backward alone: the forward is taken
    once, the gradient of ``leaves`` timed with the graph retained."""
    with torch.enable_grad():
        out = sdpa(torch, *views)
    g = g.reshape(out.transpose(1, 2).shape).transpose(1, 2)
    return cuda_ms(lambda: torch.autograd.grad(out, leaves, g,
                                               retain_graph=True))


def phase_kernels(torch, attn):
    """Kernel vs plain at the serve path's shapes; times at the ViT-L bucket."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = [  # (name, B, N, C, H, dtype)
        ("vit-l bucket 64", 64, 197, 1024, 16, torch.bfloat16),
        ("vit-l bucket 64", 64, 197, 1024, 16, torch.float32),
        ("vit-l bucket 1", 1, 197, 1024, 16, torch.bfloat16),
        ("vit-b bucket 8", 8, 197, 768, 12, torch.bfloat16),
        ("odd: N 67, H 5, D 32", 2, 67, 160, 5, torch.float32),
    ]
    errs = {}
    with torch.inference_mode():
        for name, b, n, c, h, dtype in cases:
            qkv = torch.randn(b, n, 3 * c, generator=gen, device=dev).to(dtype)
            before = attn.launches
            out = on_route(attn, dtype, 1, lambda: attn.slab_attention(qkv, h))
            torch.cuda.synchronize()
            if attn.launches != before + 1:
                raise AssertionError(f"{name}: launches went {before} -> "
                                     f"{attn.launches}, expected one")
            errs[(name, dtype)] = check_close(
                torch, f"K1 vs plain, {name}", out,
                attn.slab_attention_reference(qkv, h), dtype)

        def slab(n, c, h):
            qkv = torch.randn(1, n, 3 * c, generator=gen, device=dev).to(
                torch.bfloat16)
            return (lambda: attn.slab_attention(qkv, h),
                    lambda: attn.slab_attention_reference(qkv, h))

        sweep(torch, attn, "K1", False, slab)
        qkv = torch.randn(64, 197, 3 * 1024, generator=gen,
                          device=dev).to(torch.bfloat16)
        ms = cuda_ms(lambda: attn.slab_attention(qkv, 16))
        plain_ms = cuda_ms(lambda: attn.slab_attention_reference(qkv, 16))
        views = qkv.view(64, 197, 3, 16, 64).unbind(2)
        library_ms = cuda_ms(lambda: sdpa(torch, *views))
    bound_ms, bound_by = attention_bound(64, 197, 1024, 16, torch.bfloat16,
                                         backward=False)
    print(f"slab attention, ViT-L bucket 64 bf16 (B 64, N 197, C 1024, H 16): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
          f"{library_ms:.4f} ms (median of 30); bound {bound_ms:.4f} ms "
          f"({bound_by})")
    return dict(max_abs_err=errs[("vit-l bucket 64", torch.bfloat16)], ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def phase_backward(torch, attn):
    """K2 vs plain at the train path's shapes; times at ViT-L batch 64."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    cases = [  # (name, B, N, C, H, dtype)
        ("vit-l batch 64", 64, 197, 1024, 16, torch.bfloat16),
        ("vit-l batch 64", 64, 197, 1024, 16, torch.float32),
        ("vit-b batch 8", 8, 197, 768, 12, torch.bfloat16),
        ("odd: N 67, H 5, D 32", 2, 67, 160, 5, torch.float32),
    ]
    errs = {}
    for name, b, n, c, h, dtype in cases:
        qkv = torch.randn(b, n, 3 * c, generator=gen, device=dev).to(dtype)
        g = torch.randn(b, n, c, generator=gen, device=dev).to(dtype)
        before = attn.bwd_launches
        out = on_route(attn, dtype, 1,
                       lambda: attn.slab_attention_backward(qkv, g, h))
        torch.cuda.synchronize()
        if attn.bwd_launches != before + 1:
            raise AssertionError(f"{name}: bwd_launches went {before} -> "
                                 f"{attn.bwd_launches}, expected one")
        errs[(name, dtype)] = check_close(
            torch, f"K2 vs plain backward, {name}", out,
            attn.slab_attention_backward_reference(qkv, g, h), dtype)

    # autograd through the 'fused' attention: one K1 and one K2 launch, and
    # the gradient is K2's, bit for bit (K2 has no atomics)
    qkv = torch.randn(8, 197, 3 * 768, generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_()
    g = torch.randn(8, 197, 768, generator=gen, device=dev).to(torch.bfloat16)
    before = (attn.launches, attn.bwd_launches)
    attn.slab_attention(qkv, 12).backward(g)
    if (attn.launches, attn.bwd_launches) != (before[0] + 1, before[1] + 1):
        raise AssertionError(f"autograd: launches {before} -> "
                             f"{(attn.launches, attn.bwd_launches)}")
    direct = attn.slab_attention_backward(qkv.detach(), g, 12)
    if not torch.equal(qkv.grad, direct):
        raise AssertionError("autograd gradient differs from K2's")
    print("autograd through slab_attention: one K1 + one K2 launch, gradient "
          "identical to K2's")

    def slab(n, c, h):
        qkv = torch.randn(1, n, 3 * c, generator=gen, device=dev).to(
            torch.bfloat16)
        g = torch.randn(1, n, c, generator=gen, device=dev).to(torch.bfloat16)
        return (lambda: attn.slab_attention_backward(qkv, g, h),
                lambda: attn.slab_attention_backward_reference(qkv, g, h))

    sweep(torch, attn, "K2", True, slab)

    # The two passes form S as Q K^T (pass 1) and K Q^T (pass 2) on the
    # tensor cores: how far apart are the probabilities they form?
    for b, n, c, h in [(8, 197, 1024, 16), (2, 67, 64, 2), (2, 257, 256, 2)]:
        q, k, v, g = (torch.randn(b, n, c, generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(4))
        p1, p2 = attn.backward_probabilities(q, k, v, g, h)
        if not (torch.isfinite(p1).all() and torch.isfinite(p2).all()):
            raise AssertionError("a pass left a probability unwritten")
        diff = (p1 - p2).abs()
        print(f"K2 pass 1 vs pass 2 probabilities, B {b} N {n} H {h} D "
              f"{c // h}: {int((p1 != p2).sum())} of {p1.numel()} differ, max "
              f"|diff| {diff.max().item():.3e}")

    qkv = torch.randn(64, 197, 3 * 1024, generator=gen,
                      device=dev).to(torch.bfloat16)
    g = torch.randn(64, 197, 1024, generator=gen, device=dev).to(torch.bfloat16)
    ms = cuda_ms(lambda: attn.slab_attention_backward(qkv, g, 16))
    plain_ms = cuda_ms(
        lambda: attn.slab_attention_backward_reference(qkv, g, 16))
    leaf = qkv.detach().requires_grad_()
    library_ms = sdpa_backward_ms(torch, (leaf,),
                                  leaf.view(64, 197, 3, 16, 64).unbind(2), g)
    bound_ms, bound_by = attention_bound(64, 197, 1024, 16, torch.bfloat16,
                                         backward=True)
    print(f"slab attention backward, ViT-L batch 64 bf16 (B 64, N 197, C 1024, "
          f"H 16): K2 {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA's autograd "
          f"backward {library_ms:.4f} ms (median of 30); bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    return dict(max_abs_err=errs[("vit-l batch 64", torch.bfloat16)], ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def phase_three_operand_kernels(torch, attn):
    """K3 (forward and backward) and K4 against their plain versions at
    the shapes their callers give them, in bf16 at ViT-L batch 64 and in f32
    at a small odd shape; times at batch 64 in bf16 beside their plain
    versions, the one PyTorch call that computes the same function, and
    their bounds. Returns {kernel: summary}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def launched(counter, expect):
        torch.cuda.synchronize()
        got = tuple(getattr(m, a) for m, a in counter)
        if got != expect:
            raise AssertionError(f"launch counts {got}, expected {expect}")

    out = {}
    packed = [(attn, "packed_launches"), (attn, "packed_bwd_launches")]
    for name, b, n, c, h, dtype in [("vit-l batch 64", 64, 197, 1024, 16, bf16),
                                    ("odd: N 67, H 5, D 32", 2, 67, 160, 5, f32)]:
        q, k, v, g = (randn(b, n, c, dtype=dtype) for _ in range(4))
        before = tuple(getattr(m, a) for m, a in packed)
        fwd = on_route(attn, dtype, 1,
                       lambda: attn.packed_attention_forward(q, k, v, h))
        grads = on_route(attn, dtype, 1,
                         lambda: attn.packed_attention_backward(q, k, v, g, h))
        launched(packed, (before[0] + 1, before[1] + 1))
        err = check_close(torch, f"K3 forward vs plain, {name}", fwd,
                          attn.packed_attention_reference(q, k, v, h), dtype)
        bwd_err = check_close(
            torch, f"K3 backward vs plain, {name}", torch.cat(grads, -1),
            torch.cat(attn.packed_attention_backward_reference(q, k, v, g, h),
                      -1), dtype)
        if dtype == bf16:
            heads = [x.view(b, n, h, c // h) for x in (q, k, v)]
            leaves = tuple(x.detach().requires_grad_() for x in (q, k, v))
            out["K3 fwd"] = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: attn.packed_attention_forward(q, k, v, h)),
                plain_ms=cuda_ms(
                    lambda: attn.packed_attention_reference(q, k, v, h)),
                library_ms=cuda_ms(lambda: sdpa(torch, *heads)))
            out["K3 bwd"] = dict(
                max_abs_err=bwd_err,
                ms=cuda_ms(
                    lambda: attn.packed_attention_backward(q, k, v, g, h)),
                plain_ms=cuda_ms(lambda: attn.packed_attention_backward_reference(
                    q, k, v, g, h)),
                library_ms=sdpa_backward_ms(
                    torch, leaves,
                    [x.view(b, n, h, c // h) for x in leaves], g))
            for key, backward in (("K3 fwd", False), ("K3 bwd", True)):
                out[key]["bound_ms"], out[key]["bound_by"] = attention_bound(
                    b, n, c, h, dtype, backward)

    # K4 on what the model hands it: the q, k, v views of the (B, N, 3C) QKV
    # projection (row stride 3C), at the train batch and the serve bucket 1;
    # and dense (B, N, H, D) tensors
    flash = [(attn, "flash_launches")]
    for name, b, n, c, h, dtype, slab in [
            ("vit-l batch 64, views of the QKV slab", 64, 197, 1024, 16, bf16, True),
            ("vit-l bucket 1, views of the QKV slab", 1, 197, 1024, 16, bf16, True),
            ("odd: dense (B, N, H, D), N 67, H 5, D 32", 2, 67, 160, 5, f32, False)]:
        if slab:
            q, k, v = randn(b, n, 3 * c, dtype=dtype).view(
                b, n, 3, h, c // h).unbind(2)
        else:
            q, k, v = (randn(b, n, h, c // h, dtype=dtype) for _ in range(3))
        before = attn.flash_launches
        fwd = on_route(attn, dtype, 1,
                       lambda: attn.flash_attention_forward(q, k, v))
        launched(flash, (before + 1,))
        err = check_close(torch, f"K4 vs plain, {name}", fwd,
                          attn.flash_attention_reference(q, k, v), dtype)
        if b == 64:
            bound_ms, bound_by = attention_bound(b, n, c, h, dtype, False)
            out["K4"] = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: attn.flash_attention_forward(q, k, v)),
                plain_ms=cuda_ms(
                    lambda: attn.flash_attention_reference(q, k, v)),
                library_ms=cuda_ms(lambda: sdpa(torch, q, k, v)),
                bound_ms=bound_ms, bound_by=bound_by)

    def three(n, c, h):
        q, k, v = (randn(1, n, c, dtype=bf16) for _ in range(3))
        return (lambda: attn.packed_attention_forward(q, k, v, h),
                lambda: attn.packed_attention_reference(q, k, v, h))

    def three_bwd(n, c, h):
        q, k, v, g = (randn(1, n, c, dtype=bf16) for _ in range(4))
        return (lambda: attn.packed_attention_backward(q, k, v, g, h),
                lambda: attn.packed_attention_backward_reference(q, k, v, g, h))

    def slab_views(n, c, h):
        q, k, v = randn(1, n, 3 * c, dtype=bf16).view(
            1, n, 3, h, c // h).unbind(2)
        return (lambda: attn.flash_attention_forward(q, k, v),
                lambda: attn.flash_attention_reference(q, k, v))

    sweep(torch, attn, "K3 fwd", False, three)
    sweep(torch, attn, "K3 bwd", True, three_bwd)
    sweep(torch, attn, "K4 on views of the QKV slab", False, slab_views)

    for key, r in out.items():
        print(f"{key}, ViT-L batch 64 bf16: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library call {r['library_ms']:.4f} ms "
              f"(median of 30); bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return out


def phase_patch_embed(torch, pe):
    """K5 against its plain version on the model's operands (NHWC images in
    the compute dtype, the (D, P*P*C) nn.Linear weight and the bias, cast to
    it) at ViT-L batch 64 in bf16 and batch 2 in f32, then over the bf16
    sweep, each launch on its dtype's route; times at batch 64 in bf16
    beside the plain version, ``F.conv2d`` (the one PyTorch call for the
    same function) and the model's ``'xla'`` patch embedding (the unfold
    copy and ``F.linear``), and the bound. ``ms``, ``plain_ms``,
    ``library_ms`` and ``xla_path_ms`` are timed as every other kernel's,
    around one call (:func:`cuda_ms`). The kernel takes less time on the
    device than its launch on the host, so ``device_ms``,
    ``library_device_ms`` and ``xla_path_device_ms`` add the device times
    of the kernel, ``F.conv2d`` and the ``'xla'`` path
    (:func:`device_ms`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    F = torch.nn.functional
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)

    def operands(b, h, w, patch, d, dtype):
        images = torch.randn(b, h, w, 3, generator=gen, device=dev).to(dtype)
        weight = (0.02 * torch.randn(d, patch * patch * 3, generator=gen,
                                     device=dev)).to(dtype)
        bias = (0.02 * torch.randn(d, generator=gen, device=dev)).to(dtype)
        return images, weight, bias

    def launch(images, weight, bias, patch):
        before = pe.launches
        out = on_route(pe, images.dtype, 1, lambda: pe.patch_embed_forward(
            images, weight, bias, patch), PE_ROUTES)
        torch.cuda.synchronize()
        if pe.launches != before + 1:
            raise AssertionError(f"K5 launches went {before} -> {pe.launches}")
        return out

    patch, d = 16, 1024
    f32_ops = operands(2, 224, 224, patch, d, torch.float32)
    check_close(torch, "K5 vs plain, vit-l batch 2", launch(*f32_ops, patch),
                pe.patch_embed_reference(*f32_ops, patch), torch.float32)
    images, weight, bias = operands(64, 224, 224, patch, d, torch.bfloat16)
    stats = dict(max_abs_err=check_close(
        torch, "K5 vs plain, vit-l batch 64", launch(images, weight, bias, patch),
        pe.patch_embed_reference(images, weight, bias, patch), torch.bfloat16))
    worst = (0.0, 0.0)
    for b in PE_SWEEP_B:
        for h, w, p in PE_SWEEP_SHAPES:
            for dd in PE_SWEEP_D:
                ops = operands(b, h, w, p, dd, torch.bfloat16)
                got = check_close(torch, f"K5 B {b} {h}x{w} P {p} D {dd}",
                                  launch(*ops, p),
                                  pe.patch_embed_reference(*ops, p),
                                  torch.bfloat16, verbose=False)
                worst = tuple(max(x, y) for x, y in zip(worst, got))
    print(f"K5, bf16 sweep B {PE_SWEEP_B} x (H, W, P) {PE_SWEEP_SHAPES} x D "
          f"{PE_SWEEP_D}: every launch on the wgmma route; worst max |diff| "
          f"{worst[0]:.3e}, relative norm {worst[1]:.3e} (bounds "
          f"{TOL['bfloat16']}, {REL_TOL['bfloat16']})")

    m, k = 64 * (224 // patch) ** 2, patch * patch * 3
    nchw = images.permute(0, 3, 1, 2)
    conv_w = weight.view(d, patch, patch, 3).permute(0, 3, 1, 2)
    stats["bound_ms"], stats["bound_by"] = bound(
        2 * m * k * d, 2 * (images.numel() + weight.numel() + d + m * d),
        torch.bfloat16)
    def kernel():
        return pe.patch_embed_forward(images, weight, bias, patch)

    def xla_path():
        return F.linear(pe.unfold(images, patch), weight, bias)

    differ = int((kernel() != xla_path()).sum())
    print(f"K5 vs the model's 'xla' patch embedding (unfold + F.linear), ViT-L "
          f"batch 64 bf16: {differ} of {m * d} elements differ")

    def conv():
        return F.conv2d(nchw, conv_w, bias, stride=patch)

    stats.update(
        ms=cuda_ms(kernel),
        plain_ms=cuda_ms(lambda: pe.patch_embed_reference(images, weight,
                                                          bias, patch)),
        library_ms=cuda_ms(conv), xla_path_ms=cuda_ms(xla_path),
        device_ms=device_ms(kernel), library_device_ms=device_ms(conv),
        xla_path_device_ms=device_ms(xla_path))
    print(f"K5, ViT-L batch 64 bf16, one call between events (median of 30): "
          f"kernel {stats['ms']:.4f} ms, plain {stats['plain_ms']:.4f}, "
          f"F.conv2d {stats['library_ms']:.4f}, 'xla' path (unfold + "
          f"F.linear) {stats['xla_path_ms']:.4f}; device time (20 "
          f"back-to-back calls, median of 10): kernel "
          f"{stats['device_ms']:.4f} ms "
          f"({2 * m * k * d / stats['device_ms'] / 1e9:.1f} TFLOP/s), "
          f"F.conv2d {stats['library_device_ms']:.4f}, 'xla' path "
          f"{stats['xla_path_device_ms']:.4f}; bound {stats['bound_ms']:.4f} "
          f"ms ({stats['bound_by']}), share of the device time "
          f"{stats['bound_ms'] / stats['device_ms']:.3f}")
    return stats


def phase_packed_op(torch, attn) -> tuple[int, int]:
    """``packed_attention``, K3's op (in the JAX package reached from tests
    and kernel studies only), once forward and backward under autograd at
    ViT-L batch 64 in bf16, counts set to 0 just before; the gradients are
    K3's backward bit for bit (it has no atomics). Returns the launches."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    q, k, v, g = (torch.randn(64, 197, 1024, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    attn.packed_launches = attn.packed_bwd_launches = 0
    attn.packed_attention(*leaves, 16).backward(g)
    torch.cuda.synchronize()
    launches = (attn.packed_launches, attn.packed_bwd_launches)
    if launches != (1, 1):
        raise AssertionError(f"packed_attention: K3 launches {launches}")
    direct = attn.packed_attention_backward(q, k, v, g, 16)
    if not all(torch.equal(x.grad, y) for x, y in zip(leaves, direct)):
        raise AssertionError("packed_attention's gradients differ from K3's")
    print("packed_attention under autograd, ViT-L batch 64 bf16: one K3 "
          "forward + one K3 backward launch, gradients identical to K3's")
    return launches


def phase_serve(torch, attn, serve, work: str, pth: str, data: str,
                layers: int) -> int:
    """The serve CLI, three ways; returns the kernel launches it made."""
    n_images = NUM_CLASSES * PER_CLASS
    forwards = -(-n_images // serve.BUCKETS[-1])
    attn.launches = 0
    attn.route_launches.update(mma=0, simt=0)
    for cache in ("off", "on"):
        out_csv = os.path.join(work, f"judge_cache_{cache}.csv")
        before = attn.launches
        t0 = time.perf_counter()
        serve.main(["--model", "vit-large", "--image", data, "--weights", pth,
                    "--data-dir", data, "--output", out_csv, "--full",
                    "--canvas-cache", cache])
        secs = time.perf_counter() - t0
        with open(out_csv, newline="") as f:
            rows = list(csv.reader(f))
        if rows[0] != ["filename", "predicted_class", "confidence",
                       "actual_class", "correct", "path"]:
            raise AssertionError(f"CSV header {rows[0]}")
        if len(rows) - 1 != n_images:
            raise AssertionError(f"{len(rows) - 1} CSV rows, expected {n_images}")
        conf = np.asarray([float(r[2]) for r in rows[1:]])
        if not (np.isfinite(conf).all() and (conf > 0).all() and (conf <= 1).all()):
            raise AssertionError("confidences outside (0, 1]")
        made = attn.launches - before
        if made != forwards * layers:
            raise AssertionError(f"--full --canvas-cache {cache}: {made} kernel "
                                 f"launches, expected {layers} per forward x "
                                 f"{forwards} forwards")
        print(f"serve --full --canvas-cache {cache}: {len(rows) - 1} CSV rows, "
              f"{made} kernel launches ({layers} per forward x {forwards}), "
              f"{secs:.2f} s including weight load")
    if not os.path.isdir(os.path.join(data, ".tic_canvas_cache")):
        raise AssertionError("--canvas-cache on built no canvas cache")
    before = attn.launches
    serve.main(["--model", "vit-large", "--image",
                os.path.join(data, "class_000", "0.jpg"), "--weights", pth,
                "--data-dir", data])
    if attn.launches - before != layers:
        raise AssertionError(f"single image: {attn.launches - before} kernel "
                             f"launches, expected {layers}")
    print(f"serve single image: {layers} kernel launches")
    if attn.route_launches != {"mma": attn.launches, "simt": 0}:
        raise AssertionError(f"serve: K1 launches by route "
                             f"{attn.route_launches}, expected all "
                             f"{attn.launches} on mma")
    return attn.launches


def phase_model(torch, attn, pe, serve, create_model, load_vit_weights,
                pth: str, data_mean, data_std, dev, layers: int):
    """Whole ViT-L bf16: plain attention and 'flash' + 'pallas' against the
    default model on the same weights and images; latency and throughput of
    each through ``Predictor.predict_array``. Returns the K4 and K5
    launches of the 'flash' + 'pallas' serve run (24 and 1 per forward)."""
    models = {}
    for variant, over in VARIANTS.items():
        m = create_model("vit-large", num_classes=NUM_CLASSES, device=dev,
                         **over)
        m.load_state_dict(load_vit_weights(pth, m.cfg))
        models[variant] = m.eval()
    rng = np.random.default_rng(SEED + 1)
    imgs = rng.integers(0, 256, (64, 224, 224, 3), dtype=np.uint8)
    x = torch.from_numpy(imgs[:8]).to(dev).float() / 255.0
    x = (x - torch.tensor(data_mean, device=dev).float()) / torch.tensor(
        data_std, device=dev).float()
    with torch.inference_mode():
        logits = {variant: m(x) for variant, m in models.items()}
    ref = logits["fused"]
    if not (ref.shape == (8, NUM_CLASSES) and torch.isfinite(ref).all()):
        raise AssertionError(f"logits {tuple(ref.shape)} or not finite")
    top2 = ref.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > LOGIT_TOL
    for variant in ("xla", "flash+pallas"):
        got = logits[variant]
        diff = (got - ref).abs().max().item()
        same = (got.argmax(-1) == ref.argmax(-1)) | ~sure
        print(f"ViT-L bf16 B 8, {variant} vs fused: max |d logit| {diff:.3e} "
              f"(bound {LOGIT_TOL}), logit spread {ref.std().item():.3f}, "
              f"argmax equal on {int(sure.sum())} of 8 with margin > "
              f"{LOGIT_TOL}")
        if diff > LOGIT_TOL or not bool(same.all()):
            raise AssertionError(f"whole-model {variant} vs fused disagreement")

    launches = None
    for variant, m in models.items():
        pred = serve.Predictor(model=m, class_to_idx={f"c{i}": i for i in
                                                      range(NUM_CLASSES)},
                               image_size=(224, 224), mean=data_mean,
                               std=data_std, device=dev)
        k1 = attn.launches
        attn.flash_launches = pe.launches = 0
        routes = dict(attn.route_launches)
        pe_routes = dict(pe.route_launches)
        for _ in range(5):
            pred.predict_array(imgs[:1])
        lat = []
        for i in range(60):
            t0 = time.perf_counter()
            pred.predict_array(imgs[i % 64:i % 64 + 1])
            lat.append((time.perf_counter() - t0) * 1e3)
        for _ in range(2):
            pred.predict_array(imgs)
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            pred.predict_array(imgs)
        rate = reps * 64 / (time.perf_counter() - t0)
        forwards = 5 + 60 + 2 + reps
        made = (attn.launches - k1, attn.flash_launches, pe.launches)
        flash = variant == "flash+pallas"
        expect = ((0, layers * forwards, forwards) if flash else
                  (layers * forwards if variant == "fused" else 0, 0, 0))
        print(f"serve, {variant}: bucket-1 p50 {statistics.median(lat):.3f} ms "
              f"(60 requests), bucket-64 {rate:.2f} img/s ({reps} batches); "
              f"K1/K4/K5 launches {made} over {forwards} forwards")
        if made != expect:
            raise AssertionError(f"serve {variant}: K1/K4/K5 launches {made}, "
                                 f"expected {expect}")
        by_route = {r: attn.route_launches[r] - routes[r] for r in routes}
        if by_route != {"mma": made[0] + made[1], "simt": 0}:
            raise AssertionError(f"serve {variant}: attention launches by "
                                 f"route {by_route}, expected all on mma")
        pe_by_route = {r: pe.route_launches[r] - pe_routes[r]
                       for r in pe_routes}
        if pe_by_route != {"wgmma": made[2], "simt": 0}:
            raise AssertionError(f"serve {variant}: K5 launches by route "
                                 f"{pe_by_route}, expected all on wgmma")
        if flash:
            launches = made[1:]
        if variant == "fused":
            profile(torch, lambda: pred.predict_array(imgs),
                    "fused serve bucket-64 forward")
    return launches


def nvit_config(data: str, **over):
    """The ``nvit`` preset (ViT-L finetune: full augmentation + CutMix/MixUp,
    AdamW lr 1e-5 wd 0.01, bf16 compute over f32 params, batch 8, NaN
    guard) on the fixture dataset, seeded."""
    from touhouimageclassification_tpu_torch.config import PRESETS

    return dataclasses.replace(PRESETS["nvit"], data_dir=data, seed=SEED,
                               **over)


def train_model(create_model, state_dict, variant: str, dev):
    """ViT-L with f32 master parameters and bf16 compute."""
    model = create_model("vit-large", num_classes=NUM_CLASSES,
                         compute_dtype="bfloat16", param_dtype="float32",
                         device=dev, **VARIANTS[variant])
    model.load_state_dict(state_dict)
    return model


def phase_train(attn, create_model, Trainer, state_dict, data: str,
                layers: int, dev, steps: int = 5):
    """The nvit train step through the port's Trainer on loader batches;
    returns the K1 and K2 launches of those steps."""
    from touhouimageclassification_tpu_torch.data import (image_loader,
                                                         random_split,
                                                         scan_image_folder)

    cfg = nvit_config(data)
    index = scan_image_folder(data)
    tr_idx, va_idx = random_split(len(index), cfg.train_split, cfg.seed)
    train = image_loader(index, tr_idx, batch_size=cfg.global_batch_size,
                         canvas=(256, 256), shuffle=True, seed=cfg.seed,
                         drop_last=True)
    val = image_loader(index, va_idx, batch_size=cfg.global_batch_size,
                       canvas=(224, 224), shuffle=False, drop_last=False)
    trainer = Trainer(cfg, model=train_model(create_model, state_dict,
                                             "fused", dev), device=dev)
    state = trainer.init_state(train.steps_per_epoch())
    batches = iter(train)
    attn.launches = attn.bwd_launches = 0
    attn.route_launches.update(mma=0, simt=0)
    for i in range(steps):
        before = (attn.launches, attn.bwd_launches)
        count = state.optimizer.count
        m = trainer.train_step(state, trainer.stage(next(batches)))
        made = (attn.launches - before[0], attn.bwd_launches - before[1])
        print(f"nvit train step {i + 1}: loss {m['loss']:.6f}, grad_norm "
              f"{m['grad_norm']:.6f}, K1/K2 launches {made}, lr "
              f"{state.optimizer.lr:g}")
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
            raise AssertionError(f"step {i + 1}: non-finite loss or grad_norm")
        if state.optimizer.count != count + 1:
            raise AssertionError(f"step {i + 1} was skipped by the NaN guard")
        if made != (layers, layers):
            raise AssertionError(f"step {i + 1}: K1/K2 launches {made}, "
                                 f"expected {layers} each")
    launches = (attn.launches, attn.bwd_launches)
    if attn.route_launches != {"mma": sum(launches), "simt": 0}:
        raise AssertionError(f"train: K1/K2 launches by route "
                             f"{attn.route_launches}, expected all "
                             f"{sum(launches)} on mma")
    batches.close()
    out = trainer.evaluate(val)
    if not (np.isfinite(out["val_loss"]) and 0 <= out["val_acc"] <= 1):
        raise AssertionError(f"evaluate: {out}")
    print(f"nvit evaluate on {len(va_idx)} val images: {out}")
    return launches


def phase_train_compare(attn, pe, create_model, Trainer, state_dict,
                        data: str, layers: int, dev):
    """One step 'xla' (plain attention) and one 'flash' + 'pallas' (K4 + K5
    forward, plain recomputed attention backward) against 'fused' (K1 + K2)
    from identical f32 weights on one batch, augmentation and mixup off. The
    step is SGD with lr 1 and no clipping, so each parameter moves by
    exactly its gradient, and the gradients are compared leaf by leaf;
    returns each variant's worst leaf's relative difference."""
    from touhouimageclassification_tpu_torch.config import (AugmentConfig,
                                                            MixConfig)

    cfg = nvit_config(data, augment=AugmentConfig(enable_augmentation=False),
                      mix=MixConfig(enable_mixup=False))
    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, name="sgd", learning_rate=1.0, schedule="constant",
        max_grad_norm=0.0))
    rng = np.random.default_rng(SEED + 3)
    batch = {"image": rng.integers(0, 256, (8, 224, 224, 3), dtype=np.uint8),
             "label": rng.integers(0, NUM_CLASSES, 8).astype(np.int32),
             "mask": np.ones(8, bool)}
    metrics, grads = {}, {}
    for variant in VARIANTS:
        trainer = Trainer(cfg, model=train_model(create_model, state_dict,
                                                 variant, dev), device=dev)
        state = trainer.init_state()
        attn.flash_launches = pe.launches = 0
        pe.route_launches.update(wgmma=0, simt=0)
        metrics[variant] = trainer.train_step(state, trainer.stage(batch))
        made = (attn.flash_launches, pe.launches)
        expect = (layers, 1) if variant == "flash+pallas" else (0, 0)
        if made != expect or pe.route_launches["wgmma"] != made[1]:
            raise AssertionError(f"{variant} step: K4/K5 launches {made}, "
                                 f"K5 by route {pe.route_launches}, expected "
                                 f"{expect}, K5 on wgmma")
        grads[variant] = {k: state_dict[k].to(dev) - p.detach()
                          for k, p in state.model.named_parameters()}
        del trainer, state
    worst = {}
    for variant in ("xla", "flash+pallas"):
        ref, got = metrics["fused"], metrics[variant]
        dloss = abs(got["loss"] - ref["loss"])
        dnorm = abs(got["grad_norm"] / ref["grad_norm"] - 1)
        rel = sorted((((grads[variant][k] - grads["fused"][k]).norm()
                       / grads["fused"][k].norm()).item(), k)
                     for k in grads["fused"])
        # CE is 2-Lipschitz in the max-norm of the logits, which differ by
        # less than LOGIT_TOL between the variants (phase 7)
        loss_bound = 2 * LOGIT_TOL
        print(f"one nvit step {variant} vs fused (B 8, augmentation off, SGD "
              f"lr 1): loss {got['loss']:.6f} vs {ref['loss']:.6f} (|diff| "
              f"{dloss:.3e}, bound {loss_bound}), grad_norm "
              f"{got['grad_norm']:.6f} vs {ref['grad_norm']:.6f} (rel diff "
              f"{dnorm:.3e}); gradient rel diff by leaf: median "
              f"{rel[len(rel) // 2][0]:.3e}, worst {rel[-1][0]:.3e} (bound "
              f"{GRAD_TOL}) in "
              + ", ".join(f"{k} {r:.3e}" for r, k in rel[:-4:-1]))
        if dloss > loss_bound or rel[-1][0] > GRAD_TOL:
            raise AssertionError(f"{variant} vs fused train step disagreement")
        worst[variant] = rel[-1][0]
    return worst


def phase_train_throughput(torch, attn, pe, create_model, Trainer, state_dict,
                           data: str, layers: int, dev):
    """nvit train img/s of the three variants at batches 8 and 64
    (device-resident 256x256 uint8 batches: the loader is not timed), 2
    warm-up + 10 timed steps, and peak device memory; then a profile of one
    step for 'fused' at both batches and 'flash' + 'pallas' at 64. Returns
    the K4 and K5 launches of the 12 'flash' + 'pallas' batch-64 steps and
    the img/s of each (variant, batch)."""
    rng = np.random.default_rng(SEED + 4)
    launches, rates = None, {}
    for variant in VARIANTS:
        for b in (8, 64):
            cfg = nvit_config(data, global_batch_size=b)
            trainer = Trainer(cfg, model=train_model(create_model, state_dict,
                                                     variant, dev), device=dev)
            state = trainer.init_state()
            batch = trainer.stage({
                "image": rng.integers(0, 256, (b, 256, 256, 3), dtype=np.uint8),
                "label": rng.integers(0, NUM_CLASSES, b).astype(np.int32),
                "mask": np.ones(b, bool)})
            attn.flash_launches = pe.launches = 0
            pe.route_launches.update(wgmma=0, simt=0)
            for _ in range(2):
                trainer.train_step(state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            for _ in range(10):
                m = trainer.train_step(state, batch)
            secs = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            made = (attn.flash_launches, pe.launches)
            print(f"nvit train, {variant}, batch {b}: "
                  f"{10 * b / secs:.2f} img/s ({1e3 * secs / 10:.2f} ms/step, "
                  f"10 steps), peak memory {peak:.2f} GiB, last loss "
                  f"{m['loss']:.4f}, K4/K5 launches {made} in 12 steps")
            if not np.isfinite(m["loss"]):
                raise AssertionError(f"{variant} batch {b}: non-finite loss")
            rates[(variant, b)] = 10 * b / secs
            flash = variant == "flash+pallas"
            expect = (12 * layers, 12) if flash else (0, 0)
            if made != expect or pe.route_launches != {"wgmma": made[1],
                                                       "simt": 0}:
                raise AssertionError(f"{variant} batch {b}: K4/K5 launches "
                                     f"{made}, K5 by route "
                                     f"{pe.route_launches}, expected "
                                     f"{expect}, K5 on wgmma")
            if flash and b == 64:
                launches = made
            if variant == "fused" or (flash and b == 64):
                profile(torch, lambda: trainer.train_step(state, batch),
                        f"{variant} batch-{b} step")
            del trainer, state, batch
            torch.cuda.empty_cache()
    return launches, rates


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _dirs, files in os.walk(path) for f in files)


class KillAtBatch:
    """Loader wrapper that sends SIGTERM to this process when the trainer
    asks for batch ``n`` (0-based) of the run, once."""

    def __init__(self, loader, n: int):
        self.loader, self.n, self.count = loader, n, 0

    def steps_per_epoch(self):
        return self.loader.steps_per_epoch()

    def set_epoch(self, *args):
        self.loader.set_epoch(*args)

    def __iter__(self):
        for batch in self.loader:
            if self.count == self.n:
                os.kill(os.getpid(), signal.SIGTERM)
            self.count += 1
            yield batch


def fit_records(log_dir: str, train_id: str) -> list[dict]:
    with open(os.path.join(log_dir, train_id, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_fit(torch, attn, create_model, serve, data: str, pth: str,
              work: str, layers: int, dev, staged_rate: float):
    """The training loop on the card (see the module docstring, phase 11).
    Returns the K1 and K2 launches of the ``ntrain`` fit and the path of its
    ViT-L serving export."""
    from touhouimageclassification_tpu_torch.config import (PRESETS,
                                                            CheckpointConfig)
    from touhouimageclassification_tpu_torch.data import (get_class_to_idx,
                                                         random_split,
                                                         scan_image_folder)
    from touhouimageclassification_tpu_torch.train import cli, ntrain
    from touhouimageclassification_tpu_torch.train.checkpoint import (
        CheckpointManager)
    from touhouimageclassification_tpu_torch.train.trainer import Trainer

    # (a) the CLI from a working directory: the presets' relative cache/,
    # checkpoint/ and log/ land in it
    cwd = os.getcwd()
    os.chdir(work)
    snapshot = os.path.join("cache", "google--vit-large-patch16-224-in21k")
    os.makedirs(snapshot)
    os.link(pth, os.path.join(snapshot, "pytorch_model.bin"))
    cfg = dataclasses.replace(PRESETS["nvit"], data_dir=data, seed=SEED,
                              max_epochs=1)
    argv = ["--data-dir", data, "--max-epochs", "1", "--seed", str(SEED),
            "--device", "cuda"]
    index = scan_image_folder(data)
    tr_idx, va_idx = random_split(len(index), cfg.train_split, cfg.seed)
    steps = len(tr_idx) // cfg.global_batch_size
    val_batches = -(-len(va_idx) // cfg.global_batch_size)
    attn.launches = attn.bwd_launches = 0
    attn.route_launches.update(mma=0, simt=0)
    t0 = time.perf_counter()
    trainer = ntrain.main([*argv, "--no-resume"])
    fit_secs = time.perf_counter() - t0
    launches = (attn.launches, attn.bwd_launches)
    expect = (layers * (steps + val_batches), layers * steps)
    print(f"ntrain fit, 1 epoch: {steps} steps + {val_batches} val batches, "
          f"K1/K2 launches {launches} (expected {expect}), by route "
          f"{attn.route_launches}, {fit_secs:.2f} s")
    if launches != expect or attn.route_launches != {"mma": sum(launches),
                                                     "simt": 0}:
        raise AssertionError("ntrain fit: K1/K2 launches or routes")
    records = [r for r in fit_records("log", cfg.train_id) if "epoch" in r]
    if len(records) != 1 or not all(np.isfinite(records[0][k]) for k in (
            "train_loss", "val_loss", "val_acc")):
        raise AssertionError(f"ntrain fit records {records}")
    rec = records[0]
    print(f"ntrain fit record: {json.dumps(rec)}")
    print(f"nvit train img/s at batch 8: fit epoch through HostImageLoader "
          f"(PIL decode, val excluded) {rec['images_per_second']:.2f}; "
          f"staged batches (phase 10, 'fused') {staged_rate:.2f}")

    # the fit's checkpoint, restored into a fresh trainer
    ckpt = CheckpointManager(cfg.checkpoint, cfg.train_id)
    if ckpt.latest_epoch() != 1:
        raise AssertionError(f"checkpoints {ckpt.all_steps()}")
    ckpt_bytes = dir_bytes(os.path.join(ckpt.directory, "1"))
    restored = Trainer(cfg, device=dev)
    size = restored.out_size
    state = restored.init_state(steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.restore(state)
    torch.cuda.synchronize()
    restore_secs = time.perf_counter() - t0
    trained = dict(trainer.state.model.named_parameters())
    if not all(torch.equal(p, trained[k])
               for k, p in state.model.named_parameters()):
        raise AssertionError("restored parameters differ from the fit's")
    if (state.step, state.optimizer.count) != (steps, steps):
        raise AssertionError(f"restored step {state.step}, count "
                             f"{state.optimizer.count}")
    timing = CheckpointManager(dataclasses.replace(
        cfg.checkpoint, async_save=False), "timing",
        directory=os.path.join(work, "save_timing"))
    t0 = time.perf_counter()
    timing.save(1, state, {"val_acc": rec["val_acc"]})
    save_secs = time.perf_counter() - t0
    shutil.rmtree(timing.directory)
    del trainer
    print(f"ViT-L checkpoint (params + AdamW moments + meta): "
          f"{ckpt_bytes} bytes; one save {save_secs:.2f} s "
          f"({ckpt_bytes / save_secs / 1e9:.2f} GB/s), one restore "
          f"{restore_secs:.2f} s")

    tested = ntrain.main([*argv, "--test"])
    test_acc = tested.last_test_result["test_acc"]
    if not np.isfinite(test_acc):
        raise AssertionError(f"--test: {tested.last_test_result}")
    del tested
    export = os.path.join(work, "export")
    t0 = time.perf_counter()
    ntrain.main([*argv, "--transform", export])
    export_secs = time.perf_counter() - t0
    export_bytes = dir_bytes(export)
    shutil.rmtree("checkpoint")
    print(f"--test: {test_acc}; --transform: {export_bytes} bytes in "
          f"{export_secs:.2f} s (model build, restore and write)")

    out_csv = os.path.join(work, "judge_export.csv")
    serve.main(["--model", "vit-large", "--weights", export, "--image", data,
                "--data-dir", data, "--output", out_csv, "--full",
                "--canvas-cache", "off"])
    model = create_model("vit-large", num_classes=NUM_CLASSES, device=dev)
    model.load_state_dict(state.model.state_dict())
    pred = serve.Predictor(model=model, class_to_idx=get_class_to_idx(data),
                           image_size=size, mean=cfg.augment.mean,
                           std=cfg.augment.std, device=dev)
    mem_csv = os.path.join(work, "judge_in_memory.csv")
    serve.full_judge(pred, data, mem_csv, progress=False, canvas_cache="off")
    rows = []
    for path in (out_csv, mem_csv):
        with open(path, newline="") as f:
            rows.append([r[1] for r in csv.reader(f)])
    if rows[0] != rows[1] or len(rows[0]) != len(index) + 1:
        raise AssertionError("serve from the export disagrees with the "
                             "restored model")
    print(f"serve --weights <export>: {len(rows[0]) - 1} predictions, equal "
          "to a Predictor on the restored model (the export stays for phase "
          "12's judge)")
    del model, pred, restored, state
    os.chdir(cwd)

    # the profiled window, through Trainer.fit
    train, val, _, _ = cli.build_loaders(cfg, size)
    prof_dir = os.path.join(work, "profile")
    pcfg = dataclasses.replace(
        cfg, train_id="profiled", limit_train_batches=3, limit_val_batches=1,
        profile_dir=prof_dir, profile_steps=2,
        checkpoint=dataclasses.replace(cfg.checkpoint, directory=os.path.join(
            work, "ckpt_profile")), log_dir=os.path.join(work, "log"))
    Trainer(pcfg, device=dev).fit(train, val, resume=False)
    traces = os.listdir(prof_dir)
    if not traces:
        raise AssertionError("the profiled window wrote no trace")
    shutil.rmtree(pcfg.checkpoint.directory)
    print(f"profiled window: {traces[0]}, {dir_bytes(prof_dir)} bytes")

    # (b) exact resume at full width from the seeded scratch init; keep the
    # latest save only (a ViT-L training checkpoint is ~3.6 GB)
    rcfg = dataclasses.replace(
        cfg, max_epochs=2, limit_train_batches=6, limit_val_batches=2,
        log_dir=os.path.join(work, "log"),
        checkpoint=CheckpointConfig(directory=os.path.join(work, "ckpt_b"),
                                    top_k=1, monitor="", every_n_epochs=0))
    control = Trainer(dataclasses.replace(rcfg, train_id="control"),
                      device=dev)
    print(f"scratch init (seed {SEED}): pos_embed std "
          f"{control.model.pos_embed.std().item():.5f} (flax 0.02), "
          f"layer 0 qkv weight std "
          f"{control.model.layer[0].attn.qkv.weight.std().item():.5f} "
          f"(flax 1/sqrt(1024) = {1024 ** -0.5:.5f})")
    h_control = control.fit(train, val, resume=False)
    final = {k: p.detach().clone()
             for k, p in control.state.model.named_parameters()}
    final_step = control.state.step
    del control
    shutil.rmtree(os.path.join(rcfg.checkpoint.directory, "control"))
    run_cfg = dataclasses.replace(rcfg, train_id="resumed")
    h_killed = Trainer(run_cfg, device=dev).fit(KillAtBatch(train, 3), val,
                                                resume=False)
    peak_bytes = dir_bytes(rcfg.checkpoint.directory)
    resumed = Trainer(run_cfg, device=dev)
    h_resumed = resumed.fit(train, val, resume=True)
    peak_bytes = max(peak_bytes, dir_bytes(rcfg.checkpoint.directory))
    records = fit_records(run_cfg.log_dir, run_cfg.train_id)
    marks = [r for r in records if "resumed_mid_epoch" in r]
    preempted = [r for r in records if r.get("preempted")]
    diff = max((p - final[k]).abs().max().item()
               for k, p in resumed.state.model.named_parameters())
    print(f"exact resume: control {[r['train_loss'] for r in h_control]}, "
          f"killed {h_killed}, {preempted}, {marks}, resumed "
          f"{[r['train_loss'] for r in h_resumed]}; global step "
          f"{resumed.state.step} vs {final_step}; largest |parameter "
          f"difference| {diff:.3e}; checkpoint bytes on disk at most "
          f"{peak_bytes}")
    if (h_killed or len(preempted) != 1 or preempted[0]["steps"] != 3
            or len(marks) != 1 or marks[0]["start_batch"] != 3
            or [r["epoch"] for r in h_resumed] != [1, 2]
            or resumed.state.step != final_step or diff != 0.0):
        raise AssertionError("the resumed run is not the uninterrupted one")
    shutil.rmtree(rcfg.checkpoint.directory)
    return launches, export


def calibrate_bn(torch, model, images) -> None:
    """Set every BatchNorm's running statistics to the batch statistics of
    ``images`` (one train-mode forward with momentum 0, no gradient), so
    that the eval-mode model normalises its activations as training would
    leave it; the momentum goes back to the class's (flax's 0.9)."""
    from touhouimageclassification_tpu_torch.models.resnet import BatchNorm2d

    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.momentum = 0.0
    with torch.no_grad():
        model.train()(images)
    for m in norms:
        del m.momentum
    model.eval()


def resnet_serve_and_train(torch, serve, create_model, Trainer, data: str,
                           data_mean, data_std, dev) -> dict:
    """ResNet-152 at 256x256 (phase 12, first half): bf16 logits against
    the same weights in f32, every conv on channels_last, bucket-1 p50 and
    bucket-64 img/s; then 10 steps of the resnet152 preset at batch 80 on
    staged batches (img/s, peak memory), a NaN step skipped with the BN
    statistics kept, and a profile of one step. Returns the numbers."""
    from touhouimageclassification_tpu_torch.config import PRESETS
    from touhouimageclassification_tpu_torch.models.resnet import (Bottleneck,
                                                                   Conv2d)

    out = {}
    rng = np.random.default_rng(SEED + 12)
    imgs = rng.integers(0, 256, (64, 256, 256, 3), dtype=np.uint8)
    x = torch.from_numpy(imgs[:16]).to(dev).float() / 255.0
    x = (x - torch.tensor(data_mean, device=dev).float()) / torch.tensor(
        data_std, device=dev).float()
    m32 = create_model("resnet152", num_classes=NUM_CLASSES, device=dev,
                       compute_dtype="float32", param_dtype="float32",
                       seed=SEED)
    calibrate_bn(torch, m32, x)
    m16 = create_model("resnet152", num_classes=NUM_CLASSES, device=dev,
                       seed=SEED)
    m16.load_state_dict(m32.state_dict())
    m16.eval()
    seen, blocks = [], []

    def on_conv(module, args):
        seen.append(args[0].is_contiguous(memory_format=torch.channels_last)
                    and module.weight.is_contiguous(
                        memory_format=torch.channels_last)
                    and args[0].is_cuda)

    def on_block(module, args, output):
        blocks.append((module, args[0], output))

    hooks = [m.register_forward_pre_hook(on_conv) for m in m16.modules()
             if isinstance(m, Conv2d)]
    hooks += [m.register_forward_hook(on_block)
              for m in m16.modules() if isinstance(m, Bottleneck)]
    twins = dict(zip((m for m in m16.modules() if isinstance(m, Bottleneck)),
                     (m for m in m32.modules() if isinstance(m, Bottleneck))))
    with torch.inference_mode():
        ref = m32(x[:8])
        got = m16(x[:8])
        # each block in bf16 against the same block in f32 on the same
        # input: 3 convs, 3 BNs and the add, rounded to bf16 at each
        worst = max((((out.float() - twins[blk](inp.float())).norm()
                      / twins[blk](inp.float()).norm()).item()
                     for blk, inp, out in blocks))
    for h in hooks:
        h.remove()
    if len(seen) != 155 or not all(seen) or len(blocks) != 50:
        raise AssertionError(f"convs on channels_last on the card: "
                             f"{sum(seen)} of {len(seen)}, expected 155; "
                             f"{len(blocks)} blocks")
    diff = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"ResNet-152 256x256 B 8, bf16 over f32 weights vs f32 on the card "
          f"(BN calibrated on 16 images): each of the 50 blocks on its own "
          f"input, worst relative difference in norm {worst:.4e} (bound "
          f"{RESNET_BLOCK_TOL}); end to end max |d logit| {diff:.4e}, largest "
          f"|logit| {scale:.4f} (bound {RESNET_LOGIT_TOL} of it); all 155 "
          f"convs on channels_last")
    if (not torch.isfinite(got).all() or worst > RESNET_BLOCK_TOL
            or diff > RESNET_LOGIT_TOL * scale):
        raise AssertionError("ResNet-152 bf16 vs f32 disagreement")
    del m32

    pred = serve.Predictor(model=m16, class_to_idx={
        f"c{i}": i for i in range(NUM_CLASSES)}, image_size=(256, 256),
        mean=data_mean, std=data_std, device=dev)
    for _ in range(5):
        pred.predict_array(imgs[:1])
    lat = []
    for i in range(60):
        t0 = time.perf_counter()
        pred.predict_array(imgs[i % 64:i % 64 + 1])
        lat.append((time.perf_counter() - t0) * 1e3)
    for _ in range(2):
        pred.predict_array(imgs)
    t0 = time.perf_counter()
    for _ in range(10):
        pred.predict_array(imgs)
    out["serve_p50_ms"] = statistics.median(lat)
    out["serve_img_s"] = 10 * 64 / (time.perf_counter() - t0)
    print(f"serve, ResNet-152 bf16 256x256: bucket-1 p50 "
          f"{out['serve_p50_ms']:.3f} ms (60 requests), bucket-64 "
          f"{out['serve_img_s']:.2f} img/s (10 batches)")
    profile(torch, lambda: pred.predict_array(imgs),
            "ResNet-152 serve bucket-64 forward")
    del pred, m16
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(PRESETS["resnet152"], data_dir=data, seed=SEED)
    trainer = Trainer(cfg, device=dev)
    if trainer.out_size != (256, 256) or trainer.model.cfg.depth != 152:
        raise AssertionError(f"resnet152 preset: {trainer.out_size}")
    state = trainer.init_state()
    b = cfg.global_batch_size
    batch = trainer.stage({
        "image": rng.integers(0, 256, (b, 256, 256, 3), dtype=np.uint8),
        "label": rng.integers(0, NUM_CLASSES, b).astype(np.int32),
        "mask": np.ones(b, bool)})
    for _ in range(2):
        trainer.train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    count = state.optimizer.count
    t0 = time.perf_counter()
    for _ in range(10):
        m = trainer.train_step(state, batch)
    secs = time.perf_counter() - t0
    out["train_img_s"] = 10 * b / secs
    out["train_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"ResNet-152 train, resnet152 preset (SGD 5e-2, step schedule, bf16 "
          f"over f32), batch {b} at 256x256: {out['train_img_s']:.2f} img/s "
          f"({1e3 * secs / 10:.2f} ms/step, 10 steps), peak memory "
          f"{out['train_peak_gib']:.2f} GiB, last loss {m['loss']:.4f}")
    if not np.isfinite(m["loss"]) or state.optimizer.count != count + 10:
        raise AssertionError("ResNet-152 train steps not finite or skipped")
    profile(torch, lambda: trainer.train_step(state, batch),
            f"ResNet-152 batch-{b} step")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    count = state.optimizer.count
    poisoned = dict(batch, image=batch["image"].float())
    poisoned["image"][0, 0, 0, 0] = float("nan")
    m = trainer.train_step(state, poisoned)
    kept = all(torch.equal(v, before[k])
               for k, v in state.model.state_dict().items())
    print(f"ResNet-152 step fed a NaN pixel: loss {m['loss']}, skipped "
          f"(optimizer count {state.optimizer.count} = {count}), parameters "
          f"and all {sum('running' in k for k in before)} BN statistics "
          f"unchanged: {kept}")
    if np.isfinite(m["loss"]) or state.optimizer.count != count or not kept:
        raise AssertionError("the NaN step was not skipped cleanly")
    del trainer, state, batch, poisoned, before
    torch.cuda.empty_cache()
    return out


def resnet_cli(serve, data: str, work: str) -> tuple[str, dict]:
    """``resnet_train`` (the resnet152 preset, ResNet-152 at 256x256, batch
    80) for one epoch on the fixture through ``HostImageLoader``, then
    ``--transform`` and serve ``--full`` from the export. Returns the export
    and the epoch's record."""
    from touhouimageclassification_tpu_torch.config import PRESETS
    from touhouimageclassification_tpu_torch.train import resnet_train

    cwd = os.getcwd()
    os.chdir(work)
    argv = ["--data-dir", data, "--max-epochs", "1", "--seed", str(SEED),
            "--device", "cuda"]
    t0 = time.perf_counter()
    trainer = resnet_train.main([*argv, "--no-resume"])
    fit_secs = time.perf_counter() - t0
    train_id = PRESETS["resnet152"].train_id
    records = [r for r in fit_records("log", train_id) if "epoch" in r]
    if len(records) != 1 or not all(np.isfinite(records[0][k]) for k in (
            "train_loss", "val_loss", "val_acc")):
        raise AssertionError(f"resnet_train records {records}")
    rec = records[0]
    steps = trainer.state.step
    print(f"resnet_train, 1 epoch: {steps} steps at batch 80, "
          f"{fit_secs:.2f} s with the model build; record {json.dumps(rec)}")
    del trainer
    export = os.path.join(work, "export_resnet")
    resnet_train.main([*argv, "--transform", export])
    with open(os.path.join(export, "serving_meta.json")) as f:
        meta = json.load(f)
    if meta["resnet_config"]["depth"] != 152 or "vit_config" in meta:
        raise AssertionError(f"ResNet export meta {meta}")
    shutil.rmtree("checkpoint")
    out_csv = os.path.join(work, "judge_resnet.csv")
    serve.main(["--model", "resnet", "--weights", export, "--image", data,
                "--data-dir", data, "--output", out_csv, "--full",
                "--canvas-cache", "off"])
    with open(out_csv, newline="") as f:
        rows = list(csv.reader(f))
    if len(rows) - 1 != NUM_CLASSES * PER_CLASS:
        raise AssertionError(f"serve from the ResNet export: {len(rows) - 1} "
                             "rows")
    print(f"serve --model resnet --weights <export> --full: {len(rows) - 1} "
          "CSV rows")
    os.chdir(cwd)
    return export, rec


def pipeline(torch, attn, data: str, work: str, vit_export: str,
             resnet_export: str, layers: int) -> dict:
    """The judge -> filter, the accuracy sweep and the web demo with the
    phase-11 ViT-L export (K1 24 per forward), counts set to 0 before each;
    returns K1's launches on each path."""
    from touhouimageclassification_tpu_torch.analysis import acc
    from touhouimageclassification_tpu_torch.infer import filter as filt
    from touhouimageclassification_tpu_torch.web import app, runtime

    n_images = NUM_CLASSES * PER_CLASS
    forwards = -(-n_images // 64)
    launches = {}

    attn.launches = 0
    judge_csv = os.path.join(work, "filter_judge.csv")
    kept_dir = os.path.join(work, "filtered")
    filt.main(["--model", "vit-large", "--weights", vit_export, "--image",
               data, "-od", kept_dir, "--csv-file", judge_csv,
               "--canvas-cache", "off"])
    launches["filter"] = attn.launches
    with open(judge_csv, newline="") as f:
        correct = sorted(os.path.relpath(r["path"], data)
                         for r in csv.DictReader(f) if r["correct"] == "True")
    kept = sorted(os.path.relpath(os.path.join(root, name), kept_dir)
                  for root, _d, files in os.walk(kept_dir) for name in files)
    print(f"filter --model vit-large: kept {len(kept)} of {n_images}, the "
          f"judge CSV's correct rows {len(correct)}; K1 launches "
          f"{launches['filter']} ({layers} per forward x {forwards})")
    if kept != correct or launches["filter"] != layers * forwards:
        raise AssertionError("filter: kept tree or K1 launches")

    attn.launches = 0
    result_dir = os.path.join(work, "result")
    rows = acc.run_sweep([("ViT_large", "vit-large", vit_export),
                          ("ResNet152", "resnet", resnet_export)],
                         test_dir=data, result_dir=result_dir, data_dir=data,
                         device="cuda")
    launches["acc"] = attn.launches
    with open(os.path.join(result_dir, "acc.csv"), newline="") as f:
        written = list(csv.DictReader(f))
    print(f"acc.run_sweep: {rows}; acc.csv {written}; K1 launches "
          f"{launches['acc']}")
    if ([r["status"] for r in rows] != ["ok", "ok"] or len(written) != 2
            or not all(0 <= r["acc"] <= 1 for r in rows)
            or launches["acc"] != layers * forwards):
        raise AssertionError("acc sweep")

    runtime.MODEL_TYPE, runtime.WEIGHTS_PATH = "vit-large", vit_export
    runtime.DATA_DIR, runtime.DEVICE = data, "cuda"
    from PIL import Image

    rng = np.random.default_rng(SEED + 13)

    def jpeg(i):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (96 + i % 5, 80, 3),
                                     dtype=np.uint8)).save(buf, format="JPEG")
        return ("files[]", f"{i}.jpg", buf.getvalue())

    attn.launches = 0
    calls = []
    cards = []
    t0 = time.perf_counter()
    for n in (3, 65):
        html = wsgi_post(app.app, [jpeg(i) for i in range(n)])
        cards.append(html.count('<div class="card">'))
        if "Model daemon: GPU" not in html:
            raise AssertionError("web banner does not say GPU")
    post_secs = time.perf_counter() - t0
    predictor = runtime.daemon.predictor
    original = predictor.predict_images

    def counted(batch):
        calls.append(len(batch))
        return original(batch)

    predictor.predict_images = counted
    images = [Image.open(io.BytesIO(jpeg(i)[2])) for i in range(8)]
    answers = [None] * 8
    gate = threading.Barrier(8)

    def ask(i):
        gate.wait()
        answers[i] = runtime.serve_batch([images[i]])[0]

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    launches["web"] = attn.launches
    web_forwards = 1 + 2 + len(calls)
    print(f"web app: POSTs of 3 and 65 images -> {cards} result cards in "
          f"{post_secs:.2f} s (the first loads the model), banner GPU; 8 "
          f"concurrent single-image requests -> {len(calls)} device calls of "
          f"{calls} images; K1 launches {launches['web']} ({layers} per "
          f"forward x {web_forwards})")
    if (cards != [3, 65] or not all(a is not None for a in answers)
            or sum(calls) != 8 or len(calls) >= 8
            or launches["web"] != layers * web_forwards):
        raise AssertionError("web app: cards, answers or coalescing")
    with runtime.daemon.lock:
        runtime.daemon.timer.cancel()
        runtime.daemon.predictor = None
    return launches


def wsgi_post(app, files) -> str:
    """The HTML answer of ``app`` to a multipart POST of ``files`` (field,
    filename, bytes) with EN labels."""
    boundary = "smokeboundary"
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="lang"'
             f"\r\n\r\nEN".encode()]
    for field, name, data in files:
        parts.append(
            f'--{boundary}\r\nContent-Disposition: form-data; name="{field}";'
            f' filename="{name}"\r\nContent-Type: image/jpeg\r\n\r\n'.encode()
            + data)
    body = b"\r\n".join(parts) + f"\r\n--{boundary}--\r\n".encode()
    environ = {"REQUEST_METHOD": "POST", "PATH_INFO": "/", "QUERY_STRING": "",
               "CONTENT_LENGTH": str(len(body)),
               "CONTENT_TYPE": f"multipart/form-data; boundary={boundary}",
               "wsgi.input": io.BytesIO(body)}
    status = []
    html = b"".join(app(environ, lambda s, h: status.append(s))).decode()
    if status != ["200 OK"]:
        raise AssertionError(f"web app answered {status}")
    return html


def phase_resnet_pipeline(torch, attn, serve, create_model, Trainer,
                          data: str, work: str, vit_export: str, data_mean,
                          data_std, layers: int, dev):
    """Phase 12: ResNet-152 serve and train, the resnet_train CLI, then the
    filter, the accuracy sweep and the web demo (see the module
    docstring). Returns K1's launches on the three pipeline paths."""
    numbers = resnet_serve_and_train(torch, serve, create_model, Trainer,
                                     data, data_mean, data_std, dev)
    resnet_export, rec = resnet_cli(serve, data, work)
    print(f"ResNet-152 fit epoch through HostImageLoader (PIL decode to 256x"
          f"256, val excluded): {rec['images_per_second']:.2f} img/s; staged "
          f"batch 80: {numbers['train_img_s']:.2f} img/s")
    return pipeline(torch, attn, data, work, vit_export, resnet_export,
                    layers)


def phase_studies(torch, attn, study):
    """Phase 13: the kernel studies S5 and S6 (see the module docstring).
    Returns their entries of the kernels line: one per level and variant,
    with its launches on the study path and its numbers at B 64."""
    from touhouimageclassification_tpu_torch.tools import bench_dma, roofline_attn

    n, c, h = 197, 1024, 16
    study.reset_launches()
    peels = roofline_attn.measure(STUDY_BATCHES, reps=30)
    copies = bench_dma.measure(STUDY_BATCHES, reps=30)
    launches = {**{f"fwd {k}": v for k, v in study.peel_launches.items()},
                **{f"bwd {k}": v for k, v in study.peel_bwd_launches.items()},
                **study.null_copy_launches}
    for result in peels + copies:
        print(json.dumps(result))
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"study path launched no {idle}")
    print(f"study path launches (tools.roofline_attn and tools.bench_dma at "
          f"B {STUDY_BATCHES}): {launches}")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    bf16 = torch.bfloat16
    errs, plain = {}, {}
    for b in STUDY_BATCHES:
        qkv = torch.randn(b, n, 3 * c, generator=gen, device=dev).to(bf16)
        g = torch.randn(b, n, c, generator=gen, device=dev).to(bf16)
        runs = {f"fwd {lv}": (
            lambda lv=lv: study.slab_attention_peel_forward(qkv, h, lv),
            lambda lv=lv: study.peel_forward_reference(qkv, h, lv),
            lv in ("dma", "layout")) for lv in study.PEEL_LEVELS}
        runs.update({f"bwd {lv}": (
            lambda lv=lv: study.slab_attention_peel_backward(qkv, g, h, lv),
            lambda lv=lv: study.peel_backward_reference(qkv, g, h, lv),
            lv == "dma") for lv in study.BWD_PEEL_LEVELS})
        for variant, (_, _, rows) in study.NULL_COPY_VARIANTS.items():
            slab = torch.randn(b, rows or n, 3 * c, generator=gen,
                               device=dev).to(bf16)
            runs[variant] = (
                lambda slab=slab, v=variant: study.null_copy(slab, c, v),
                lambda slab=slab, v=variant: study.null_copy_reference(
                    slab, c, v), True)
        for key, (kernel, reference, exact) in runs.items():
            out = kernel()
            torch.cuda.synchronize()
            ref = reference()
            if exact and not torch.equal(out, ref):
                raise AssertionError(f"{key}, B {b}: not bit-equal to its "
                                     "plain version")
            err = check_close(torch, f"{key} vs plain, B {b}", out, ref, bf16,
                              verbose=False)[0]
            if b == 64:
                errs[key] = err
                plain[key] = cuda_ms(reference)
        if not torch.equal(study.slab_attention_peel_forward(qkv, h, "full"),
                           attn.slab_attention_forward(qkv, h)):
            raise AssertionError(f"fwd full, B {b}: differs from K1")
        if not torch.equal(
                study.slab_attention_peel_backward(qkv, g, h, "full"),
                attn.slab_attention_backward(qkv, g, h)):
            raise AssertionError(f"bwd full, B {b}: differs from K2")
        if b == 64:
            views = qkv.view(b, n, 3, h, c // h).unbind(2)
            sdpa_ms = cuda_ms(lambda: sdpa(torch, *views))
            leaf = qkv.detach().requires_grad_()
            sdpa_bwd_ms = sdpa_backward_ms(
                torch, (leaf,), leaf.view(b, n, 3, h, c // h).unbind(2), g)
    print(f"S5 and S6 vs plain at B {STUDY_BATCHES}: dma, layout and the "
          f"copies bit-equal; matmul and full within {TOL['bfloat16']} and "
          f"{REL_TOL['bfloat16']} in norm; full bit-equal to K1 and K2; max "
          f"|diff| at B 64 {errs}")

    at64 = {r["batch"]: r for r in peels}[64]
    copies64 = {r["batch"]: r for r in copies}[64]["variants"]
    entries = []
    for key in launches:
        if key.startswith(("fwd", "bwd")):
            way, level = key.split()
            tool_key = f"{way}_{level}"
            ms, device = at64["ms"][tool_key], at64["device_ms"][tool_key]
            products = 0 if level in ("dma", "layout") else (
                2 if way == "fwd" else 5)
            elems = (4 if way == "fwd" else 7) * 64 * n * c
            flops = products * 2 * 64 * h * n * n * (c // h)
            library = {"fwd full": sdpa_ms, "bwd full": sdpa_bwd_ms}.get(
                key, None if level == "matmul" else plain[key])
            name = f"slab_attention_peel_{way}[{level}]"
            source = f"slab_attention_{way}.cu"
            replaces = "tools/roofline_attn.py:" + (
                "95" if way == "fwd" else "154")
            device_route = "mma"
        else:
            rec = copies64[key]
            ms, device = rec["ms"], rec["device_ms"]
            flops, elems = 0, 4 * 64 * rec["n"] * c
            library = plain[key]
            name, source = f"slab_null_copy[{key}]", "slab_null_copy.cu"
            replaces = "tools/bench_dma.py:" + (
                "67" if key == "lanes" else "51")
            device_route = "cp.async"
        bound_ms, bound_by = bound(flops, 2 * elems, bf16)
        entries.append({
            "name": name, "route": "cuda",
            "source": "touhouimageclassification_tpu_torch/csrc/" + source,
            "device_routes": {"bfloat16": device_route},
            "replaces": replaces, "launches": launches[key],
            "launches_by_path": {"study": launches[key]},
            "max_abs_err": errs[key], "ms": ms, "device_ms": device,
            "plain_ms": plain[key], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library})
    return entries


def profile(torch, fn, label: str):
    """Device time by kernel of one ``fn()`` (a train step or a serve
    forward), and the device's busy share of its wall time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: a user annotation (the optimizer's step range) spans
    # kernels that are counted on their own
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profile, one {label}: wall {wall_ms:.3f} ms (profiler on), "
          f"device kernels {device_ms:.3f} ms, busy share "
          f"{device_ms / wall_ms:.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d} x  "
              f"{e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from touhouimageclassification_tpu_torch.config import vit_config
    from touhouimageclassification_tpu_torch.infer import serve
    from touhouimageclassification_tpu_torch.models import create_model
    from touhouimageclassification_tpu_torch.ops import _build
    from touhouimageclassification_tpu_torch.ops import attention as attn
    from touhouimageclassification_tpu_torch.ops import attention_study as study
    from touhouimageclassification_tpu_torch.ops import patch_embed as pe
    from touhouimageclassification_tpu_torch.train.trainer import Trainer
    from touhouimageclassification_tpu_torch.utils.convert import load_vit_weights

    card = card_line()
    print(card)
    import safetensors

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"safetensors {safetensors.__version__}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib_path = _build.build_library()
    _build.load_library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s -> "
          f"{os.path.relpath(lib_path, ROOT)}")
    for line in (lib_path.parent / "nvcc.log").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("ptxas:", line.strip())

    stats = {"K1": phase_kernels(torch, attn),
             "K2": phase_backward(torch, attn),
             **phase_three_operand_kernels(torch, attn),
             "K5": phase_patch_embed(torch, pe)}
    packed_launches = phase_packed_op(torch, attn)

    layers = 24
    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build_dir) as work:
        data = make_image_folder(os.path.join(work, "data"), NUM_CLASSES,
                                 PER_CLASS)
        pth = os.path.join(work, "vit_large_random.pth")
        torch.save(hf_vit_state_dict(1024, layers, 4096, NUM_CLASSES), pth)
        serve_launches = phase_serve(torch, attn, serve, work, pth, data,
                                     layers)
        with open(os.path.join(data, "meta_mean_std.json")) as f:
            mean_std = json.load(f)
        dev = torch.device("cuda", 0)
        flash_serve = phase_model(torch, attn, pe, serve, create_model,
                                  load_vit_weights, pth, mean_std["mean"],
                                  mean_std["std"], dev, layers)
        state_dict = load_vit_weights(
            pth, vit_config("vit-large", num_classes=NUM_CLASSES))
        train_launches = phase_train(attn, create_model, Trainer, state_dict,
                                     data, layers, dev)
        phase_train_compare(attn, pe, create_model, Trainer, state_dict, data,
                            layers, dev)
        flash_train, rates = phase_train_throughput(
            torch, attn, pe, create_model, Trainer, state_dict, data, layers,
            dev)
        fit_launches, vit_export = phase_fit(
            torch, attn, create_model, serve, data, pth, work, layers, dev,
            rates[("fused", 8)])
        pipeline_launches = phase_resnet_pipeline(
            torch, attn, serve, create_model, Trainer, data, work, vit_export,
            mean_std["mean"], mean_std["std"], layers, dev)
    study_kernels = phase_studies(torch, attn, study)

    borrowed = sorted(m for m in sys.modules if m == "jax"
                      or m.split(".")[0] == "touhouimageclassification_tpu")
    if borrowed:
        raise AssertionError(f"the port imported {borrowed[:5]}")
    csrc = "touhouimageclassification_tpu_torch/csrc/"
    ref = "touhouimageclassification_tpu/ops/"
    kernels = [
        ("K1", "slab_attention_fwd", "slab_attention_fwd.cu",
         "attention.py:455", {"serve": serve_launches,
                              "train": train_launches[0],
                              "fit": fit_launches[0],
                              **pipeline_launches}, "fit"),
        ("K2", "slab_attention_bwd", "slab_attention_bwd.cu",
         "attention.py:482", {"train": train_launches[1],
                              "fit": fit_launches[1]}, "fit"),
        ("K3 fwd", "packed_attention_fwd", "slab_attention_fwd.cu",
         "attention.py:253", {"packed_attention": packed_launches[0]},
         "packed_attention"),
        ("K3 bwd", "packed_attention_bwd", "slab_attention_bwd.cu",
         "attention.py:309", {"packed_attention": packed_launches[1]},
         "packed_attention"),
        ("K4", "flash_attention_fwd", "slab_attention_fwd.cu",
         "attention.py:38", {"serve": flash_serve[0],
                             "train": flash_train[0]}, "train"),
        ("K5", "patch_embed", "patch_embed.cu", "patch_embed.py:22",
         {"serve": flash_serve[1], "train": flash_train[1]}, "train"),
    ]
    # the device route each wrapper names for ViT-L's shapes, by dtype
    device_routes = {
        key: {dtype_key(dt): (pe.kernel_route(dt, 16, 3, 224) if key == "K5"
                              else attn.kernel_route(dt, 64))
              for dt in (torch.bfloat16, torch.float32)}
        for key in stats}
    print(card)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": csrc + source,
        "device_routes": device_routes[key],
        "replaces": ref + replaces, "launches": by_path[main_path],
        "launches_by_path": by_path, **stats[key]}
        for key, name, source, replaces, by_path, main_path in kernels]
        + study_kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
