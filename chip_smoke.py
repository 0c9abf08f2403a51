#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's serve path and its train step
(``touhouimageclassification_tpu_torch``) at the full width and depth of
ViT-Large/16 at 224x224, of ResNet-152 at 256x256, and of the ResMoE and
TreeViT mixtures of nine ViT-Base/16 members at 224x224, with random weights
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
    to K1 and K2 bit for bit;
14. the kernel studies S1-S4, the study path: ``tools.bench_attn4`` (S1,
    whole images a block), ``tools.bench_attn6`` (S2, exp / exp2 and the
    divide of P / 1 / l after PV, on K1's kernel), ``tools.bench_attn7``
    (S3, head batching, forward and backward) and ``tools.bench_attn8`` (S4,
    H / S heads a block, forward and backward) at ViT-L's width and B 64 and
    128, their launches counted by tile and variant; then every tile held
    to its plain version within the bf16 bounds and to K1 (forward) and K2
    (backward) bit for bit, at B 64 and 128 and on ragged shapes (B 1, 2, 3;
    N 16, 67, 197, 257), the S2 variants to their plain versions (exp2
    without post_mul to K1 bit for bit), a tile past shared memory (N 577)
    raising, and ``tile_smem_bytes`` equal to the C sums;
15. the mixture families at the presets' full width (8 + 1 ViT-B/16
    members at 224x224, 120 classes, random weights from seed 0), K1 and K2
    counted on every path (108 K1 launches a forward, 108 K2 a train step
    where the loss reads all nine members): ResMoE in bf16 against the same
    weights with plain attention in its members (each member's logits
    within the whole-model bound, the gate's ``top_i`` equal wherever its
    top-3 gaps exceed it, the combined logits where the routes agree),
    sparse ``feature`` and ``image`` dispatch against dense at capacity
    factor E/K, bucket-1 p50 and bucket-64 img/s; 16 steps of the
    ``resmoe`` preset (batch 4, SGD, 4-step accumulation: finite, none
    skipped, img/s, peak memory) and one sparse step with its routing
    telemetry; ``train.resmoe`` for one epoch, ``--transform``, serve
    ``--full`` from the export (equal to a Predictor on the trained model),
    ``infer.filter --model resmoe`` and the accuracy sweep's ResMoE row;
    TreeViT's dense-eval forward and serving, 16 capacity-dispatch steps of
    the ``treevit`` preset's full stage, ``train.treevit --stage all`` (root
    -> sons -> full, one epoch each), ``--transform`` and serve; then K1 and
    K2 alone at ViT-B's width (N 197, C 768, 12 heads, bf16) and B 2, 4 and
    64 against their plain versions, timed around one launch and as device
    time beside SDPA (and its autograd backward) and the bytes bound.
16. multi-GPU on the one card: (a) ``train.ntrain`` (nvit, ViT-L, batch
    8, one epoch from the seeded scratch init) without distribution and as
    one NCCL rank (``--coordinator 127.0.0.1:<free port> --num-processes 1
    --process-id 0``): every step's loss bit-equal, K1/K2 24 a step; (b) a
    probe of two NCCL ranks on the card (NCCL refuses a second rank on a
    device), then two ranks over gloo on CUDA tensors (children of this
    script, ``--rank``): ViT-L nvit steps at 2 x 8 against one process at
    16 with the augmentation and CutMix/MixUp on (loss, grad norm,
    parameters; the gradient all-reduce timed apart), and ResMoE at the
    preset's width with 4 experts a rank (logits and one step against one
    process; a fit that SIGTERM to rank 1 alone stops after step 3 on
    both, resumed to the end of the epoch; the expert-sharded checkpoint
    restored in one process and served). Per-rank K1/K2 counts, step times
    and peak memory are printed and the counts join the kernels line.
17. the weight-loading route and the augmentation grids, each step's
    seconds and bytes printed and K1 counted on each serve: (a) on phase
    11's fit, before its checkpoint is deleted, ``python -m
    ...utils.extract_ckpt`` on the epoch directory (the extracted
    ``params.safetensors`` bit-equal to the ``--transform`` export's,
    tensor for tensor), then serve ``--model vit-large --weights
    <extracted>`` meta-less (K1 24 a forward), its judge CSV equal to a
    Predictor's on the export's parameters with the dataset's mean and
    std; (b) after phase 11, ``utils.convert``'s CLI and ``extract_ckpt
    --model vit-large`` on phase 6's random ViT-L ``.pth``, each served
    with ``--model vit-large``: the judge CSV equal to phase 6's from the
    ``.pth`` row for row; (d) then ``analysis.aug`` at 224x224 on the card
    (PNGs of 1, 8, 8 and 16 tiles, the recipes on CUDA tensors); (c) at the
    end of phase 16, ``extract_ckpt`` on the expert-sharded ResMoE save,
    served meta-less with ``--model resmoe`` in one process (K1 108 a
    forward), its logits on phase 16's batch within ``EP_LOGIT_ATOL`` of
    the restored trainer's.

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout of the
repository, the script exits non-zero before printing either.
"""
from __future__ import annotations

import csv
import dataclasses
import gc
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
# The tile studies' edge shapes (phase 14): (B, N) with B ragged for 2 and 4
# images a block and N from one 16-row chunk to ragged row blocks past 256.
# At N 577 (D 64) two stages of K_h and V_h exceed a block's shared memory.
TILE_EDGES = ((1, 67), (2, 16), (3, 197), (3, 257))
TILE_TOO_LONG = 577
# The model variants: the default configuration, the plain attention, and
# the slice of the three-operand kernels ('flash' = K4, 'pallas' = K5).
VARIANTS = {
    "fused": dict(attention_impl="fused"),
    "xla": dict(attention_impl="xla"),
    "flash+pallas": dict(attention_impl="flash", patch_embed_impl="pallas"),
}
# Phase 15, the mixture families at the presets' full width: ResMoE's 8
# experts + gate and TreeViT's 8 sons + root, each member a ViT-B/16 (12
# encoder layers) at 224x224 on the default 'fused' attention, so a forward
# launches K1 108 times. K1 and K2 are timed alone at ViT-B's width and the
# mixtures' batches: a member's share of a bucket-1 request and of the
# preset's batch 4 (TreeViT's sons and sparse experts see capacity 2), and
# the judge's bucket 64.
MIX_MEMBERS = 9
VIT_B_LAYERS = 12
MIX_K1 = MIX_MEMBERS * VIT_B_LAYERS
VIT_B_BATCHES = (2, 4, 64)


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
    """The training loop on the card (see the module docstring, phase 11),
    with phase 17(a) on its checkpoint. Returns the K1 and K2 launches of
    the ``ntrain`` fit, the path of its ViT-L serving export and K1's
    launches serving the extracted params."""
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
    extracted = phase_extract_vit(torch, os.path.join(ckpt.directory, "1"),
                                  export, work)
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
    extracted_k1 = phase_serve_extracted_vit(attn, serve, create_model,
                                             extracted, export, data, work,
                                             layers, dev)
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
    return launches, export, {"serve_extracted_vit_l": extracted_k1}


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


def phase_tile_studies(torch, attn, study):
    """Phase 14: the kernel studies S1-S4 (see the module docstring). Returns
    their entries of the kernels line: one per study key and direction,
    with its launches on the study path and its numbers at B 64."""
    from touhouimageclassification_tpu_torch.tools import (
        attn_tiles, bench_attn4, bench_attn6, bench_attn7, bench_attn8)

    tools = {"S1": bench_attn4, "S2": bench_attn6, "S3": bench_attn7,
             "S4": bench_attn8}
    h, d = 16, 64
    c = h * d
    study.reset_launches()
    records = {name: tool.measure(STUDY_BATCHES, reps=30)
               for name, tool in tools.items()}
    fwd, bwd = dict(study.tile_launches), dict(study.tile_bwd_launches)
    soft = dict(study.softmax_launches)
    for recs in records.values():
        for rec in recs:
            print(json.dumps(rec))
    idle = ([f"fwd {t}" for t in study.FWD_TILES if not fwd[t]]
            + [f"bwd {t}" for t in study.BWD_TILES if not bwd[t]]
            + [f"softmax {k}" for k in study.SOFTMAX_VARIANTS if not soft[k]])
    if idle:
        raise AssertionError(f"study path launched no {idle}")
    print(f"study path launches (tools.bench_attn4/6/7/8 at B "
          f"{STUDY_BATCHES}): forward tiles {list(fwd.values())}, backward "
          f"tiles {list(bwd.values())}, softmax variants {soft}")
    for name, recs in records.items():
        for rec in recs:
            k1_twin = name != "S2" or (rec.get("exp2") and not rec["post_mul"])
            if "baseline" not in rec and (
                    (k1_twin and not rec["fwd_bit_equal_k1"])
                    or rec.get("bwd_bit_equal_k2") is False):
                raise AssertionError(f"{name} {rec}: not bit-equal to K1/K2")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    bf16 = torch.bfloat16
    fwd_tiles = (*study.FWD_TILES, study.SHIPPED_TILE)
    bwd_tiles = (*study.BWD_TILES, study.SHIPPED_TILE)
    shapes = [(b, 197) for b in STUDY_BATCHES] + list(TILE_EDGES)
    for b, n in shapes:
        qkv = torch.randn(b, n, 3 * c, generator=gen, device=dev).to(bf16)
        g = torch.randn(b, n, c, generator=gen, device=dev).to(bf16)
        k1 = attn.slab_attention_forward(qkv, h)
        k2 = attn.slab_attention_backward(qkv, g, h)
        plain_fwd = attn.slab_attention_reference(qkv, h)
        plain_bwd = attn.slab_attention_backward_reference(qkv, g, h)
        for tile in fwd_tiles:
            out = study.slab_attention_tile_forward(qkv, h, tile)
            torch.cuda.synchronize()
            if not torch.equal(out, k1):
                raise AssertionError(f"fwd {tile}, B {b} N {n}: differs from K1")
            check_close(torch, f"fwd {tile}", out, plain_fwd, bf16,
                        verbose=False)
        for tile in bwd_tiles:
            out = study.slab_attention_tile_backward(qkv, g, h, tile)
            torch.cuda.synchronize()
            if not torch.equal(out, k2):
                raise AssertionError(f"bwd {tile}, B {b} N {n}: differs from K2")
            check_close(torch, f"bwd {tile}", out, plain_bwd, bf16,
                        verbose=False)
        for key in study.SOFTMAX_VARIANTS:
            out = study.softmax_variant_forward(qkv, h, *key)
            torch.cuda.synchronize()
            check_close(torch, f"softmax {key}", out,
                        study.softmax_variant_reference(qkv, h, *key), bf16,
                        verbose=False)
            if key == (True, False) and not torch.equal(out, k1):
                raise AssertionError(f"softmax {key}, B {b} N {n}: differs "
                                     "from K1")
    lib = attn.load_library()
    for tile in (*fwd_tiles, *bwd_tiles):
        for backward in (False, True):
            if backward and tile.staged != 1:
                continue
            for n in (16, 67, 197, 257, TILE_TOO_LONG):
                want = lib.tic_attention_tile_smem_bytes(
                    n, d, tile.staged, tile.stages, int(backward))
                if study.tile_smem_bytes(tile, n, d, backward) != want:
                    raise AssertionError(f"{tile} N {n}: tile_smem_bytes "
                                         f"differs from the C sum {want}")
    too_long = torch.zeros(1, TILE_TOO_LONG, 3 * c, dtype=bf16, device=dev)
    g_long = too_long[..., :c].contiguous()
    runs = [lambda t=t: study.slab_attention_tile_forward(too_long, h, t)
            for t in study.FWD_TILES]
    runs += [lambda t=t: study.slab_attention_tile_backward(too_long, g_long,
                                                           h, t)
             for t in study.BWD_TILES]
    for run in runs:
        try:
            run()
        except ValueError as e:
            if "shared memory" not in str(e):
                raise
        else:
            raise AssertionError(f"a tile at N {TILE_TOO_LONG} did not raise")
    print(f"S1-S4 at (B, N) {shapes}: every tile bit-equal to K1 (forward) "
          f"and K2 (backward) and within {TOL['bfloat16']} and "
          f"{REL_TOL['bfloat16']} in norm of the plain versions; the S2 "
          "variants within the same bounds of theirs, exp2 without post_mul "
          f"bit-equal to K1; N {TILE_TOO_LONG} raises; tile_smem_bytes equals "
          "the C sums")

    replaces = {("S1", "fwd"): "tools/bench_attn4.py:50",
                ("S2", "fwd"): "tools/bench_attn6.py:55",
                ("S3", "fwd"): "tools/bench_attn7.py:118",
                ("S3", "bwd"): "tools/bench_attn7.py:128",
                ("S4", "fwd"): "tools/bench_attn8.py:45",
                ("S4", "bwd"): "tools/bench_attn8.py:100"}
    entries = []
    qkv = torch.randn(64, 197, 3 * c, generator=gen, device=dev).to(bf16)
    g = torch.randn(64, 197, c, generator=gen, device=dev).to(bf16)
    leaf = qkv.detach().requires_grad_()
    library = {"fwd": cuda_ms(lambda: sdpa(
        torch, *qkv.view(64, 197, 3, h, d).unbind(2))),
        "bwd": sdpa_backward_ms(torch, (leaf,), leaf.view(
            64, 197, 3, h, d).unbind(2), g)}
    for name, recs in records.items():
        for rec in recs:
            if "baseline" in rec or rec["batch"] != 64:
                continue
            if name == "S2":
                label = f"exp2={rec['exp2']} post_mul={rec['post_mul']}"
            else:
                key_name = attn_tiles.KEY_NAMES[name]
                label = f"{key_name} {rec[key_name]}"
            tile = study.Tile(**rec["tile"])
            for way in ("fwd", "bwd"):
                if f"{way}_device_ms" not in rec:
                    continue
                if name == "S2":
                    n_launch = soft[(rec["exp2"], rec["post_mul"])]
                    kernel, source = ("softmax_variant_forward",
                                      "slab_attention_fwd.cu")
                else:
                    n_launch = (fwd if way == "fwd" else bwd)[tile]
                    kernel = ("slab_attention_tile_forward" if way == "fwd"
                              else "slab_attention_tile_backward")
                    source = "slab_attention_tile.cu"
                products = 2 if way == "fwd" else 5
                elems = (4 if way == "fwd" else 7) * 64 * 197 * c
                bound_ms, bound_by = bound(
                    products * 2 * 64 * h * 197 * 197 * d, 2 * elems, bf16)
                device = rec[f"{way}_device_ms"]
                entry = {
                    "name": f"{kernel}[{name} {label}]", "route": "cuda",
                    "source": "touhouimageclassification_tpu_torch/csrc/"
                              + source,
                    "device_routes": {"bfloat16": "mma"},
                    "replaces": replaces[(name, way)], "launches": n_launch,
                    "launches_by_path": {"study": n_launch},
                    "max_abs_err": rec[f"{way}_max_abs_err"],
                    "ms": rec[f"{way}_ms"], "device_ms": device,
                    "plain_ms": rec[f"{way}_plain_ms"], "bound_ms": bound_ms,
                    "bound_by": bound_by, "share": bound_ms / device,
                    "library_ms": library[way],
                    "tile": rec["tile"], "blocks": rec["blocks"],
                    "stages": rec["stages"]}
                if "same_kernel_as" in rec:
                    entry["same_kernel_as"] = rec["same_kernel_as"]
                entries.append(entry)
    return entries


def zero_counts(attn) -> None:
    """Set K1's and K2's launch counts and routes to 0 before a path."""
    attn.launches = attn.bwd_launches = 0
    attn.route_launches.update(mma=0, simt=0)


def read_counts(attn, what: str, expect: tuple[int, int]) -> tuple[int, int]:
    """K1's and K2's launches since :func:`zero_counts`: they must be
    ``expect``, every one on the mma route (bf16)."""
    made = (attn.launches, attn.bwd_launches)
    print(f"{what}: K1/K2 launches {made} (expected {expect}), by route "
          f"{attn.route_launches}")
    if made != expect or attn.route_launches != {"mma": sum(made),
                                                 "simt": 0}:
        raise AssertionError(f"{what}: K1/K2 launches {made}, routes "
                             f"{attn.route_launches}, expected {expect} on "
                             "mma")
    return made


def normalised(torch, imgs, mean, std, dev):
    x = torch.from_numpy(imgs).to(dev).float() / 255.0
    return (x - torch.tensor(mean, device=dev).float()) / torch.tensor(
        std, device=dev).float()


def serve_rates(pred, imgs) -> tuple[float, float, int]:
    """Bucket-1 p50 (ms, 60 requests after 5) and bucket-64 img/s (10
    batches after 2) of a Predictor; returns them and the forwards made."""
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
    rate = 10 * 64 / (time.perf_counter() - t0)
    return statistics.median(lat), rate, 5 + 60 + 2 + 10


def mixture_serve(torch, attn, serve, model, imgs, mean, std, dev,
                  what: str) -> tuple[dict, tuple[int, int]]:
    """A bf16 mixture behind a Predictor: bucket-1 p50, bucket-64 img/s,
    K1 launched MIX_K1 times a forward, profiles of one bucket-1 and one
    bucket-64 forward. Returns the numbers and K1's and K2's launches."""
    pred = serve.Predictor(model=model, class_to_idx={
        f"c{i}": i for i in range(NUM_CLASSES)}, image_size=(224, 224),
        mean=mean, std=std, device=dev)
    zero_counts(attn)
    p50, rate, forwards = serve_rates(pred, imgs)
    launches = read_counts(attn, f"{what} serve, {forwards} forwards",
                           (MIX_K1 * forwards, 0))
    print(f"serve, {what} bf16 (9 ViT-B/16 members, 224x224): bucket-1 p50 "
          f"{p50:.3f} ms (60 requests), bucket-64 {rate:.2f} img/s (10 "
          f"batches)")
    profile(torch, lambda: pred.predict_array(imgs[:1]),
            f"{what} serve bucket-1 forward")
    profile(torch, lambda: pred.predict_array(imgs),
            f"{what} serve bucket-64 forward")
    return {"serve_p50_ms": p50, "serve_img_s": rate}, launches


def phase_resmoe_serve(torch, attn, serve, create_model, mean, std, dev):
    """Phase 15, ResMoE serving (see the module docstring)."""
    from touhouimageclassification_tpu_torch.config import VIT_BASE

    fused = create_model("resmoe", num_classes=NUM_CLASSES, device=dev,
                         seed=SEED).eval()
    cfg = fused.cfg
    weights = fused.state_dict()

    def twin(**over):
        model = create_model("resmoe", num_classes=NUM_CLASSES, device=dev,
                             **over)
        model.load_state_dict(weights)
        return model.eval()

    plain = twin(expert_vit=dataclasses.replace(VIT_BASE,
                                                attention_impl="xla"))
    rng = np.random.default_rng(SEED + 15)
    imgs = rng.integers(0, 256, (64, 224, 224, 3), dtype=np.uint8)
    x = normalised(torch, imgs[:8], mean, std, dev)
    with torch.inference_mode():
        zero_counts(attn)
        got = fused(x)
        read_counts(attn, "ResMoE dense forward, B 8", (MIX_K1, 0))
        ref = plain(x)
        members = [(fused.gate.vit(x), plain.gate.vit(x))] + [
            (e(x), p(x)) for e, p in zip(fused.experts, plain.experts)]
    member_diff = max((a - b).abs().max().item() for a, b in members)
    # the top-k sets agree wherever every gap among the top k + 1 gate
    # logits exceeds the bound; combined logits are held where they agree,
    # to the bound scaled by the largest expert logit (the softmaxed top-k
    # weights move by at most half the gate logits' difference)
    gate = members[0][0].sort(dim=-1, descending=True).values
    gaps = gate[:, :cfg.top_k] - gate[:, 1:cfg.top_k + 1]
    sure = (gaps > LOGIT_TOL).all(-1)
    agree = (got[2] == ref[2]).all(-1)
    scale = 1 + max(a.abs().max().item() for a, _ in members[1:])
    comb_diff = ((got[0] - ref[0]).abs().max(-1).values[agree].max().item()
                 if agree.any() else 0.0)
    print(f"ResMoE bf16 B 8, 'xla' members vs 'fused': max |d logit| of the "
          f"9 members {member_diff:.3e} (bound {LOGIT_TOL}); top_i equal on "
          f"{int(agree.sum())} of 8 rows, required on the {int(sure.sum())} "
          f"with every top-{cfg.top_k + 1} gap > {LOGIT_TOL}; combined "
          f"logits on those rows max |diff| {comb_diff:.3e} (bound "
          f"{LOGIT_TOL * scale:.3e})")
    if (member_diff > LOGIT_TOL or not bool((agree | ~sure).all())
            or comb_diff > LOGIT_TOL * scale
            or not torch.isfinite(got[0]).all()):
        raise AssertionError("ResMoE 'xla' vs 'fused' disagreement")
    del plain
    factor = cfg.num_experts / cfg.top_k
    for level in ("feature", "image"):
        sparse = twin(routing="sparse", dispatch_level=level,
                      capacity_factor=factor)
        with torch.inference_mode():
            zero_counts(attn)
            out = sparse(x)
            read_counts(attn, f"ResMoE sparse {level} forward, B 8",
                        (MIX_K1, 0))
        diff = (out[0] - got[0]).abs().max().item()
        print(f"ResMoE sparse '{level}' dispatch at capacity factor "
              f"{factor:g} (no drops) vs dense: top_i equal "
              f"{bool(torch.equal(out[2], got[2]))}, max |d logit| "
              f"{diff:.3e} (bound {LOGIT_TOL})")
        if not torch.equal(out[2], got[2]) or diff > LOGIT_TOL:
            raise AssertionError(f"ResMoE sparse {level} vs dense")
        del sparse
    numbers, launches = mixture_serve(torch, attn, serve, fused, imgs, mean,
                                      std, dev, "ResMoE dense")
    del fused
    torch.cuda.empty_cache()
    return numbers, launches


def train_numbers(torch, attn, trainer, batches, what: str,
                  expect: tuple[int, int], steps: int, dev):
    """``steps`` checked train steps (finite, none skipped, K1/K2
    ``expect`` each), then ``steps`` timed ones (img/s, peak memory) and a
    profile of one. Returns the numbers and the checked steps' K1/K2
    launches."""
    state = trainer.state
    opt = state.optimizer
    b = trainer.cfg.global_batch_size
    zero_counts(attn)
    for i in range(steps):
        ticks = opt.count * opt.k + opt.mini_step
        m = trainer.train_step(state, batches[i % len(batches)])
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
            raise AssertionError(f"{what} step {i + 1}: {m}")
        if opt.count * opt.k + opt.mini_step != ticks + 1:
            raise AssertionError(f"{what} step {i + 1} skipped by the guard")
    print(f"{what}, {steps} steps: last {json.dumps(m)}; optimizer updates "
          f"{opt.count} (accumulating {opt.k})")
    launches = read_counts(attn, f"{what}, {steps} steps",
                           (expect[0] * steps, expect[1] * steps))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for i in range(steps):
        trainer.train_step(state, batches[i % len(batches)])
    secs = time.perf_counter() - t0
    out = {"train_img_s": steps * b / secs,
           "train_peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    print(f"{what}, batch {b}: {out['train_img_s']:.2f} img/s "
          f"({1e3 * secs / steps:.2f} ms/step, {steps} steps), peak memory "
          f"{out['train_peak_gib']:.2f} GiB")
    profile(torch, lambda: trainer.train_step(state, batches[0]),
            f"{what} batch-{b} step")
    return out, launches


def staged_batches(trainer, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    b = trainer.cfg.global_batch_size
    return [trainer.stage({
        "image": rng.integers(0, 256, (b, 224, 224, 3), dtype=np.uint8),
        "label": rng.integers(0, NUM_CLASSES, b).astype(np.int32),
        "mask": np.ones(b, bool)}) for _ in range(n)]


def phase_resmoe_train(torch, attn, create_model, Trainer, data: str, dev):
    """Phase 15, ResMoE training with the resmoe preset, dense, then one
    sparse step with its routing telemetry."""
    from touhouimageclassification_tpu_torch.config import PRESETS
    from touhouimageclassification_tpu_torch.train.tasks import MoETask

    cfg = dataclasses.replace(PRESETS["resmoe"], data_dir=data, seed=SEED)

    def trainer_for(**over):
        model = create_model("resmoe", num_classes=NUM_CLASSES,
                             param_dtype="float32", device=dev, seed=SEED,
                             **over)
        trainer = Trainer(cfg, model=model, task=MoETask(model.cfg),
                          device=dev)
        trainer.init_state()
        return trainer

    trainer = trainer_for()
    batches = staged_batches(trainer, 4, SEED + 16)
    numbers, launches = train_numbers(torch, attn, trainer, batches,
                                      "ResMoE train (resmoe preset, dense)",
                                      (MIX_K1, MIX_K1), 8, dev)
    if trainer.state.optimizer.count != 4:
        raise AssertionError("16 steps at grad_accum_steps 4 made "
                             f"{trainer.state.optimizer.count} updates")
    del trainer
    torch.cuda.empty_cache()
    trainer = trainer_for(routing="sparse")
    zero_counts(attn)
    m = trainer.train_step(trainer.state, batches[0])
    read_counts(attn, "ResMoE sparse train step", (MIX_K1, MIX_K1))
    print(f"ResMoE sparse (feature) train step: {json.dumps(m)}")
    e = trainer.model.cfg.num_experts
    if not (np.isfinite(m["loss"]) and 0 <= m["drop_frac"] <= 1
            and 1 / e <= m["expert_load_max"] <= 1
            and 0 <= m["expert_load_min"] <= 1 / e
            and np.isfinite(m["balance_loss"])):
        raise AssertionError("ResMoE sparse telemetry")
    del trainer, batches
    torch.cuda.empty_cache()
    return numbers, launches


def judge_csv_rows(path: str) -> list[str]:
    with open(path, newline="") as f:
        return [r[1] for r in csv.reader(f)]


def export_matches_predictor(serve, model_flag: str, export: str, trained,
                             data: str, work: str, dev) -> None:
    """``serve --full`` from the export equals a Predictor on the trained
    model (served in bf16, normalised by the export's mean and std)."""
    from touhouimageclassification_tpu_torch.data import get_class_to_idx
    from touhouimageclassification_tpu_torch.models import (EXPORT_CONFIGS,
                                                            config_from_dict)

    out_csv = os.path.join(work, f"judge_{model_flag}.csv")
    serve.main(["--model", model_flag, "--weights", export, "--image", data,
                "--data-dir", data, "--output", out_csv, "--full",
                "--canvas-cache", "off"])
    with open(os.path.join(export, "serving_meta.json")) as f:
        meta = json.load(f)
    key = next(k for k in EXPORT_CONFIGS if k in meta)
    family, config = EXPORT_CONFIGS[key]
    model = family(config_from_dict(config, meta[key]), device=dev)
    model.load_state_dict(trained.state_dict())
    pred = serve.Predictor(model=model, class_to_idx=get_class_to_idx(data),
                           image_size=(224, 224), mean=meta["mean"],
                           std=meta["std"], device=dev)
    mem_csv = os.path.join(work, f"judge_{model_flag}_memory.csv")
    serve.full_judge(pred, data, mem_csv, progress=False, canvas_cache="off")
    rows = judge_csv_rows(out_csv), judge_csv_rows(mem_csv)
    if rows[0] != rows[1] or len(rows[0]) != NUM_CLASSES * PER_CLASS + 1:
        raise AssertionError(f"serve --model {model_flag} from the export "
                             "disagrees with the trained model")
    print(f"serve --model {model_flag} --weights <export> --full: "
          f"{len(rows[0]) - 1} predictions, equal to a Predictor on the "
          "trained model")


def fit_plan(cfg, data: str) -> tuple[int, int]:
    """Train steps and val batches of one epoch of ``cfg`` on ``data``."""
    from touhouimageclassification_tpu_torch.data import (random_split,
                                                         scan_image_folder)

    tr_idx, va_idx = random_split(len(scan_image_folder(data)),
                                  cfg.train_split, cfg.seed)
    b = cfg.global_batch_size
    steps, val = len(tr_idx) // b, -(-len(va_idx) // b)
    return (min(steps, cfg.limit_train_batches or steps),
            min(val, cfg.limit_val_batches or val))


def phase_resmoe_cli(torch, attn, serve, data: str, work: str, dev) -> dict:
    """Phase 15, the resmoe launcher for one epoch, --transform, serve,
    filter and the accuracy sweep's ResMoE row on the export. Returns K1's
    and K2's launches by path."""
    from touhouimageclassification_tpu_torch.analysis import acc
    from touhouimageclassification_tpu_torch.config import PRESETS
    from touhouimageclassification_tpu_torch.infer import filter as filt
    from touhouimageclassification_tpu_torch.train import resmoe

    cwd = os.getcwd()
    os.chdir(work)
    cfg = dataclasses.replace(PRESETS["resmoe"], data_dir=data, seed=SEED)
    steps, val_batches = fit_plan(cfg, data)
    argv = ["--data-dir", data, "--max-epochs", "1", "--seed", str(SEED),
            "--device", "cuda"]
    launches = {}
    zero_counts(attn)
    t0 = time.perf_counter()
    trainer = resmoe.main([*argv, "--no-resume"])
    secs = time.perf_counter() - t0
    launches["resmoe_fit"] = read_counts(
        attn, f"resmoe fit, 1 epoch: {steps} steps + {val_batches} val "
        "batches", (MIX_K1 * (steps + val_batches), MIX_K1 * steps))
    records = [r for r in fit_records("log", cfg.train_id) if "epoch" in r]
    if len(records) != 1 or not all(np.isfinite(records[0][k]) for k in (
            "train_loss", "val_loss", "val_acc", "balance_loss")):
        raise AssertionError(f"resmoe fit records {records}")
    print(f"resmoe fit: {secs:.2f} s with the model build; record "
          f"{json.dumps(records[0])}")
    export = os.path.join(work, "export_resmoe")
    resmoe.main([*argv, "--transform", export])
    shutil.rmtree("checkpoint")
    forwards = -(-NUM_CLASSES * PER_CLASS // 64)
    zero_counts(attn)
    export_matches_predictor(serve, "resmoe", export, trainer.state.model,
                             data, work, dev)
    launches["resmoe_serve_export"] = read_counts(
        attn, "serve --model resmoe from the export, and the Predictor",
        (2 * MIX_K1 * forwards, 0))
    del trainer
    torch.cuda.empty_cache()

    zero_counts(attn)
    judge_csv = os.path.join(work, "filter_resmoe.csv")
    kept_dir = os.path.join(work, "filtered_resmoe")
    filt.main(["--model", "resmoe", "--weights", export, "--image", data,
               "-od", kept_dir, "--csv-file", judge_csv, "--canvas-cache",
               "off"])
    launches["resmoe_filter"] = read_counts(
        attn, "filter --model resmoe", (MIX_K1 * forwards, 0))
    with open(judge_csv, newline="") as f:
        correct = sum(r["correct"] == "True" for r in csv.DictReader(f))
    kept = sum(len(files) for _, _, files in os.walk(kept_dir))
    if kept != correct:
        raise AssertionError(f"filter kept {kept}, correct rows {correct}")

    zero_counts(attn)
    row = next(r for r in acc.MODELS if r[0] == "ResMoE")
    rows = acc.run_sweep([(row[0], row[1], export)], test_dir=data,
                         result_dir=os.path.join(work, "result_resmoe"),
                         data_dir=data, device="cuda")
    launches["resmoe_acc"] = read_counts(
        attn, "acc.run_sweep, the ResMoE row", (MIX_K1 * forwards, 0))
    print(f"filter --model resmoe kept {kept} (the judge's correct rows); "
          f"acc.run_sweep ResMoE row {rows}")
    if rows[0]["status"] != "ok" or not 0 <= rows[0]["acc"] <= 1:
        raise AssertionError("acc sweep, the ResMoE row")
    os.chdir(cwd)
    return launches


def phase_treevit(torch, attn, serve, create_model, Trainer, data: str,
                  work: str, mean, std, dev) -> tuple[dict, dict]:
    """Phase 15, TreeViT: a dense-eval forward and serving, the treevit
    preset's capacity-dispatch train step and its rate, then the staged
    launcher (root -> sons -> full, one epoch each), --transform and serve.
    Returns the numbers and K1's / K2's launches by path."""
    from touhouimageclassification_tpu_torch.config import PRESETS
    from touhouimageclassification_tpu_torch.data import scan_image_folder
    from touhouimageclassification_tpu_torch.train import treevit
    from touhouimageclassification_tpu_torch.train.tasks import TreeFullTask

    launches = {}
    model = create_model("treevit", num_classes=NUM_CLASSES, device=dev,
                         seed=SEED).eval()
    rng = np.random.default_rng(SEED + 17)
    imgs = rng.integers(0, 256, (64, 224, 224, 3), dtype=np.uint8)
    with torch.inference_mode():
        zero_counts(attn)
        combined, choice, kept = model(normalised(torch, imgs[:8], mean, std,
                                                  dev))
        read_counts(attn, "TreeViT dense-eval forward, B 8", (MIX_K1, 0))
    if not (combined.shape == (8, NUM_CLASSES) and choice.shape == (8, 8)
            and torch.isfinite(combined).all() and bool((kept == 1).all())):
        raise AssertionError("TreeViT dense-eval forward")
    numbers, launches["treevit_serve"] = mixture_serve(
        torch, attn, serve, model, imgs, mean, std, dev, "TreeViT dense-eval")
    del model
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(PRESETS["treevit"], data_dir=data, seed=SEED)
    index = scan_image_folder(data)
    cmap = treevit.make_class_to_category(
        treevit.default_category_map(index.classes, 8), index.class_to_idx)
    tree = create_model("treevit", num_classes=NUM_CLASSES,
                        param_dtype="float32", device=dev, seed=SEED)
    trainer = Trainer(cfg, model=tree, task=TreeFullTask(tree.cfg, cmap),
                      device=dev)
    trainer.init_state()
    batches = staged_batches(trainer, 4, SEED + 18)
    train, launches["treevit_train"] = train_numbers(
        torch, attn, trainer, batches,
        "TreeViT train (treevit preset, full stage, capacity dispatch)",
        (MIX_K1, MIX_K1), 8, dev)
    numbers.update(train)
    del trainer, tree, batches
    torch.cuda.empty_cache()

    cwd = os.getcwd()
    os.chdir(work)
    steps, val_batches = fit_plan(cfg, data)
    argv = ["--data-dir", data, "--max-epochs", "1", "--seed", str(SEED),
            "--device", "cuda"]
    zero_counts(attn)
    t0 = time.perf_counter()
    trainer = treevit.main([*argv, "--no-resume"])
    secs = time.perf_counter() - t0
    # the backward runs through the members in the loss's graph: the root
    # stage's loss reads the root only, the teacher-forced sons stage's the
    # sons only, the full stage's all nine
    launches["treevit_fit"] = read_counts(
        attn, f"treevit --stage all, 1 epoch a stage: {steps} steps + "
        f"{val_batches} val batches each",
        (3 * MIX_K1 * (steps + val_batches),
         steps * (VIT_B_LAYERS + (MIX_MEMBERS - 1) * VIT_B_LAYERS + MIX_K1)))
    for stage in ("root", "sons", "full"):
        records = [r for r in fit_records("log", f"{cfg.train_id}_{stage}")
                   if "epoch" in r]
        if len(records) != 1 or not all(np.isfinite(records[0][k]) for k in (
                "train_loss", "val_loss", "val_acc")):
            raise AssertionError(f"treevit {stage} records {records}")
        print(f"treevit stage {stage}: {json.dumps(records[0])}")
    print(f"treevit --stage all: {secs:.2f} s with the model build")
    export = os.path.join(work, "export_treevit")
    treevit.main([*argv, "--stage", "full", "--transform", export])
    shutil.rmtree("checkpoint")
    export_matches_predictor(serve, "treevit", export, trainer.state.model,
                             data, work, dev)
    del trainer
    torch.cuda.empty_cache()
    os.chdir(cwd)
    return numbers, launches


def phase_vit_b_kernels(torch, attn) -> list[dict]:
    """Phase 15, K1 and K2 alone at ViT-B's width (N 197, C 768, 12 heads,
    bf16) and the mixtures' batches: against their plain versions, timed
    around one launch (``ms``) and as device time (``device_ms``), beside
    SDPA and its autograd backward and the bytes bound."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    n, c, h = 197, 768, 12
    rows = []
    for b in VIT_B_BATCHES:
        qkv = torch.randn(b, n, 3 * c, generator=gen, device=dev).to(
            torch.bfloat16)
        g = torch.randn(b, n, c, generator=gen, device=dev).to(torch.bfloat16)
        views = qkv.view(b, n, 3, h, c // h).unbind(2)
        leaf = qkv.detach().requires_grad_()
        with torch.inference_mode():
            out = on_route(attn, torch.bfloat16, 1,
                           lambda: attn.slab_attention(qkv, h))
            err = check_close(torch, f"K1 vs plain, ViT-B B {b}", out,
                              attn.slab_attention_reference(qkv, h),
                              torch.bfloat16)
            fwd = dict(
                batch=b, max_abs_err=err,
                ms=cuda_ms(lambda: attn.slab_attention(qkv, h)),
                device_ms=device_ms(lambda: attn.slab_attention(qkv, h)),
                plain_ms=cuda_ms(
                    lambda: attn.slab_attention_reference(qkv, h)),
                library_ms=cuda_ms(lambda: sdpa(torch, *views)),
                library_device_ms=device_ms(lambda: sdpa(torch, *views)))
            out = on_route(attn, torch.bfloat16, 1,
                           lambda: attn.slab_attention_backward(qkv, g, h))
            err = check_close(torch, f"K2 vs plain, ViT-B B {b}", out,
                              attn.slab_attention_backward_reference(
                                  qkv, g, h), torch.bfloat16)
            bwd = dict(
                batch=b, max_abs_err=err,
                ms=cuda_ms(lambda: attn.slab_attention_backward(qkv, g, h)),
                device_ms=device_ms(
                    lambda: attn.slab_attention_backward(qkv, g, h)),
                plain_ms=cuda_ms(
                    lambda: attn.slab_attention_backward_reference(qkv, g,
                                                                   h)))
        bwd["library_ms"] = sdpa_backward_ms(
            torch, (leaf,), leaf.view(b, n, 3, h, c // h).unbind(2), g)
        for rec, backward in ((fwd, False), (bwd, True)):
            rec["bound_ms"], rec["bound_by"] = attention_bound(
                b, n, c, h, torch.bfloat16, backward)
        print(f"ViT-B bf16 B {b} (N 197, C 768, H 12; {card_line()}): K1 "
              f"{json.dumps(fwd)}; K2 {json.dumps(bwd)}")
        rows.append((fwd, bwd))
    return rows


def phase_mixtures(torch, attn, serve, create_model, Trainer, data: str,
                   work: str, mean, std, dev) -> tuple[dict, dict, list]:
    """Phase 15 (see the module docstring). Returns the numbers by family,
    K1's and K2's launches by path, and the ViT-B kernel rows."""
    numbers, launches = {}, {}
    numbers["ResMoE"], launches["resmoe_serve"] = phase_resmoe_serve(
        torch, attn, serve, create_model, mean, std, dev)
    train, launches["resmoe_train"] = phase_resmoe_train(
        torch, attn, create_model, Trainer, data, dev)
    numbers["ResMoE"].update(train)
    launches.update(phase_resmoe_cli(torch, attn, serve, data, work, dev))
    numbers["TreeViT"], tree_launches = phase_treevit(
        torch, attn, serve, create_model, Trainer, data, work, mean, std, dev)
    launches.update(tree_launches)
    card = card_line()
    for family, values in numbers.items():
        print(f"{family} at full width ({card}): "
              + ", ".join(f"{k} {v:.3f}" for k, v in values.items()))
    return numbers, launches, phase_vit_b_kernels(torch, attn)


# Phase 16, multi-GPU on the one card. (a) one NCCL rank through the ntrain
# CLI's multi-process flags; (b) two ranks on the card over gloo (NCCL takes
# one rank a device), which all-reduces CUDA tensors: a ViT-L data-parallel
# step against one process on the global batch, and ResMoE with its experts
# split over the two ranks (4 ViT-B experts a rank, the gate replicated).
EP_K1 = (MIX_MEMBERS // 2 + 1) * VIT_B_LAYERS   # a rank's 4 experts + gate
DP_K1 = 24                                      # ViT-L's layers, a step
DP_STEPS = 2
DP_BATCH = 16
# The DP steps are checked in f32 compute without TF32 (the bf16 run on the
# kernels' mma route is timed only: bf16 roundings hide faults at the
# global batch's scale, and AdamW moves a parameter by about lr a step
# whatever its gradient). Held against one process at 16: the gradients the
# optimizer receives at step 1 (after the all-reduce), the largest
# ||g - g_one|| / ||g_one|| of a leaf; each step's loss; the parameters after
# the steps, ||p - p_one|| / ||p_one - p_init|| over all of them (a max
# |diff| would not do: where a gradient element is near zero, a rounding can
# flip its sign, and AdamW then moves the two runs 2 lr apart there). The
# key biases are left out of the parameters: softmax is invariant to them,
# so their gradient is rounding noise that AdamW scales up to lr. Each limit
# lies between this run's reading and that of planted faults, which the
# script runs too and requires to fail: a rank's own gradients before the
# all-reduce (no all-reduce), and the mixup rolled within each rank's rows
# (a local roll). Readings on the H100 (NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md §6), gradient / step-1 loss / parameters: 2 ranks 2.0e-6 / 8.7e-8
# / 1.7e-4; a rank's gradients before the all-reduce 1.05; local roll 0.20
# / 3.1e-4 / 0.32.
DP_GRAD_RTOL = 1e-3
DP_LOSS_RTOL = 1e-5
DP_PARAM_RTOL = 1e-2
# Expert parallelism runs each expert at the same batch as one process and
# adds its logits to zeros: the logits are expected equal; the gradient
# norm adds the experts' squares in another order.
EP_LOGIT_ATOL = 1e-3
EP_NORM_RTOL = 1e-4
EP_FIT_STEPS = 6
EP_SIGTERM_AFTER = 3

NCCL_PROBE = (
    "import os, sys, torch, torch.distributed as d; "
    "d.init_process_group('nccl', init_method='file://' + sys.argv[3], "
    "world_size=2, rank=int(sys.argv[1])); torch.cuda.set_device(0); "
    "t = torch.ones(1, device='cuda:0'); d.all_reduce(t); "
    "torch.cuda.synchronize(); print('all_reduce', t.item())")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    for name in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                 "LOCAL_RANK", "JAX_COORDINATOR_ADDRESS",
                 "COORDINATOR_ADDRESS"):
        env.pop(name, None)
    return env


def run_ranks(argv_of, world: int, timeout: float) -> list | None:
    """Start ``world`` processes (``argv_of(rank)``) and wait for all;
    returns (rc, stdout, stderr) each, or None when they outlast
    ``timeout`` (then they are killed). Every process is ended before this
    returns."""
    procs = [subprocess.Popen(argv_of(r), cwd=ROOT, env=child_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    out = []
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            o, e = p.communicate(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            return None
        out.append((p.returncode, o, e))
    return out


def spawn_ranks(mode: str, world: int, work: str, data: str,
                timeout: float = 600) -> list[dict]:
    """This script's ``--rank`` entry on ``world`` processes, gloo on
    cuda:0; each rank's result is ``<work>/<mode>_rank<r>.json``."""
    results = run_ranks(lambda r: [sys.executable, os.path.abspath(__file__),
                                   "--rank", mode, str(r), str(world), work,
                                   data], world, timeout)
    if results is None:
        raise AssertionError(f"{mode} ranks timed out after {timeout} s")
    for r, (rc, o, e) in enumerate(results):
        if rc != 0:
            raise AssertionError(f"{mode} rank {r} exited {rc}:\n{o[-3000:]}"
                                 f"\n{e[-6000:]}")
    outs = []
    for r in range(world):
        with open(os.path.join(work, f"{mode}_rank{r}.json")) as f:
            outs.append(json.load(f))
    return outs


def nccl_duplicate_probe(work: str) -> str:
    """Two NCCL ranks on the one card: NCCL refuses them ("Duplicate GPU
    detected"). Returns what the probe printed."""
    rdzv = os.path.join(work, "nccl_probe_rdzv")
    results = run_ranks(lambda r: [sys.executable, "-c", NCCL_PROBE, str(r),
                                   "2", rdzv], 2, 120)
    if results is None:
        print("NCCL probe, two ranks on cuda:0: no answer in 120 s (killed)")
        return "hung"
    text = " ".join(o + e for _, o, e in results)
    verdict = ("refused" if "Duplicate GPU" in text else
               "accepted" if all(rc == 0 for rc, _, _ in results) else
               "failed")
    print(f"NCCL probe, two ranks on cuda:0: exit codes "
          f"{[rc for rc, _, _ in results]}, {verdict}"
          f"{' (Duplicate GPU detected)' if verdict == 'refused' else ''}")
    if verdict == "failed":
        print("NCCL probe output:", text[-1500:])
    return verdict


def dp_batches(n: int, b: int) -> list[dict]:
    rng = np.random.default_rng(SEED + 160)
    return [{"image": rng.integers(0, 256, (b, 256, 256, 3), dtype=np.uint8),
             "label": rng.integers(0, NUM_CLASSES, b).astype(np.int32),
             "mask": np.ones(b, bool)} for _ in range(n)]


def ep_batch(b: int = 4) -> dict:
    rng = np.random.default_rng(SEED + 161)
    return {"image": rng.integers(0, 256, (b, 224, 224, 3), dtype=np.uint8),
            "label": rng.integers(0, NUM_CLASSES, b).astype(np.int32),
            "mask": np.ones(b, bool)}


def vit_l_trainer(torch, create_model, Trainer, cfg, dev,
                  compute_dtype: str = "bfloat16"):
    model = create_model("vit-large", num_classes=NUM_CLASSES,
                         compute_dtype=compute_dtype, param_dtype="float32",
                         device=dev, seed=SEED)
    trainer = Trainer(cfg, model=model, device=dev)
    trainer.init_state(4)
    return trainer


def dp_f32_steps(torch, create_model, Trainer, data: str, dev,
                 local_roll: bool = False) -> dict:
    """ViT-L nvit in f32 compute, DP_STEPS steps of ``dp_batches`` on this
    process's rows (all of them in one process): each step's loss; the
    first step's gradients as the optimizer takes them (``grads``; on a
    rank after the all-reduce) and, on a rank, before the all-reduce
    (``local``); the parameters after the steps. ``local_roll`` plants a
    fault: the mixup rolls each rank's rows alone."""
    from touhouimageclassification_tpu_torch.ops import mixup
    from touhouimageclassification_tpu_torch.parallel import collectives

    trainer = vit_l_trainer(torch, create_model, Trainer,
                            nvit_config(data, global_batch_size=DP_BATCH),
                            dev, "float32")
    model, state = trainer.model, trainer.state
    index, count = trainer._input_view
    b = DP_BATCH // count
    names = {id(p): n for n, p in model.named_parameters()}
    grads, local = {}, {}
    update, average = state.optimizer.update, collectives.average_gradients_
    roll = mixup.roll_rows
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def recording_update(gs):
        if not grads:
            grads.update({names[id(p)]: g.detach().clone()
                          for p, g in zip(state.optimizer.params, gs)})
        update(gs)

    def recording_average(gs, *args, **kw):
        if not local:
            by_grad = {id(p.grad): n for n, p in model.named_parameters()
                       if p.grad is not None}
            local.update({by_grad[id(g)]: g.detach().clone() for g in gs})
        average(gs, *args, **kw)

    state.optimizer.update = recording_update
    collectives.average_gradients_ = recording_average
    if local_roll:
        mixup.roll_rows = lambda x: x.roll(1, dims=0)
    try:
        losses = [trainer.train_step(state, trainer.stage(
            {k: v[index * b:(index + 1) * b] for k, v in batch.items()}))[
            "loss"] for batch in dp_batches(DP_STEPS, DP_BATCH)]
    finally:
        collectives.average_gradients_, mixup.roll_rows = average, roll
    del state.optimizer.update   # the recording closure holds the state
    params = {k: v.detach() for k, v in model.state_dict().items()}
    moved = sum(float(without_key_bias(k, v - init[k]).square().sum())
                for k, v in params.items()) ** 0.5
    return {"loss": losses, "grads": grads, "local": local, "params": params,
            "moved": moved}


def without_key_bias(name: str, t):
    """``t`` with the key bias of an ``attn.qkv.bias`` (its middle third)
    zeroed."""
    if name.endswith("attn.qkv.bias"):
        c = t.shape[0] // 3
        t = t.clone()
        t[c:2 * c] = 0
    return t


def dp_readings(torch, run: dict, ref: dict, dev) -> dict:
    """A run of :func:`dp_f32_steps` against the one process's (``ref``:
    its ``grad/`` and ``param/`` tensors, its losses and how far its
    parameters moved): the largest relative gradient difference of a leaf,
    after and before the all-reduce; each step's relative loss difference;
    the parameters' difference relative to how far they moved, and the
    largest element of it, key biases left out."""
    def grad_rel(grads):
        worst = 0.0
        for name, g in grads.items():
            want = ref["tensors"][f"grad/{name}"].to(dev)
            worst = max(worst, ((g - want).norm() / want.norm().clamp_min(
                1e-30)).item())
        return worst

    sq, largest = 0.0, 0.0
    for k, v in run["params"].items():
        d = without_key_bias(k, v - ref["tensors"][f"param/{k}"].to(dev))
        sq += float(d.square().sum())
        largest = max(largest, d.abs().max().item())
    return {"grad_rel": grad_rel(run["grads"]),
            "local_grad_rel": grad_rel(run["local"]) if run["local"] else None,
            "loss_rel": [abs(a - b) / abs(b) for a, b in
                         zip(run["loss"], ref["loss"], strict=True)],
            "param_rel": sq ** 0.5 / ref["moved"], "param_abs": largest}


def resmoe_cfg(data: str, work: str, shards: int):
    from touhouimageclassification_tpu_torch.config import (PRESETS,
                                                            CheckpointConfig,
                                                            MeshConfig)

    return dataclasses.replace(
        PRESETS["resmoe"], data_dir=data, seed=SEED, max_epochs=1,
        limit_train_batches=EP_FIT_STEPS, limit_val_batches=2,
        mesh=MeshConfig(num_expert_shards=shards),
        checkpoint=CheckpointConfig(directory=os.path.join(work, "ep_ckpt"),
                                    async_save=False, monitor="val_loss",
                                    mode="min"),
        log_dir=os.path.join(work, "ep_log"))


def resmoe_trainer(create_model, Trainer, cfg, dev):
    from touhouimageclassification_tpu_torch.train.tasks import MoETask

    model = create_model("resmoe", num_classes=NUM_CLASSES,
                         param_dtype="float32", device=dev, seed=SEED)
    trainer = Trainer(cfg, model=model, task=MoETask(model.cfg), device=dev)
    trainer.init_state(4)
    return trainer


def moe_logits(torch, trainer, batch) -> "torch.Tensor":
    from touhouimageclassification_tpu_torch.parallel import collectives

    staged = trainer.stage(batch)
    with torch.no_grad(), collectives.use_mesh(trainer.mesh):
        images = trainer.eval_transform(staged["image"].float() / 255.0)
        out = trainer.task.forward(trainer.state.model, images, staged, False)
    return trainer.task.logits(out).float()


def rank_dp(torch, attn, rank: int, world: int, work: str, data: str,
            dev) -> dict:
    """One rank of the ViT-L data-parallel steps: this rank's 8 rows of
    each global batch of 16, the nvit recipe, bf16 (timed; the gradient
    all-reduce timed apart), then the f32 check (rank 0 reads it against
    the one process's steps) and its planted local-roll fault."""
    from safetensors.torch import load_file

    from touhouimageclassification_tpu_torch.models import create_model
    from touhouimageclassification_tpu_torch.parallel import collectives
    from touhouimageclassification_tpu_torch.train.trainer import Trainer

    reduce_s = []
    average = collectives.average_gradients_

    def timed_average(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        average(*args, **kw)
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t0)

    collectives.average_gradients_ = timed_average
    trainer = vit_l_trainer(torch, create_model, Trainer,
                            nvit_config(data, global_batch_size=DP_BATCH),
                            dev)
    index, count = trainer._input_view
    b = DP_BATCH // count
    state = trainer.state
    metrics, step_s = [], []
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(attn)
    for batch in dp_batches(DP_STEPS, DP_BATCH):
        local = {k: v[index * b:(index + 1) * b] for k, v in batch.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(trainer.train_step(state, trainer.stage(local)))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = (attn.launches, attn.bwd_launches)
    routes = dict(attn.route_launches)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    grad_bytes = sum(p.numel() * 4 for p in state.optimizer.params)
    collectives.average_gradients_ = average
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    ref = None
    if rank == 0:
        with open(os.path.join(work, "dp_ref.json")) as f:
            ref = json.load(f)
        ref["tensors"] = load_file(os.path.join(work, "dp_ref.safetensors"))
    readings = {}
    torch.cuda.reset_peak_memory_stats(dev)
    for name, fault in (("sound", False), ("local_roll", True)):
        run = dp_f32_steps(torch, create_model, Trainer, data, dev, fault)
        if ref is not None:
            readings[name] = dp_readings(torch, run, ref, dev)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return {"view": [index, count], "metrics": metrics, "launches": launches,
            "routes": routes, "step_s": step_s, "allreduce_s": reduce_s,
            "grad_bytes": grad_bytes, "peak_gib": peak, "f32": readings,
            "f32_peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}


def rank_ep(torch, attn, rank: int, world: int, work: str, data: str,
            dev) -> dict:
    """One rank of ResMoE under pure expert parallelism: logits and one
    step on a batch of 4; a fit that SIGTERM (to rank 1 only) stops after
    step 3, saving a mid-epoch checkpoint of both ranks' experts, and its
    resumed run to the end of the epoch; the logits after it."""
    import signal as signal_mod

    from touhouimageclassification_tpu_torch.data import (image_loader,
                                                         random_split,
                                                         scan_image_folder)
    from touhouimageclassification_tpu_torch.models import create_model
    from touhouimageclassification_tpu_torch.train.trainer import Trainer

    cfg = resmoe_cfg(data, work, world)
    trainer = resmoe_trainer(create_model, Trainer, cfg, dev)
    batch = ep_batch()
    logits = moe_logits(torch, trainer, batch)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(attn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = trainer.train_step(trainer.state, trainer.stage(batch))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = (attn.launches, attn.bwd_launches)
    routes = dict(attn.route_launches)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    canvas = trainer.out_size
    del trainer
    torch.cuda.empty_cache()

    index = scan_image_folder(data)
    tr, va = random_split(len(index), cfg.train_split, cfg.seed)

    def loaders():
        return (image_loader(index, tr, batch_size=cfg.global_batch_size,
                             canvas=canvas, shuffle=True, seed=cfg.seed),
                image_loader(index, va, batch_size=cfg.global_batch_size,
                             canvas=canvas, drop_last=False))

    fits = []
    for run in ("preempted", "resumed"):
        trainer = resmoe_trainer(create_model, Trainer, cfg, dev)
        if run == "preempted" and rank == 1:
            plain = trainer.train_step

            def train_step(state, b, plain=plain):
                out = plain(state, b)
                if state.step == EP_SIGTERM_AFTER:
                    os.kill(os.getpid(), signal_mod.SIGTERM)
                return out

            trainer.train_step = train_step
        history = trainer.fit(*loaders(), resume=True)
        fits.append({"step": trainer.state.step, "history": history})
        if run == "resumed":
            after = moe_logits(torch, trainer, batch)
        del trainer
        torch.cuda.empty_cache()
    return {"logits": logits.cpu().tolist(), "step": step,
            "launches": launches, "routes": routes,
            "step_s": step_s, "peak_gib": peak, "fits": fits,
            "logits_after_fit": after.cpu().tolist()}


def rank_main(args: list[str]) -> int:
    """``chip_smoke.py --rank <dp|ep> <rank> <world> <work> <data>``: one
    rank of phase 16(b), gloo over CUDA tensors on cuda:0."""
    import torch

    from touhouimageclassification_tpu_torch.ops import attention as attn
    from touhouimageclassification_tpu_torch.parallel.dist import (
        initialize_distributed, shutdown_distributed)

    mode, rank, world, work, data = (args[0], int(args[1]), int(args[2]),
                                     args[3], args[4])
    dev = torch.device("cuda", 0)
    # f32 as in the parent process, whose phase 1 turned TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(f"file://{work}/rdzv_{mode}", world, rank,
                           backend="gloo", device=dev, timeout=600)
    out = {"dp": rank_dp, "ep": rank_ep}[mode](torch, attn, rank, world,
                                               work, data, dev)
    with open(os.path.join(work, f"{mode}_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    shutdown_distributed()
    return 0


def phase_nccl_rank(torch, attn, data: str, work: str, layers: int):
    """(a) ``ntrain`` (nvit, ViT-L, batch 8, 1 epoch from the seeded scratch
    init) without distribution, then as one NCCL rank through
    --coordinator/--num-processes/--process-id: every step's loss equal bit
    for bit, K1/K2 ``layers`` a step on the NCCL rank. Returns its K1/K2
    launches."""
    from touhouimageclassification_tpu_torch.parallel import dist
    from touhouimageclassification_tpu_torch.train import ntrain
    from touhouimageclassification_tpu_torch.train.trainer import Trainer

    steps, val = fit_plan(nvit_config(data, max_epochs=1), data)
    argv = ["--data-dir", data, "--max-epochs", "1", "--seed", str(SEED),
            "--batch-size", "8", "--no-pretrained", "--no-resume",
            "--device", "cuda"]
    losses: dict[str, list[float]] = {}
    plain_step = Trainer.train_step
    for run, flags in (("local", []), ("nccl", [
            "--coordinator", f"127.0.0.1:{free_port()}", "--num-processes",
            "1", "--process-id", "0"])):
        run_losses = losses[run] = []

        def recording(self, state, batch, run_losses=run_losses):
            m = plain_step(self, state, batch)
            run_losses.append(m["loss"])
            return m

        Trainer.train_step = recording
        cwd = os.getcwd()
        run_dir = os.path.join(work, run)
        os.makedirs(run_dir, exist_ok=True)
        os.chdir(run_dir)
        zero_counts(attn)
        t0 = time.perf_counter()
        try:
            trainer = ntrain.main([*argv, *flags])
        finally:
            Trainer.train_step = plain_step
            os.chdir(cwd)
        secs = time.perf_counter() - t0
        launches = (attn.launches, attn.bwd_launches)
        backend = (torch.distributed.get_backend()
                   if torch.distributed.is_initialized() else None)
        print(f"phase 16(a) ntrain {run}: world {dist.world()}, backend "
              f"{backend}, device {trainer.device}, {len(run_losses)} steps, "
              f"{secs:.2f} s, K1/K2 launches {launches}")
        del trainer
        dist.shutdown_distributed()
        torch.cuda.empty_cache()
        if run == "nccl":
            if backend != "nccl":
                raise AssertionError(f"16(a): backend {backend}")
            read_counts(attn, "phase 16(a) NCCL rank ntrain epoch",
                        (layers * (steps + val), layers * steps))
    if losses["nccl"] != losses["local"] or len(losses["nccl"]) != steps:
        raise AssertionError(f"16(a): losses differ: {losses}")
    print(f"phase 16(a): {steps} step losses bit-equal with and without one "
          f"NCCL rank, first {losses['nccl'][0]!r}, last "
          f"{losses['nccl'][-1]!r}")
    return launches


def phase_dp(torch, attn, create_model, Trainer, data: str, work: str,
             dev) -> dict:
    """(b) ViT-L nvit, 2 ranks x 8 on the card against one process of 16:
    the bf16 steps timed on both; the f32 check (gradients, losses,
    parameters) within its limits, which the planted faults exceed."""
    from safetensors.torch import save_file

    one = dp_f32_steps(torch, create_model, Trainer, data, dev)
    save_file({**{f"grad/{k}": v.cpu() for k, v in one["grads"].items()},
               **{f"param/{k}": v.cpu() for k, v in one["params"].items()}},
              os.path.join(work, "dp_ref.safetensors"))
    with open(os.path.join(work, "dp_ref.json"), "w") as f:
        json.dump({"loss": one["loss"], "moved": one["moved"]}, f)
    del one
    gc.collect()
    trainer = vit_l_trainer(torch, create_model, Trainer,
                            nvit_config(data, global_batch_size=DP_BATCH),
                            dev)
    one_s = []
    for batch in dp_batches(DP_STEPS, DP_BATCH):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(trainer.state, trainer.stage(batch))
        torch.cuda.synchronize()
        one_s.append(time.perf_counter() - t0)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    outs = spawn_ranks("dp", 2, work, data)
    for r, o in enumerate(outs):
        if o["launches"] != [DP_K1 * DP_STEPS] * 2 or \
                o["routes"] != {"mma": 2 * DP_K1 * DP_STEPS, "simt": 0}:
            raise AssertionError(f"dp rank {r}: K1/K2 {o['launches']} "
                                 f"routes {o['routes']}")
        print(f"phase 16(b) ViT-L DP rank {r} of 2 (gloo, bf16, batch "
              f"{DP_BATCH // 2} of {DP_BATCH}): K1/K2 launches "
              f"{o['launches']}, step s {o['step_s']}, gradient all-reduce "
              f"s {o['allreduce_s']} ({o['grad_bytes'] / 2 ** 30:.2f} GiB "
              f"f32), peak memory {o['peak_gib']:.2f} GiB (f32 check "
              f"{o['f32_peak_gib']:.2f} GiB)")
    if outs[0]["metrics"] != outs[1]["metrics"]:
        raise AssertionError("dp: the ranks fetched different metrics")
    share = [a / s for a, s in zip(outs[0]["allreduce_s"],
                                   outs[0]["step_s"])]
    print(f"phase 16(b) DP bf16: one process at {DP_BATCH}: step s {one_s}; "
          f"gradient all-reduce share of a rank's step: {share}")
    sound, roll = outs[0]["f32"]["sound"], outs[0]["f32"]["local_roll"]
    print(f"phase 16(b) DP f32 check against one process at {DP_BATCH} "
          f"(limits: gradient {DP_GRAD_RTOL:g} relative a leaf, loss "
          f"{DP_LOSS_RTOL:g} relative, parameters {DP_PARAM_RTOL:g} of "
          f"their move): "
          f"2 ranks {sound}; planted faults: no all-reduce, gradient "
          f"{sound['local_grad_rel']:.3e}; local roll {roll}")
    if sound["grad_rel"] > DP_GRAD_RTOL or \
            max(sound["loss_rel"]) > DP_LOSS_RTOL or \
            sound["param_rel"] > DP_PARAM_RTOL:
        raise AssertionError(f"dp f32: 2 ranks apart from one process "
                             f"{sound}")
    if sound["local_grad_rel"] <= DP_GRAD_RTOL or \
            roll["grad_rel"] <= DP_GRAD_RTOL or \
            max(roll["loss_rel"]) <= DP_LOSS_RTOL or \
            roll["param_rel"] <= DP_PARAM_RTOL:
        raise AssertionError(f"dp f32: the check did not see a planted "
                             f"fault: {sound}, {roll}")
    return {f"dp_rank{r}": o["launches"] for r, o in enumerate(outs)}


def phase_ep(torch, attn, serve, create_model, Trainer, data: str,
             work: str, dev) -> dict:
    """(b) ResMoE (8 ViT-B experts + gate, 120 classes, the resmoe preset)
    with 4 experts a rank on 2 ranks: logits and one step against one
    process; the SIGTERM to rank 1 alone stops both ranks at step 3, and
    the resumed run ends the epoch; one process restores the
    expert-sharded checkpoint, equals the ranks' logits and serves; then
    phase 17(c) on that save."""
    from touhouimageclassification_tpu_torch.train.checkpoint import \
        CheckpointManager

    outs = spawn_ranks("ep", 2, work, data)
    for r, o in enumerate(outs):
        if o["launches"] != [EP_K1, EP_K1] or \
                o["routes"] != {"mma": 2 * EP_K1, "simt": 0}:
            raise AssertionError(f"ep rank {r}: K1/K2 {o['launches']} "
                                 f"routes {o['routes']}")
        print(f"phase 16(b) ResMoE EP rank {r} of 2 (4 experts + gate): "
              f"K1/K2 launches {o['launches']} for one step, step "
              f"{o['step_s']:.3f} s, peak memory {o['peak_gib']:.2f} GiB")
        steps = [f["step"] for f in o["fits"]]
        if steps != [EP_SIGTERM_AFTER, EP_FIT_STEPS] or \
                o["fits"][0]["history"] or len(o["fits"][1]["history"]) != 1:
            raise AssertionError(f"ep rank {r} fits {o['fits']}")
    print(f"phase 16(b) SIGTERM to rank 1 only: both ranks stopped at step "
          f"{EP_SIGTERM_AFTER} and resumed to step {EP_FIT_STEPS}; record "
          f"{json.dumps(outs[0]['fits'][1]['history'][0])}")
    cfg = resmoe_cfg(data, work, 1)
    saved = os.path.join(cfg.checkpoint.directory, cfg.train_id, "1")
    files = sorted(os.listdir(saved))
    if "state.expert1.safetensors" not in files:
        raise AssertionError(f"ep checkpoint files {files}")
    trainer = resmoe_trainer(create_model, Trainer, cfg, dev)
    batch = ep_batch()
    logits = moe_logits(torch, trainer, batch)
    step = trainer.train_step(trainer.state, trainer.stage(batch))
    dlogit = (logits.cpu() - torch.tensor(outs[0]["logits"])).abs().max()
    rel = abs(step["grad_norm"] - outs[0]["step"]["grad_norm"]) / \
        step["grad_norm"]
    print(f"phase 16(b) EP vs one process: logits max |diff| {dlogit:.3e}, "
          f"loss {outs[0]['step']['loss']!r} vs {step['loss']!r}, grad norm "
          f"relative difference {rel:.3e}")
    if dlogit > EP_LOGIT_ATOL or rel > EP_NORM_RTOL or abs(
            step["loss"] - outs[0]["step"]["loss"]) > 1e-5 * abs(step["loss"]):
        raise AssertionError("ep vs one process")
    del trainer
    torch.cuda.empty_cache()
    trainer = resmoe_trainer(create_model, Trainer, cfg, dev)
    CheckpointManager(cfg.checkpoint, cfg.train_id).restore(trainer.state)
    restored = moe_logits(torch, trainer, batch)
    drest = (restored.cpu() - torch.tensor(
        outs[0]["logits_after_fit"])).abs().max()
    pred = serve.Predictor(model=trainer.state.model,
                           class_to_idx={str(i): i for i in
                                         range(NUM_CLASSES)},
                           image_size=trainer.out_size,
                           mean=np.asarray(trainer.cfg.augment.mean),
                           std=np.asarray(trainer.cfg.augment.std),
                           device=dev)
    served, _ = pred.predict_array(batch["image"])
    print(f"phase 16(b) expert-sharded checkpoint {files} restored in one "
          f"process at step {trainer.state.step}: logits max |diff| to the "
          f"ranks' {drest:.3e}; served classes {served.tolist()}")
    if trainer.state.step != EP_FIT_STEPS or drest > EP_LOGIT_ATOL or \
            served.tolist() != restored.argmax(-1).cpu().tolist():
        raise AssertionError("ep restore and serve")
    del pred
    extracted_k1 = phase_extract_resmoe(torch, attn, serve, trainer, saved,
                                        batch, restored, data, work, dev)
    del trainer
    torch.cuda.empty_cache()
    return {**{f"ep_rank{r}": o["launches"] for r, o in enumerate(outs)},
            "serve_extracted_resmoe": (extracted_k1, 0)}


def phase_multi_gpu(torch, attn, serve, create_model, Trainer, data: str,
                    work: str, layers: int, dev) -> dict:
    """Phase 16; returns K1's and K2's launches by path (per rank)."""
    launches = {"ntrain_nccl1": phase_nccl_rank(torch, attn, data, work,
                                                layers)}
    probe = nccl_duplicate_probe(work)
    print(f"phase 16(b) two ranks on one card: NCCL {probe}; the ranks use "
          "gloo on CUDA tensors")
    launches.update(phase_dp(torch, attn, create_model, Trainer, data, work,
                             dev))
    launches.update(phase_ep(torch, attn, serve, create_model, Trainer, data,
                             work, dev))
    return launches


# ---------------------------------------------------------------------------
# phase 17: the weight-loading route (extract_ckpt, convert, the meta-less
# serve of bare params) and the augmentation grids
# ---------------------------------------------------------------------------

def same_bits(torch, a, b) -> bool:
    """``a`` and ``b`` hold the same dtype, shape and bytes."""
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8)))


def judge_rows(path: str) -> list[list[str]]:
    with open(path, newline="") as f:
        return list(csv.reader(f))


def serve_judge(attn, serve, model_flag: str, weights: str, data: str,
                out_csv: str, k1_per_forward: int, what: str
                ) -> tuple[int, float]:
    """``serve --full`` (no canvas cache) from ``weights`` with K1 counted
    from 0: ``k1_per_forward`` launches a judge bucket, all on ``mma``.
    Returns K1's launches and the seconds."""
    forwards = -(-NUM_CLASSES * PER_CLASS // serve.BUCKETS[-1])
    zero_counts(attn)
    t0 = time.perf_counter()
    serve.main(["--model", model_flag, "--weights", weights, "--image", data,
                "--data-dir", data, "--output", out_csv, "--full",
                "--canvas-cache", "off"])
    secs = time.perf_counter() - t0
    k1, _ = read_counts(attn, f"{what}: serve --model {model_flag} --full, "
                        f"{forwards} forwards", (k1_per_forward * forwards, 0))
    return k1, secs


def phase_extract_vit(torch, epoch_dir: str, export: str, work: str) -> str:
    """Phase 17(a), on phase 11's fit before its checkpoint is deleted:
    ``python -m ...utils.extract_ckpt`` on the epoch directory; the
    extracted ``params.safetensors`` must equal the ``--transform``
    export's, tensor for tensor, bit for bit. Returns the extracted
    directory."""
    from safetensors.torch import load_file

    out = os.path.join(work, "extracted_vit_l")
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m",
         "touhouimageclassification_tpu_torch.utils.extract_ckpt", "--input",
         epoch_dir, "--output", out], cwd=ROOT, env=child_env(),
        capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if done.returncode or not done.stdout.startswith("Extracted to"):
        raise AssertionError(f"extract_ckpt exited {done.returncode}:\n"
                             f"{done.stdout[-2000:]}\n{done.stderr[-4000:]}")
    got = load_file(os.path.join(out, "params.safetensors"))
    want = load_file(os.path.join(export, "params.safetensors"))
    if got.keys() != want.keys() or not all(same_bits(torch, got[k], want[k])
                                            for k in want):
        raise AssertionError("the extracted params differ from the export's")
    print(f"phase 17(a) extract_ckpt (python -m, CPU) on the ViT-L fit's "
          f"epoch directory ({dir_bytes(epoch_dir)} bytes: params, AdamW "
          f"moments, meta): {dir_bytes(out)} bytes in {secs:.2f} s; "
          f"{len(want)} tensors bit-equal to the --transform export's "
          "params.safetensors")
    return out


def phase_serve_extracted_vit(attn, serve, create_model, extracted: str,
                              export: str, data: str, work: str, layers: int,
                              dev) -> int:
    """Phase 17(a), serve: the extracted ViT-L params meta-less (``--model
    vit-large``, the dataset's class map, mean and std), K1 24 a forward;
    its judge CSV (classes and confidences) must equal a Predictor's on the
    export's parameters with the dataset's mean and std. Returns K1's
    launches."""
    from safetensors.torch import load_file

    from touhouimageclassification_tpu_torch.data import get_class_to_idx
    from touhouimageclassification_tpu_torch.utils.mean_std import \
        get_mean_std

    out_csv = os.path.join(work, "judge_extracted_vit_l.csv")
    k1, secs = serve_judge(attn, serve, "vit-large", extracted, data, out_csv,
                           layers, "phase 17(a)")
    mean, std = get_mean_std(data, (224, 224))
    model = create_model("vit-large", num_classes=NUM_CLASSES, device=dev)
    model.load_state_dict(load_file(os.path.join(export,
                                                 "params.safetensors")))
    pred = serve.Predictor(model=model, class_to_idx=get_class_to_idx(data),
                           image_size=(224, 224), mean=mean, std=std,
                           device=dev)
    mem_csv = os.path.join(work, "judge_export_dataset_stats.csv")
    serve.full_judge(pred, data, mem_csv, progress=False, canvas_cache="off")
    rows = judge_rows(out_csv)
    if rows != judge_rows(mem_csv) or len(rows) != NUM_CLASSES * PER_CLASS + 1:
        raise AssertionError("serve from the extracted params disagrees with "
                             "a Predictor on the export's")
    print(f"phase 17(a) serve --model vit-large --weights <extracted> --full: "
          f"{len(rows) - 1} rows in {secs:.2f} s (model build, load, judge), "
          "classes and confidences equal to a Predictor on the export's "
          "parameters with the dataset's mean and std")
    del model, pred
    return k1


def phase_convert_vit(attn, serve, pth: str, data: str, work: str,
                      layers: int) -> dict:
    """Phase 17(b): ``utils.convert``'s CLI and ``utils.extract_ckpt
    --model vit-large`` on phase 6's random ViT-L ``.pth``, each output
    served meta-less with ``--model vit-large``: the judge CSV must equal
    phase 6's from the ``.pth`` itself, row for row (the same weights,
    statistics and kernels). Returns K1's launches by path."""
    from touhouimageclassification_tpu_torch.utils import convert, extract_ckpt

    want = judge_rows(os.path.join(work, "judge_cache_off.csv"))
    launches = {}
    for name, cli in (("convert", convert.main),
                      ("extract_pth", extract_ckpt.main)):
        out = os.path.join(work, f"{name}_vit_l")
        t0 = time.perf_counter()
        cli(["--input", pth, "--model", "vit-large", "--num-classes",
             str(NUM_CLASSES), "--output", out])
        secs = time.perf_counter() - t0
        if os.listdir(out) != ["params.safetensors"]:
            raise AssertionError(f"{name} wrote {os.listdir(out)}")
        out_csv = os.path.join(work, f"judge_{name}_vit_l.csv")
        k1, serve_secs = serve_judge(attn, serve, "vit-large", out, data,
                                     out_csv, layers, f"phase 17(b) {name}")
        if judge_rows(out_csv) != want:
            raise AssertionError(f"serve from the {name} output disagrees "
                                 "with serve from the .pth")
        launches[f"serve_{name}"] = k1
        print(f"phase 17(b) {name} (CPU) of the ViT-L .pth "
              f"({os.path.getsize(pth)} bytes): {dir_bytes(out)} bytes in "
              f"{secs:.2f} s; serve --full from it {serve_secs:.2f} s, judge "
              "CSV equal to the .pth's row for row")
    return launches


def phase_extract_resmoe(torch, attn, serve, trainer, saved: str, batch,
                         restored, data: str, work: str, dev) -> int:
    """Phase 17(c), on phase 16's expert-sharded ResMoE save: extract it,
    serve it meta-less (``--model resmoe``, eight experts from the tensor
    names) in one process, K1 108 a forward; on phase 16's batch and the
    trainer's mean and std its logits must equal the restored trainer's
    within ``EP_LOGIT_ATOL``. Returns K1's launches."""
    from touhouimageclassification_tpu_torch.utils import extract_ckpt

    out = os.path.join(work, "extracted_resmoe")
    t0 = time.perf_counter()
    extract_ckpt.main(["--input", saved, "--output", out])
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = serve.init(modelt="resmoe", weights=out, data_dir=data, device=dev)
    init_secs = time.perf_counter() - t0
    if len(pred.model.experts) != 8:
        raise AssertionError(f"{len(pred.model.experts)} experts served")
    staged = trainer.stage(batch)
    zero_counts(attn)
    with torch.no_grad():
        images = trainer.eval_transform(staged["image"].float() / 255.0)
        logits = pred.model(images)[0].float()
    served, conf = pred.predict_array(batch["image"])
    k1, _ = read_counts(attn, "phase 17(c) served ResMoE, 2 forwards",
                        (2 * MIX_K1, 0))
    diff = (logits - restored).abs().max().item()
    print(f"phase 17(c) extract_ckpt of the expert-sharded save "
          f"({dir_bytes(saved)} bytes, {sorted(os.listdir(saved))}): "
          f"{dir_bytes(out)} bytes in {secs:.2f} s; serve.init --model "
          f"resmoe {init_secs:.2f} s; logits max |diff| to the restored "
          f"trainer's {diff:.3e}; served classes (dataset statistics) "
          f"{served.tolist()}, confidences "
          f"{[round(float(c), 4) for c in conf]}")
    if diff > EP_LOGIT_ATOL or not np.isfinite(conf).all():
        raise AssertionError("the served extracted ResMoE disagrees")
    del pred
    return k1


def phase_aug(torch, data: str, work: str, dev) -> None:
    """Phase 17(d): ``analysis.aug.visualize`` at 224x224 on one image of
    the fixture, on the card: four PNGs of 1, 8, 8 and 16 tiles, every
    recipe's input, generator and output on CUDA."""
    from PIL import Image

    from touhouimageclassification_tpu_torch.analysis import aug

    devices = set()
    build = aug.build_augment_fn

    def recorded(cfg, out_size):
        fn = build(cfg, out_size)

        def run(gen, images):
            out = fn(gen, images)
            devices.update((gen.device.type, images.device.type,
                            out.device.type))
            return out
        return run

    aug.build_augment_fn = recorded
    t0 = time.perf_counter()
    written = aug.visualize(os.path.join(data, "class_000", "0.jpg"),
                            os.path.join(work, "show_augmentation"),
                            device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    aug.build_augment_fn = build
    sizes = []
    for path in written:
        with Image.open(path) as im:
            sizes.append(im.size)
    # the original is the 256x256 base; recipe tiles are 224x224 in grids
    # of 3 x 3 (8 tiles) and 4 x 4 (16)
    want = [(256, 256)] + [(224 * c, 224 * c) for c in (3, 3, 4)]
    print(f"phase 17(d) analysis.aug on the card: {written} sizes {sizes} "
          f"({sum(os.path.getsize(p) for p in written)} bytes), recipes on "
          f"{sorted(devices)}, {secs:.2f} s")
    if sizes != want or devices != {"cuda"}:
        raise AssertionError("augmentation grids")


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
        fit_launches, vit_export, loading_launches = phase_fit(
            torch, attn, create_model, serve, data, pth, work, layers, dev,
            rates[("fused", 8)])
        loading_launches.update(phase_convert_vit(attn, serve, pth, data,
                                                  work, layers))
        phase_aug(torch, data, work, dev)
        pipeline_launches = phase_resnet_pipeline(
            torch, attn, serve, create_model, Trainer, data, work, vit_export,
            mean_std["mean"], mean_std["std"], layers, dev)
        study_kernels = phase_studies(torch, attn, study)
        tile_kernels = phase_tile_studies(torch, attn, study)
        _, mix_launches, vit_b = phase_mixtures(
            torch, attn, serve, create_model, Trainer, data, work,
            mean_std["mean"], mean_std["std"], dev)
        multi_launches = phase_multi_gpu(torch, attn, serve, create_model,
                                         Trainer, data, work, layers, dev)

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
                              **loading_launches,
                              **pipeline_launches,
                              **{path: k1 for path, (k1, _) in
                                 mix_launches.items()},
                              **{path: k1 for path, (k1, _) in
                                 multi_launches.items()}}, "fit"),
        ("K2", "slab_attention_bwd", "slab_attention_bwd.cu",
         "attention.py:482", {"train": train_launches[1],
                              "fit": fit_launches[1],
                              **{path: k2 for path, (_, k2) in
                                 mix_launches.items() if k2},
                              **{path: k2 for path, (_, k2) in
                                 multi_launches.items() if k2}}, "fit"),
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
    # K1 and K2 at the mixtures' ViT-B shapes (phase 15), by batch
    stats["K1"]["vit_b"] = [fwd for fwd, _ in vit_b]
    stats["K2"]["vit_b"] = [bwd for _, bwd in vit_b]
    print(card)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": csrc + source,
        "device_routes": device_routes[key],
        "replaces": ref + replaces, "launches": by_path[main_path],
        "launches_by_path": by_path, **stats[key]}
        for key, name, source, replaces, by_path, main_path in kernels]
        + study_kernels + tile_kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2:]))
    sys.exit(main())
