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
   of ``SWEEP_N`` and D of ``SWEEP_D`` (B 1), checking that each launch
   takes the route ``kernel_route`` names (the bf16 forward at D 64 and
   N <= 256 ``wgmma``, other bf16 shapes ``mma``, f32 ``simt``), that the
   wrapper's shared memory equals the C sum of both bf16 routes, and that a
   shape past shared memory raises; then K1's ``wgmma`` route against its
   ``mma.sync`` kernel (the S2 study's exp2 variant, K1's earlier route),
   SDPA and the plain version at ViT-L B 64 and 1 and ViT-B B 2, 4 and 64,
   around one launch and as device time, with the bound and the host time
   of one launch;
4. the same for the backward kernel (K2) at the train path's shapes (the
   library call is SDPA's autograd backward), two launches bit-equal, and
   check that autograd through the fused attention runs K1 then K2; measure
   how far the probabilities of the ``mma.sync`` kernel's two passes differ;
   then K2's ``wgmma`` route against its ``mma.sync`` kernel (the ``full``
   peel), SDPA's backward and the plain version at ViT-L B 64 and 8 and
   ViT-B B 64, 4 and 2, around one launch and as device time, with the bound,
   the host time of one launch and the ``wgmma`` kernel's forms forced one
   by one (``k2_routes``);
5. the same for the three-operand attention (K3, forward and backward) and
   the (B, N, H, D) attention forward (K4, on the q, k, v views of a QKV
   slab, as the model hands them), K3's backward also beside its
   ``mma.sync`` kernel and bit-equal to K2 on the same values; the patch
   embedding (K5) at ViT-L's
   shapes and in a bf16 sweep (B 1, 3, 63; 224x224 at P 16 and 8, 224x160;
   D 64 to 1024), bf16 launches on the tensor-core route (``wgmma``) and
   f32 on ``simt``, timed against ``F.conv2d`` and the model's ``'xla'``
   patch embedding; then ``packed_attention`` (K3's op) once under
   autograd, and K1, K2 and K5 each launched from a fresh thread (as
   autograd's worker launches K2), bit-equal to the main thread's launch;
   then the AdamW update (U1) at ViT-L's and V-MoE's parameter lists: one
   launch a step over the whole list, p, m and v within 2 ulp of torch's
   foreach AdamW on the same inputs, timed beside torch's foreach and fused
   steps and its bytes bound; then the LayerNorm pair (N1) at ViT-L's b256
   and b8 rows and ViT-B's bucket-64 rows in bf16, and at V-MoE-L's b128
   rows with a bf16 x and an f32 y and dy (``ln2``): y, dx and the scale's
   and bias's gradients against the plain version, one forward and one
   backward launch, and the device times of the forward, the backward and
   the pair beside the plain version (``F.layer_norm`` on f32 between two
   casts, under autograd, which is also the library call) and the bytes
   bound;
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
   steps with K1 and K2 launched once per layer each, U1 once a step and N1
   49 times a step forward and backward, then ``evaluate`` on the val split;
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
    layer per step, both on the ``wgmma`` route (every bf16 model path
    below counts them so), U1 once a step and N1 49 times a forward and a
    backward, its checkpoint restored, ``--test``,
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
    bit for bit to the ``mma.sync`` kernels they peel (K1's and K2's kernels
    before the ``wgmma`` routes);
14. the kernel studies S1-S4, the study path: ``tools.bench_attn4`` (S1,
    whole images a block), ``tools.bench_attn6`` (S2, exp / exp2 and the
    divide of P / 1 / l after PV, on K1's kernel), ``tools.bench_attn7``
    (S3, head batching, forward and backward) and ``tools.bench_attn8`` (S4,
    H / S heads a block, forward and backward) at ViT-L's width and B 64 and
    128, their launches counted by tile and variant; then every tile held
    to its plain version within the bf16 bounds and bit for bit to the
    ``mma.sync`` forward (S2's exp2 variant without post_mul) and to the
    ``mma.sync`` backward (the ``full`` peel), at B 64 and 128 and on ragged shapes (B 1, 2, 3; N 16, 67,
    197, 257), the S2 variants to their plain versions, a tile past shared
    memory (N 577)
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
18. the options that last joined the port, after phase 17(d): (a) ViT-L
    ``nvit`` ``'fused'`` at batch 64 with remat off, ``'full'`` and
    ``'dots'``: img/s over 5 steps after 2, peak memory allocated over all
    7 and reserved over the 5 replayed steps (the graph's pool holds the
    activations), each full < dots < off, K1/K2 a step (24/24, 48/24,
    48/24), and step 1's gradients of both policies against remat off in
    f32 without TF32 (1e-5 a leaf);
    (b) ResNet-152 at 256x256, the ``resnet152`` preset at batch 80, from
    one initialisation with calibrated BN statistics: eval logits of
    ``'batch'``, ``'ghost'`` and ``'stale'`` equal to ``'flax'``'s, step
    1's gradients of ``'batch'`` against ``'flax'`` in f32 (1e-4 a leaf),
    then each variant's img/s, peak memory, moved statistics and skipped
    steps; (c) 8 ``nvit`` steps at batch 8 as two ``train_steps`` calls of
    4 against 8 ``train_step`` calls: parameters and AdamW state bit for
    bit, U1 once a step, N1 49 times a step forward and backward, the
    calls' metrics the steps' means, one host
    sync a call (the
    trainer's count and torch's sync debug mode), a NaN batch at position 1
    and 3 of a call skipped as a single step skips it; (d)
    ``Predictor.warmup`` on phase 11's ViT-L export: K1 24 a bucket, then
    the first request.

Every profiled train step (phases 10, 12, 15 and 18(a)) is a replay of
the step's CUDA graph, and the K1, K2 and K5 kernels its trace holds must
be the launches the counters credited it (K2 one or two kernels a launch,
by its form).

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
# AdamW's update (U1) moves 28 bytes an f32 parameter: p, g, m and v read,
# p, m and v written.
ADAMW_BYTES = 28
# The LayerNorm pair (N1): (rows, width, output dtype) of ViT-L's b256 and
# b8 steps and of ViT-B's bucket-64 forward, a bf16 input and output, and of
# V-MoE-L's b128 ``ln2``, a bf16 input and an f32 output (and dy) for the
# router
LAYERNORM_SHAPES = {"vitl_b256": (256 * 197, 1024, "bfloat16"),
                    "vitl_b8": (8 * 197, 1024, "bfloat16"),
                    "vitb_b64": (64 * 197, 768, "bfloat16"),
                    "vmoe_ln2_b128": (128 * 197, 1024, "float32")}
# U1's launches by the train paths that check them (one an update): the
# nvit train steps, the ntrain fit and the k = 4 calls
U1_LAUNCHES: dict[str, int] = {}
# N1's forward and backward launches by the same paths (ViT-L's 49
# LayerNorms a forward and a backward), and by phase 5's own calls
LAYERNORM_LAUNCHES: dict[str, list[int]] = {}
# The attention kernels' shape sweep in bf16 (B 1, two heads): N from one
# token to ViT at 384^2 (577), through a 16-row chunk, ragged edges, ViT-L's
# 197 and the wgmma route's last N (256); every head dim the kernels take. At
# N 577, D 128 the operands exceed shared memory and the launch must raise.
SWEEP_N = (1, 16, 67, 197, 256, 257, 577)
SWEEP_D = (32, 64, 128)
# The attention kernels' routes by dtype at the models' shapes (D 64, N 197):
# the forward (K1, K3's forward, K4) and the backward (K2, K3's backward) on
# the Hopper wgmma kernels in bf16; f32 on SIMT either way.
ROUTES = {"bfloat16": "wgmma", "float32": "simt"}
BWD_ROUTES = {"bfloat16": "wgmma", "float32": "simt"}
# K1's routes compared at the mixtures' and ViT-L's widths (phase 3): (name,
# B, C, H) at N 197; K2's (phase 4) at the train step's batches.
K1_ROUTE_SHAPES = (("vit-l", 64, 1024, 16), ("vit-l", 1, 1024, 16),
                   ("vit-b", 2, 768, 12), ("vit-b", 4, 768, 12),
                   ("vit-b", 64, 768, 12))
K2_ROUTE_SHAPES = (("vit-l", 64, 1024, 16), ("vit-l", 8, 1024, 16),
                   ("vit-b", 64, 768, 12), ("vit-b", 4, 768, 12),
                   ("vit-b", 2, 768, 12))
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


def zero_routes(attn) -> None:
    """Set the attention kernels' launch counts by route to 0."""
    attn.route_launches.update(dict.fromkeys(attn.route_launches, 0))


def model_routes(forwards: int, backwards: int) -> dict:
    """The attention launches by route that a bf16 model path at D 64 and
    N 197 must show: its forwards (K1, K4) and its backwards (K2) on wgmma,
    none on mma or simt."""
    return {"wgmma": forwards + backwards, "mma": 0, "simt": 0}


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
    ``ops``: every one must take the dtype's route (``routes``: the
    attention forward bf16 ``wgmma``, f32 ``simt``; ``BWD_ROUTES`` for the
    backward). Returns its result."""
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
    shared memory as the wrapper computes it equals the C function's, for
    the route ``kernel_route`` names and for ``mma`` where that is
    ``wgmma``; a shape that fits runs on its route within TOL and REL_TOL of
    its plain version, a shape that does not raises before launching.
    ``make(n, c, h)`` returns (kernel call, plain call)."""
    torch.cuda.synchronize()
    lib = attn.load_library()
    limit = lib.tic_max_smem_optin(0)
    c_bytes = {"mma": lambda n, d: (
        lib.tic_slab_attention_bwd_smem_bytes if backward
        else lib.tic_slab_attention_fwd_smem_bytes)(n, d, 1),
        "wgmma": (lib.tic_slab_attention_bwd_sm90_smem_bytes if backward
                  else lib.tic_slab_attention_fwd_sm90_smem_bytes)}
    worst, raised = (0.0, 0.0), []
    by_route = {}
    for d in SWEEP_D:
        for n in SWEEP_N:
            route = attn.kernel_route(torch.bfloat16, d, n, backward)
            by_route.setdefault(route, []).append((n, d))
            for r in {route, "mma"}:
                got = attn.kernel_smem_bytes(r, backward, n, d)
                if got != c_bytes[r](n, d):
                    raise AssertionError(
                        f"{what} N {n} D {d}: {r} shared memory {got} "
                        f"(wrapper) vs {c_bytes[r](n, d)}")
            need = attn.kernel_smem_bytes(route, backward, n, d)
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
            out = on_route(attn, torch.bfloat16, 1, kernel,
                           {"bfloat16": route})
            torch.cuda.synchronize()
            if isinstance(out, tuple):
                out, ref = torch.cat(out, -1), torch.cat(plain(), -1)
            else:
                ref = plain()
            got = check_close(torch, f"{what} N {n} D {d}", out, ref,
                              torch.bfloat16, verbose=False)
            worst = tuple(max(a, b) for a, b in zip(worst, got))
    print(f"{what}, bf16 sweep N {SWEEP_N} x D {SWEEP_D} (B 1, H 2): every "
          f"launch on its route, (N, D) by route {by_route}; worst max |diff| "
          f"{worst[0]:.3e}, "
          f"relative norm {worst[1]:.3e} (bounds {TOL['bfloat16']}, "
          f"{REL_TOL['bfloat16']}); raised as past shared memory ({limit} "
          f"bytes): {raised}")


def sdpa(torch, q, k, v):
    """The library call that computes the attention of (B, N, H, D) q, k, v:
    ``F.scaled_dot_product_attention`` on their (B, H, N, D) views (timed
    here as a yardstick; the port never calls it)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))


def sdpa_backward(torch, leaves, views, g):
    """SDPA's autograd backward alone, as a call: the forward is taken once,
    each call takes the gradient of ``leaves`` with the graph retained."""
    with torch.enable_grad():
        out = sdpa(torch, *views)
    g = g.reshape(out.transpose(1, 2).shape).transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def sdpa_backward_ms(torch, leaves, views, g) -> float:
    """Milliseconds of SDPA's autograd backward alone (one call between
    events)."""
    return cuda_ms(sdpa_backward(torch, leaves, views, g))


def mma_backward(torch, attn, qkv, g, h):
    """K2's mma.sync kernel on a bf16 slab whatever route ``kernel_route``
    names for its shape: the entry point of that route,
    ``tic_slab_attention_bwd``, called directly. Counts no launch."""
    lib = attn.load_library()
    b, n, c3 = qkv.shape
    d = c3 // 3 // h
    out = torch.empty_like(qkv)
    stats = torch.empty((3, b, h, n), dtype=torch.float32, device=qkv.device)
    err = lib.tic_slab_attention_bwd(
        qkv.data_ptr(), g.data_ptr(), out.data_ptr(), stats.data_ptr(), b, n,
        h, d, 1, d ** -0.5, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"tic_slab_attention_bwd failed with CUDA error {err}")
    return out


def mma_packed_backward(torch, attn, q, k, v, g, h):
    """K3's backward on its mma.sync kernel (``tic_attention_bwd``, called
    directly) for three contiguous bf16 (B, N, C) operands. Counts no
    launch."""
    lib = attn.load_library()
    b, n, c = q.shape
    d = c // h
    grads = [torch.empty_like(q) for _ in range(3)]
    stats = torch.empty((3, b, h, n), dtype=torch.float32, device=q.device)
    err = lib.tic_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), n * c, c, g.data_ptr(),
        *(x.data_ptr() for x in grads), n * c, c, stats.data_ptr(), b, n, h, d,
        1, d ** -0.5, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"tic_attention_bwd failed with CUDA error {err}")
    return grads


def k2_form(torch, attn, qkv, g, h, split: int):
    """K2's wgmma kernel with its form forced, through the measurement entry
    point ``tic_slab_attention_bwd_sm90_form``: split 0, one launch of whole
    heads; 1, two launches of two-block items; 2, of one-block items (the
    wrapper's rule picks one by the shape). Counts no launch."""
    lib = attn.load_library()
    b, n, c3 = qkv.shape
    d = c3 // 3 // h
    out = torch.empty_like(qkv)
    stats = torch.empty((3, b, h, n), dtype=torch.float32, device=qkv.device)
    err = lib.tic_slab_attention_bwd_sm90_form(
        qkv.data_ptr(), g.data_ptr(), out.data_ptr(), stats.data_ptr(), b, n,
        h, d, d ** -0.5, split, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K2 form {split} failed with CUDA error {err}")
    return out


def host_ms(torch, fn, calls: int = 100) -> float:
    """Host milliseconds to enqueue one ``fn()``: ``calls`` calls while a
    spin kernel holds the card, so none waits for the device."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * secs / calls


def k1_routes(torch, attn, study, gen, dev) -> list[dict]:
    """K1 on its ``wgmma`` route against its ``mma.sync`` kernel (S2's exp2
    variant without post_mul, bit-equal to K1's earlier route), SDPA and the
    plain version at K1_ROUTE_SHAPES: one launch between events (``ms``),
    device time (``device_ms``), the host's time to enqueue one launch and
    the bytes bound. Every launch of the wgmma side counted on its route."""
    rows = []
    for name, b, c, h in K1_ROUTE_SHAPES:
        qkv = torch.randn(b, 197, 3 * c, generator=gen, device=dev).to(
            torch.bfloat16)
        views = qkv.view(b, 197, 3, h, c // h).unbind(2)
        sides = {"wgmma": lambda: attn.slab_attention_forward(qkv, h),
                 "mma": lambda: study.softmax_variant_forward(qkv, h, True,
                                                              False),
                 "sdpa": lambda: sdpa(torch, *views),
                 "plain": lambda: attn.slab_attention_reference(qkv, h)}
        ref = sides["plain"]()
        row = {"shape": name, "batch": b}
        outs = {"wgmma": on_route(attn, torch.bfloat16, 1, sides["wgmma"]),
                "mma": sides["mma"]()}
        for side, out in outs.items():
            row[f"{side}_max_abs_err"] = check_close(
                torch, f"K1 {side}, {name} B {b}", out, ref, torch.bfloat16,
                verbose=False)[0]
        for side, fn in sides.items():
            row[f"{side}_ms"] = cuda_ms(fn)
            row[f"{side}_device_ms"] = device_ms(fn)
        for side in ("wgmma", "mma"):
            row[f"{side}_host_ms"] = host_ms(torch, sides[side])
        row["bound_ms"], row["bound_by"] = attention_bound(
            b, 197, c, h, torch.bfloat16, backward=False)
        row["wgmma_share_of_bound"] = row["bound_ms"] / row["wgmma_device_ms"]
        print(f"K1 routes, {name} B {b} (N 197, C {c}, H {h}; "
              f"{card_line()}): {json.dumps(row)}")
        rows.append(row)
    return rows


def phase_kernels(torch, attn, study):
    """Kernel vs plain at the serve path's shapes; times at the ViT-L bucket,
    and K1's two bf16 routes side by side (:func:`k1_routes`)."""
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
        routes = k1_routes(torch, attn, study, gen, dev)
    at64 = routes[0]
    print(f"slab attention, ViT-L bucket 64 bf16 (B 64, N 197, C 1024, H 16): "
          f"kernel (wgmma) {at64['wgmma_ms']:.4f} ms, device "
          f"{at64['wgmma_device_ms']:.4f}; mma.sync "
          f"{at64['mma_device_ms']:.4f}; plain {at64['plain_ms']:.4f} ms, "
          f"SDPA {at64['sdpa_ms']:.4f} ms, device "
          f"{at64['sdpa_device_ms']:.4f} (median of 30 / 10); bound "
          f"{at64['bound_ms']:.4f} ms ({at64['bound_by']})")
    return dict(max_abs_err=errs[("vit-l bucket 64", torch.bfloat16)],
                ms=at64["wgmma_ms"], device_ms=at64["wgmma_device_ms"],
                plain_ms=at64["plain_ms"], bound_ms=at64["bound_ms"],
                bound_by=at64["bound_by"], library_ms=at64["sdpa_ms"],
                library_device_ms=at64["sdpa_device_ms"],
                mma_ms=at64["mma_ms"], mma_device_ms=at64["mma_device_ms"],
                host_ms=at64["wgmma_host_ms"], routes=routes)


def k2_routes(torch, attn, study, gen, dev) -> list[dict]:
    """K2 on its ``wgmma`` route against its ``mma.sync`` kernel (the ``full``
    peel of S5, K2's kernel before the wgmma route), SDPA's autograd backward
    and the plain version at K2_ROUTE_SHAPES: one launch between events
    (``ms``), device time (``device_ms``), the host's time to enqueue one
    launch and the bytes bound; the wgmma kernel's forms forced one by one
    (``fused``: one launch of whole heads; ``split2``, ``split1``: two
    launches of two- and one-block items), each bit-equal to the wrapper's
    launch. Every launch of the wgmma side counted on its route; two
    launches bit-equal; wgmma within TOL and REL_TOL of the plain version
    and of mma.sync."""
    rows = []
    for name, b, c, h in K2_ROUTE_SHAPES:
        qkv = torch.randn(b, 197, 3 * c, generator=gen, device=dev).to(
            torch.bfloat16)
        g = torch.randn(b, 197, c, generator=gen, device=dev).to(torch.bfloat16)
        leaf = qkv.detach().requires_grad_()
        sides = {"wgmma": lambda: attn.slab_attention_backward(qkv, g, h),
                 "mma": lambda: study.slab_attention_peel_backward(qkv, g, h,
                                                                   "full"),
                 "sdpa": sdpa_backward(torch, (leaf,), leaf.view(
                     b, 197, 3, h, c // h).unbind(2), g),
                 "plain": lambda: attn.slab_attention_backward_reference(
                     qkv, g, h)}
        forms = {f: (lambda split=split: k2_form(torch, attn, qkv, g, h, split))
                 for f, split in (("fused", 0), ("split2", 1), ("split1", 2))}
        ref = sides["plain"]()
        out = on_route(attn, torch.bfloat16, 1, sides["wgmma"], BWD_ROUTES)
        mma = sides["mma"]()
        torch.cuda.synchronize()
        row = {"shape": name, "batch": b}
        for side, got in (("wgmma", out), ("mma", mma)):
            row[f"{side}_max_abs_err"], row[f"{side}_rel_norm"] = check_close(
                torch, f"K2 {side}, {name} B {b}", got, ref, torch.bfloat16,
                verbose=False)
        row["wgmma_vs_mma_max_abs"], row["wgmma_vs_mma_rel_norm"] = (
            check_close(torch, f"K2 wgmma vs mma.sync, {name} B {b}", out, mma,
                        torch.bfloat16, verbose=False))
        if not torch.equal(out, sides["wgmma"]()):
            raise AssertionError(f"K2 wgmma, {name} B {b}: two launches differ")
        for f, fn in forms.items():
            if not torch.equal(out, fn()):
                raise AssertionError(f"K2 wgmma form {f}, {name} B {b}: not "
                                     "bit-equal to the wrapper's launch")
        for side, fn in sides.items():
            row[f"{side}_ms"] = cuda_ms(fn)
            row[f"{side}_device_ms"] = device_ms(fn)
        for f, fn in forms.items():
            row[f"wgmma_{f}_device_ms"] = device_ms(fn)
        for side in ("wgmma", "mma"):
            row[f"{side}_host_ms"] = host_ms(torch, sides[side])
        row["bound_ms"], row["bound_by"] = attention_bound(
            b, 197, c, h, torch.bfloat16, backward=True)
        row["wgmma_share_of_bound"] = row["bound_ms"] / row["wgmma_device_ms"]
        print(f"K2 routes, {name} B {b} (N 197, C {c}, H {h}; "
              f"{card_line()}): {json.dumps(row)}")
        rows.append(row)
    return rows


def phase_backward(torch, attn, study):
    """K2 vs plain at the train path's shapes, two launches bit-equal; K2's
    two bf16 routes side by side (:func:`k2_routes`)."""
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
                       lambda: attn.slab_attention_backward(qkv, g, h),
                       BWD_ROUTES)
        torch.cuda.synchronize()
        if attn.bwd_launches != before + 1:
            raise AssertionError(f"{name}: bwd_launches went {before} -> "
                                 f"{attn.bwd_launches}, expected one")
        errs[(name, dtype)] = check_close(
            torch, f"K2 vs plain backward, {name}", out,
            attn.slab_attention_backward_reference(qkv, g, h), dtype)
        if not torch.equal(out, attn.slab_attention_backward(qkv, g, h)):
            raise AssertionError(f"K2, {name} {dtype}: two launches differ")

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

    # The mma.sync kernel's two passes form S as Q K^T (pass 1) and K Q^T
    # (pass 2) on the tensor cores, as the wgmma kernel's two phases do: how
    # far apart are the probabilities they form?
    for b, n, c, h in [(8, 197, 1024, 16), (2, 67, 64, 2), (2, 257, 256, 2)]:
        q, k, v, g = (torch.randn(b, n, c, generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(4))
        p1, p2 = attn.backward_probabilities(q, k, v, g, h)
        if not (torch.isfinite(p1).all() and torch.isfinite(p2).all()):
            raise AssertionError("a pass left a probability unwritten")
        diff = (p1 - p2).abs()
        print(f"K2 (mma.sync) pass 1 vs pass 2 probabilities, B {b} N {n} H {h} D "
              f"{c // h}: {int((p1 != p2).sum())} of {p1.numel()} differ, max "
              f"|diff| {diff.max().item():.3e}")

    routes = k2_routes(torch, attn, study, gen, dev)
    at64 = routes[0]
    print(f"slab attention backward, ViT-L batch 64 bf16 (B 64, N 197, C 1024, "
          f"H 16): K2 (wgmma) {at64['wgmma_ms']:.4f} ms, device "
          f"{at64['wgmma_device_ms']:.4f}; mma.sync {at64['mma_device_ms']:.4f}; "
          f"plain {at64['plain_ms']:.4f} ms; SDPA's autograd backward "
          f"{at64['sdpa_ms']:.4f} ms, device {at64['sdpa_device_ms']:.4f} "
          f"(median of 30 / 10); bound {at64['bound_ms']:.4f} ms "
          f"({at64['bound_by']})")
    return dict(max_abs_err=errs[("vit-l batch 64", torch.bfloat16)],
                ms=at64["wgmma_ms"], device_ms=at64["wgmma_device_ms"],
                plain_ms=at64["plain_ms"], bound_ms=at64["bound_ms"],
                bound_by=at64["bound_by"], library_ms=at64["sdpa_ms"],
                library_device_ms=at64["sdpa_device_ms"],
                mma_ms=at64["mma_ms"], mma_device_ms=at64["mma_device_ms"],
                host_ms=at64["wgmma_host_ms"], routes=routes)


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
                         lambda: attn.packed_attention_backward(q, k, v, g, h),
                         BWD_ROUTES)
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
                device_ms=device_ms(
                    lambda: attn.packed_attention_forward(q, k, v, h)),
                plain_ms=cuda_ms(
                    lambda: attn.packed_attention_reference(q, k, v, h)),
                library_ms=cuda_ms(lambda: sdpa(torch, *heads)),
                library_device_ms=device_ms(lambda: sdpa(torch, *heads)))
            # K3's backward is K2's device code: the same bits on the slab
            # of the same values; beside its mma.sync kernel, as K2's rows
            slab_grads = attn.slab_attention_backward(
                torch.cat([q, k, v], -1), g, h)
            if not torch.equal(torch.cat(grads, -1), slab_grads):
                raise AssertionError("K3 backward differs from K2 on the same "
                                     "values")
            mma = torch.cat(mma_packed_backward(torch, attn, q, k, v, g, h), -1)
            check_close(torch, "K3 backward wgmma vs mma.sync", torch.cat(
                grads, -1), mma, dtype)
            sides = {
                "": lambda: attn.packed_attention_backward(q, k, v, g, h),
                "mma_": lambda: mma_packed_backward(torch, attn, q, k, v, g, h),
                "library_": sdpa_backward(
                    torch, leaves, [x.view(b, n, h, c // h) for x in leaves], g)}
            rec = {"max_abs_err": bwd_err, "plain_ms": cuda_ms(
                lambda: attn.packed_attention_backward_reference(q, k, v, g, h))}
            for side, fn in sides.items():
                rec[f"{side}ms"] = cuda_ms(fn)
                rec[f"{side}device_ms"] = device_ms(fn)
            rec["host_ms"] = host_ms(torch, sides[""])
            rec["mma_host_ms"] = host_ms(torch, sides["mma_"])
            out["K3 bwd"] = rec
            for key, backward in (("K3 fwd", False), ("K3 bwd", True)):
                out[key]["bound_ms"], out[key]["bound_by"] = attention_bound(
                    b, n, c, h, dtype, backward)
            out["K3 bwd"]["share_of_bound"] = (out["K3 bwd"]["bound_ms"]
                                               / out["K3 bwd"]["device_ms"])

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
                device_ms=device_ms(lambda: attn.flash_attention_forward(q, k,
                                                                         v)),
                plain_ms=cuda_ms(
                    lambda: attn.flash_attention_reference(q, k, v)),
                library_ms=cuda_ms(lambda: sdpa(torch, q, k, v)),
                library_device_ms=device_ms(lambda: sdpa(torch, q, k, v)),
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
        print(f"{key}, ViT-L batch 64 bf16 ({card_line()}): kernel "
              f"{r['ms']:.4f} ms (device {r['device_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f} ms, library call {r['library_ms']:.4f} ms "
              f"(device {r.get('library_device_ms', float('nan')):.4f}; median "
              f"of 30 / 10); bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    print(f"K3 bwd, ViT-L batch 64 bf16 ({card_line()}): "
          f"{json.dumps(out['K3 bwd'])}")
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


def phase_fresh_thread(torch, attn, pe) -> None:
    """Every kernel that encodes a tensor map on the host (K1 and K2 on
    wgmma, K5) launched from a thread whose first CUDA call it is, as
    autograd's worker thread runs K2 when the attention backward is its
    first operation: the outputs equal the main thread's bit for bit."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bf16 = torch.bfloat16
    qkv = torch.randn(2, 197, 3 * 768, generator=gen, device=dev).to(bf16)
    g = torch.randn(2, 197, 768, generator=gen, device=dev).to(bf16)
    img = torch.randn(2, 224, 224, 3, generator=gen, device=dev).to(bf16)
    w = (0.02 * torch.randn(768, 768, generator=gen, device=dev)).to(bf16)
    bias = (0.02 * torch.randn(768, generator=gen, device=dev)).to(bf16)
    runs = {"K1": lambda: attn.slab_attention_forward(qkv, 12),
            "K2": lambda: attn.slab_attention_backward(qkv, g, 12),
            "K5": lambda: pe.patch_embed_forward(img, w, bias, 16)}
    for name, run in runs.items():
        got, errors = {}, []

        def target(run=run):
            try:
                got["out"] = run()
                torch.cuda.synchronize()
            except Exception as e:  # carried to the main thread
                errors.append(e)

        thread = threading.Thread(target=target)
        thread.start()
        thread.join()
        if errors:
            raise AssertionError(f"{name} from a fresh thread: {errors[0]}")
        if not torch.equal(got["out"], run()):
            raise AssertionError(f"{name} from a fresh thread differs from the "
                                 "main thread's launch")
    print(f"K1, K2 and K5 launched from fresh threads: bit-equal to the main "
          f"thread's ({card_line()})")


def adamw_param_sets(torch, dev):
    """The parameter lists of the train cells' updates, f32 on the card, as
    (name, build function): ViT-L/16 (the nvit cells, 303.4 M) and one card's
    V-MoE-L/16 (16 of 32 experts held; 1.815 B)."""
    from touhouimageclassification_tpu_torch.config import vit_config
    from touhouimageclassification_tpu_torch.models.vit import ViT
    from touhouimageclassification_tpu_torch.models.vmoe import VMoE, VMoEConfig

    vit = vit_config("vit-large", num_classes=NUM_CLASSES)
    return [("vit_l", lambda: ViT(vit, "float32", dev, param_dtype="float32")),
            ("vmoe", lambda: VMoE(VMoEConfig(vit=vit, num_expert_shards=2),
                                  "float32", dev, param_dtype="float32"))]


def max_ulps(torch, got, want, scale) -> float:
    """Largest |got - want| in ulps of ``scale``'s magnitude."""
    scale = scale.abs()
    ulp = torch.nextafter(scale, torch.full_like(scale, float("inf"))) - scale
    return ((got - want).abs() / ulp).max().item()


def foreach_reference(torch, params, hyper, limit: int = 1 << 28):
    """``torch.optim.AdamW``'s foreach route (the port's update before U1)
    stepped once on copies of ``params``, their gradients shared, a slice of
    the list of at most ``limit`` elements at a time so that its
    temporaries stay small; returns (copy, its state) in the list's order."""
    slices, size = [[]], 0
    for p in params:
        if slices[-1] and size + p.numel() > limit:
            slices.append([])
            size = 0
        slices[-1].append(p)
        size += p.numel()
    out = []
    for part in slices:
        copies = [p.clone() for p in part]
        for c, p in zip(copies, part):
            c.grad = p.grad
        ref = torch.optim.AdamW(copies, foreach=True, **hyper)
        ref.step()
        out += [(c, ref.state[c]) for c in copies]
        del ref
    return out


def phase_adamw(torch, adamw, lib) -> dict:
    """U1, the AdamW kernel (``csrc/adamw.cu``), at ViT-L's and V-MoE's
    parameter lists with the nvit preset's lr 1e-5 and decay 0.01: one
    launch a step over the whole list; after a step from the same state p,
    m and v within 2 ulp of ``torch.optim.AdamW``'s foreach route
    (:func:`foreach_reference`); ``ms`` one step between events from an
    idle card, the gradients on ``.grad`` as the port's ``Optimizer`` sets
    them (its host work before the launch included, as the trainer's update
    span times it), ``device_ms`` the kernel alone (20 launches of the kept
    table behind a spin), ``plain_ms`` the foreach route's step and
    ``library_ms`` ``torch.optim.AdamW(fused=True)``'s (the yardstick,
    which the port never calls), each between events from an idle card;
    the bound is 28 bytes an element (f32 p, g, m and v read, p, m and v
    written) at 3.35 TB/s."""
    dev = torch.device("cuda", 0)
    hyper = dict(lr=1e-5, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    out = {}
    for name, build in adamw_param_sets(torch, dev):
        params = [p.detach() for p in build().parameters()]
        numel = sum(p.numel() for p in params)
        gen = torch.Generator(device=dev).manual_seed(SEED + 11)
        for p in params:
            p.grad = 1e-3 * torch.randn(p.shape, generator=gen, device=dev)
        opt = adamw.AdamW(params, **hyper)
        stats = {"params": numel}
        refs = foreach_reference(torch, params, hyper)
        before = [p.clone() for p in params]
        launched = adamw.launches
        opt.step()
        if adamw.launches != launched + 1:
            raise AssertionError(f"U1 at {name}: {adamw.launches - launched} "
                                 "launches for one step")
        gaps = [0.0, 0.0, 0.0]
        for p, (c, r), p0 in zip(params, refs, before):
            s, g = opt.state[p], p.grad
            gaps = [max(gaps[0], max_ulps(torch, p, c,
                                          torch.maximum(c.abs(), p0.abs()))),
                    max(gaps[1], max_ulps(torch, s["exp_avg"], r["exp_avg"],
                                          g)),
                    max(gaps[2], max_ulps(torch, s["exp_avg_sq"],
                                          r["exp_avg_sq"], g * g))]
        if max(gaps) > 2:
            raise AssertionError(f"U1 at {name}: p, m, v {gaps} ulp from "
                                 "torch's foreach AdamW after one step")
        stats["ulps_p_m_v"] = gaps
        del refs, before
        torch.cuda.empty_cache()
        table, chunks, _ = opt._tables[(0, 0)][2:]
        stream = torch.cuda.current_stream(dev).cuda_stream

        def kernel():
            lib.tic_adamw(table.data_ptr(), len(table), chunks, 1 - 1e-7, 0.1,
                          0.999, 1e-3, 0.5, 1e-8, -1e-5, stream)

        reps = 10 if name == "vit_l" else 5
        stats.update(ms=cuda_ms(opt.step, warmup=3, reps=reps),
                     device_ms=device_ms(kernel, reps=reps))
        plain = torch.optim.AdamW(params, foreach=True, **hyper)
        stats["plain_ms"] = cuda_ms(plain.step, warmup=2, reps=reps)
        del plain
        torch.cuda.empty_cache()
        library = torch.optim.AdamW(params, fused=True, **hyper)
        stats["library_ms"] = cuda_ms(library.step, warmup=2, reps=reps)
        del library, opt, params, table
        torch.cuda.empty_cache()
        stats["bound_ms"], stats["bound_by"] = bound(0, ADAMW_BYTES * numel,
                                                     torch.float32)
        print(f"U1 AdamW at {name} ({numel / 1e6:.1f} M f32 parameters): one "
              f"step {stats['ms']:.3f} ms, kernel alone {stats['device_ms']:.3f} "
              f"ms device; torch foreach {stats['plain_ms']:.3f}, torch fused "
              f"{stats['library_ms']:.3f}; bound {stats['bound_ms']:.3f} ms "
              f"({stats['bound_by']}), share of the kernel "
              f"{stats['bound_ms'] / stats['device_ms']:.3f}, of the step "
              f"{stats['bound_ms'] / stats['ms']:.3f}; p, m, v within "
              f"{gaps} ulp of foreach")
        out[name] = stats
    return out


def layernorm_bytes(rows: int, width: int, backward: bool,
                    out_size: int = 2) -> int:
    """Bytes the LayerNorm pair moves with a bf16 x and an output (and dy)
    of ``out_size`` bytes, each read or written once: forward x and y (4 B
    an element in bf16), the mean and rstd written (8 B a row) and the f32
    scale and bias read; backward x, dy and dx (6 B), the statistics and
    the scale read, the two f32 gradients written."""
    if backward:
        return (4 + out_size) * rows * width + 8 * rows + 12 * width
    return (2 + out_size) * rows * width + 8 * rows + 8 * width


def phase_layernorm(torch, ln) -> dict:
    """N1, the LayerNorm pair (``csrc/layernorm.cu``) at ``LAYERNORM_SHAPES``
    (a bf16 x; y and dy bf16, or f32 for V-MoE's ``ln2``): y, dx, the
    scale's and bias's gradients against the plain version
    (``layer_norm_reference`` under autograd) within ``check_close``'s
    bounds of each output's dtype (the sums over rows within 1e-4 of their
    norm); one forward
    and one backward launch; device times (:func:`device_ms`) of the
    forward, the backward (its two kernels) and the pair, beside the bytes
    bound (:func:`layernorm_bytes`) and the plain version's forward and
    backward. The plain version is the library call, ``F.layer_norm`` on
    the f32 copy between its two casts (what the port ran before N1, and
    never calls on CUDA now), so its time is both ``plain_ms`` and
    ``library_ms``."""
    dev = torch.device("cuda", 0)
    out = {}
    for name, (rows, width, out_key) in LAYERNORM_SHAPES.items():
        out_dtype = getattr(torch, out_key)
        out_size = torch.finfo(out_dtype).bits // 8
        gen = torch.Generator(device=dev).manual_seed(SEED + 24)
        x = (1.5 * torch.randn(rows, width, generator=gen, device=dev)
             + 3.0 * torch.randn(rows, 1, generator=gen, device=dev)
             ).to(torch.bfloat16)
        w = 1.0 + 0.2 * torch.randn(width, generator=gen, device=dev)
        b = 0.1 * torch.randn(width, generator=gen, device=dev)
        dy = torch.randn(rows, width, generator=gen, device=dev).to(
            out_dtype)
        eps = 1e-12

        def under_autograd(fn):
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in (x, w, b)]
            y = fn(*leaves)
            y.backward(dy)
            return y.detach(), *(t.grad for t in leaves)

        launched = (ln.launches, ln.bwd_launches)
        got = under_autograd(lambda *t: ln.layer_norm(*t, eps, out_dtype))
        counts = (ln.launches - launched[0], ln.bwd_launches - launched[1])
        if counts != (1, 1):
            raise AssertionError(f"N1 at {name}: launches {counts} for one "
                                 "forward and backward")
        want = under_autograd(
            lambda *t: ln.layer_norm_reference(*t, eps, out_dtype))
        errs = {}
        for what, g, r, dt in zip(("y", "dx"), got[:2], want[:2],
                                  (out_dtype, torch.bfloat16)):
            if g.dtype != dt:
                raise AssertionError(f"N1 {what} at {name}: {g.dtype}, "
                                     f"expected {dt}")
            errs[what] = check_close(torch, f"N1 {what} at {name}", g, r, dt,
                                     verbose=False)
        for what, g, r in zip(("dweight", "dbias"), got[2:], want[2:]):
            rel = ((g - r).norm() / r.norm()).item()
            errs[what] = rel
            if rel > 1e-4:
                raise AssertionError(f"N1 {what} at {name}: relative {rel}")
        y, mean, rstd = ln.layer_norm_forward(x, w, b, eps, out_dtype)
        stats = {"rows": rows, "width": width, "out_dtype": out_key,
                 "max_abs_err": errs,
                 "fwd_device_ms": device_ms(
                     lambda: ln.layer_norm_forward(x, w, b, eps, out_dtype)),
                 "bwd_device_ms": device_ms(
                     lambda: ln.layer_norm_backward(x, dy, mean, rstd, w))}
        stats["device_ms"] = stats["fwd_device_ms"] + stats["bwd_device_ms"]
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, w, b)]

        def plain():
            ln.layer_norm_reference(*leaves, eps, out_dtype).backward(dy)

        stats["plain_ms"] = stats["library_ms"] = device_ms(plain)
        fwd_bound, _ = bound(0, layernorm_bytes(rows, width, False, out_size),
                             torch.bfloat16)
        bwd_bound, by = bound(0, layernorm_bytes(rows, width, True, out_size),
                              torch.bfloat16)
        stats.update(bound_ms=fwd_bound + bwd_bound, bound_by=by,
                     fwd_share=fwd_bound / stats["fwd_device_ms"],
                     bwd_share=bwd_bound / stats["bwd_device_ms"])
        print(f"N1 LayerNorm at {name} ({rows} x {width} bf16 -> "
              f"{out_key}): forward "
              f"{stats['fwd_device_ms']:.4f} ms ({stats['fwd_share']:.3f} of "
              f"its bound {fwd_bound:.4f}), backward "
              f"{stats['bwd_device_ms']:.4f} ms ({stats['bwd_share']:.3f} of "
              f"{bwd_bound:.4f}); pair {stats['device_ms']:.4f} against "
              f"plain (= library) {stats['plain_ms']:.4f}, bound "
              f"{stats['bound_ms']:.4f} ({by}); errors {errs}")
        out[name] = stats
        del x, dy, y, mean, rstd, leaves, got, want
        torch.cuda.empty_cache()
    return out


def phase_serve(torch, attn, serve, work: str, pth: str, data: str,
                layers: int) -> int:
    """The serve CLI, three ways; returns the kernel launches it made."""
    n_images = NUM_CLASSES * PER_CLASS
    forwards = -(-n_images // serve.BUCKETS[-1])
    attn.launches = 0
    zero_routes(attn)
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
    if attn.route_launches != model_routes(attn.launches, 0):
        raise AssertionError(f"serve: K1 launches by route "
                             f"{attn.route_launches}, expected all "
                             f"{attn.launches} on wgmma")
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
        if by_route != model_routes(made[0] + made[1], 0):
            raise AssertionError(f"serve {variant}: attention launches by "
                                 f"route {by_route}, expected all on wgmma")
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
    """The nvit train step through the port's Trainer on loader batches,
    one U1 launch and 49 N1 forward and backward launches each; returns the
    K1 and K2 launches of those steps."""
    from touhouimageclassification_tpu_torch.data import (image_loader,
                                                         random_split,
                                                         scan_image_folder)
    from touhouimageclassification_tpu_torch.ops import adamw, layernorm

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
    zero_counts(attn)
    for i in range(steps):
        before = (attn.launches, attn.bwd_launches, adamw.launches,
                  layernorm.launches, layernorm.bwd_launches)
        count = state.optimizer.count
        m = trainer.train_step(state, trainer.stage(next(batches)))
        made = (attn.launches - before[0], attn.bwd_launches - before[1])
        updates = adamw.launches - before[2]
        norms = (layernorm.launches - before[3],
                 layernorm.bwd_launches - before[4])
        print(f"nvit train step {i + 1}: loss {m['loss']:.6f}, grad_norm "
              f"{m['grad_norm']:.6f}, K1/K2 launches {made}, U1 launches "
              f"{updates}, N1 launches {norms}, lr {state.optimizer.lr:g}")
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
            raise AssertionError(f"step {i + 1}: non-finite loss or grad_norm")
        if state.optimizer.count != count + 1:
            raise AssertionError(f"step {i + 1} was skipped by the NaN guard")
        if made != (layers, layers):
            raise AssertionError(f"step {i + 1}: K1/K2 launches {made}, "
                                 f"expected {layers} each")
        if updates != 1:
            raise AssertionError(f"step {i + 1}: {updates} U1 launches")
        if norms != (2 * layers + 1, 2 * layers + 1):
            raise AssertionError(f"step {i + 1}: N1 launches {norms}, "
                                 f"expected {2 * layers + 1} each")
    check_updates("train", steps)
    check_layernorms("train", layers, steps, steps)
    launches = (attn.launches, attn.bwd_launches)
    if attn.route_launches != model_routes(*launches):
        raise AssertionError(f"train: K1/K2 launches by route "
                             f"{attn.route_launches}, expected K1 "
                             f"{launches[0]} on wgmma, K2 {launches[1]} on "
                             "wgmma")
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
                        f"{variant} batch-{b} step", trainer)
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
    zero_counts(attn)
    t0 = time.perf_counter()
    trainer = ntrain.main([*argv, "--no-resume"])
    fit_secs = time.perf_counter() - t0
    launches = (attn.launches, attn.bwd_launches)
    expect = (layers * (steps + val_batches), layers * steps)
    print(f"ntrain fit, 1 epoch: {steps} steps + {val_batches} val batches, "
          f"K1/K2 launches {launches} (expected {expect}), by route "
          f"{attn.route_launches}, {fit_secs:.2f} s")
    if launches != expect or attn.route_launches != model_routes(*launches):
        raise AssertionError("ntrain fit: K1/K2 launches or routes")
    if trainer.state.optimizer.count != steps:
        raise AssertionError(f"ntrain fit: {trainer.state.optimizer.count} "
                             f"updates in {steps} steps")
    check_updates("fit", steps)
    check_layernorms("fit", layers, steps + val_batches, steps)
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
            f"ResNet-152 batch-{b} step", trainer)
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
                           study.softmax_variant_forward(qkv, h, True, False)):
            raise AssertionError(f"fwd full, B {b}: differs from the "
                                 "mma.sync forward")
        if not torch.equal(
                study.slab_attention_peel_backward(qkv, g, h, "full"),
                mma_backward(torch, attn, qkv, g, h)):
            raise AssertionError(f"bwd full, B {b}: differs from the mma.sync "
                                 "backward")
        if b == 64:
            views = qkv.view(b, n, 3, h, c // h).unbind(2)
            sdpa_ms = cuda_ms(lambda: sdpa(torch, *views))
            leaf = qkv.detach().requires_grad_()
            sdpa_bwd_ms = sdpa_backward_ms(
                torch, (leaf,), leaf.view(b, n, 3, h, c // h).unbind(2), g)
    print(f"S5 and S6 vs plain at B {STUDY_BATCHES}: dma, layout and the "
          f"copies bit-equal; matmul and full within {TOL['bfloat16']} and "
          f"{REL_TOL['bfloat16']} in norm; full bit-equal to the mma.sync "
          f"forward and backward; max |diff| at B 64 {errs}")

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
            mma_twin = name != "S2" or (rec.get("exp2") and not rec["post_mul"])
            if "baseline" not in rec and (
                    (mma_twin and not rec["fwd_bit_equal_mma"])
                    or rec.get("bwd_bit_equal_mma") is False):
                raise AssertionError(f"{name} {rec}: not bit-equal to the "
                                     "mma.sync forward / backward")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    bf16 = torch.bfloat16
    fwd_tiles = (*study.FWD_TILES, study.SHIPPED_TILE)
    bwd_tiles = (*study.BWD_TILES, study.SHIPPED_TILE)
    shapes = [(b, 197) for b in STUDY_BATCHES] + list(TILE_EDGES)
    for b, n in shapes:
        qkv = torch.randn(b, n, 3 * c, generator=gen, device=dev).to(bf16)
        g = torch.randn(b, n, c, generator=gen, device=dev).to(bf16)
        mma_fwd = study.softmax_variant_forward(qkv, h, True, False)
        mma_bwd = study.slab_attention_peel_backward(qkv, g, h, "full")
        plain_fwd = attn.slab_attention_reference(qkv, h)
        plain_bwd = attn.slab_attention_backward_reference(qkv, g, h)
        for tile in fwd_tiles:
            out = study.slab_attention_tile_forward(qkv, h, tile)
            torch.cuda.synchronize()
            if not torch.equal(out, mma_fwd):
                raise AssertionError(f"fwd {tile}, B {b} N {n}: differs from "
                                     "the mma.sync forward")
            check_close(torch, f"fwd {tile}", out, plain_fwd, bf16,
                        verbose=False)
        for tile in bwd_tiles:
            out = study.slab_attention_tile_backward(qkv, g, h, tile)
            torch.cuda.synchronize()
            if not torch.equal(out, mma_bwd):
                raise AssertionError(f"bwd {tile}, B {b} N {n}: differs from "
                                     "the mma.sync backward")
            check_close(torch, f"bwd {tile}", out, plain_bwd, bf16,
                        verbose=False)
        for key in study.SOFTMAX_VARIANTS:
            out = study.softmax_variant_forward(qkv, h, *key)
            torch.cuda.synchronize()
            check_close(torch, f"softmax {key}", out,
                        study.softmax_variant_reference(qkv, h, *key), bf16,
                        verbose=False)
            if key == (True, False) and not torch.equal(out, mma_fwd):
                raise AssertionError(f"softmax {key}, B {b} N {n}: differs "
                                     "from its first launch")
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
    print(f"S1-S4 at (B, N) {shapes}: every tile bit-equal to the mma.sync "
          f"forward (S2's exp2 without post_mul) and backward and within "
          f"{TOL['bfloat16']} and {REL_TOL['bfloat16']} in norm of the plain "
          "versions; the S2 variants within the same bounds of theirs; N "
          f"{TILE_TOO_LONG} raises; tile_smem_bytes equals the C sums")

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
    """Set K1's, K2's, U1's and N1's launch counts and K1's and K2's routes
    to 0 before a path."""
    from touhouimageclassification_tpu_torch.ops import adamw, layernorm

    attn.launches = attn.bwd_launches = adamw.launches = 0
    layernorm.launches = layernorm.bwd_launches = 0
    zero_routes(attn)


def check_updates(path: str, expect: int) -> None:
    """U1's launches since :func:`zero_counts` must be ``expect``, one an
    optimizer update; kept in ``U1_LAUNCHES[path]``."""
    from touhouimageclassification_tpu_torch.ops import adamw

    print(f"{path}: U1 launches {adamw.launches} (expected {expect})")
    if adamw.launches != expect:
        raise AssertionError(f"{path}: {adamw.launches} U1 launches for "
                             f"{expect} updates")
    U1_LAUNCHES[path] = adamw.launches


def check_layernorms(path: str, layers: int, forwards: int,
                     backwards: int) -> None:
    """N1's launches since :func:`zero_counts` must be ViT-L's ``2 * layers
    + 1`` LayerNorms in each of ``forwards`` forwards and ``backwards``
    backwards (eager, captured or replayed alike); kept in
    ``LAYERNORM_LAUNCHES[path]``."""
    from touhouimageclassification_tpu_torch.ops import layernorm

    per = 2 * layers + 1
    made = [layernorm.launches, layernorm.bwd_launches]
    expect = [per * forwards, per * backwards]
    print(f"{path}: N1 launches {made} (expected {expect})")
    if made != expect:
        raise AssertionError(f"{path}: N1 launches {made} for {forwards} "
                             f"forwards and {backwards} backwards of "
                             f"{per} LayerNorms")
    LAYERNORM_LAUNCHES[path] = made


def read_counts(attn, what: str, expect: tuple[int, int]) -> tuple[int, int]:
    """K1's and K2's launches since :func:`zero_counts`: they must be
    ``expect``, every forward and every backward on the wgmma route
    (bf16)."""
    made = (attn.launches, attn.bwd_launches)
    print(f"{what}: K1/K2 launches {made} (expected {expect}), by route "
          f"{attn.route_launches}")
    if made != expect or attn.route_launches != model_routes(*made):
        raise AssertionError(f"{what}: K1/K2 launches {made}, routes "
                             f"{attn.route_launches}, expected {expect} "
                             "(forwards and backwards on wgmma)")
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
            f"{what} batch-{b} step", trainer)
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
    SDPA and its autograd backward (K2 also beside its mma.sync kernel) and
    the bytes bound."""
    from touhouimageclassification_tpu_torch.ops import attention_study as study

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
                           lambda: attn.slab_attention_backward(qkv, g, h),
                           BWD_ROUTES)
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
        library = sdpa_backward(torch, (leaf,), leaf.view(
            b, n, 3, h, c // h).unbind(2), g)
        bwd["library_ms"] = cuda_ms(library)
        bwd["library_device_ms"] = device_ms(library)
        bwd["mma_device_ms"] = device_ms(
            lambda: study.slab_attention_peel_backward(qkv, g, h, "full"))
        for rec, backward in ((fwd, False), (bwd, True)):
            rec["bound_ms"], rec["bound_by"] = attention_bound(
                b, n, c, h, torch.bfloat16, backward)
            rec["share_of_bound"] = rec["bound_ms"] / rec["device_ms"]
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
                o["routes"] != model_routes(DP_K1 * DP_STEPS,
                                            DP_K1 * DP_STEPS):
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
                o["routes"] != model_routes(EP_K1, EP_K1):
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


# phase 18: the options that last joined the port
REMAT_POLICIES = {"off": {}, "full": {"remat": True},
                  "dots": {"remat": True, "remat_policy": "dots"}}
REMAT_BATCH = 64
REMAT_GRAD_RTOL = 1e-5     # f32, no TF32: the recompute is the same math
BN_GRAD_RTOL = 1e-4        # 'batch' against flax's BatchNorm, f32, per leaf
BN_LOSS_RTOL = 1e-5        # the two ResNet-152s' step-1 loss, f32
# one BatchNorm of each stage of ResNet-152, checked on the inputs a forward
# hands it
BN_CHECKED = ("bn1", "layer1.0.bn1", "layer2.0.downsample.1", "layer3.17.bn2",
              "layer4.2.bn3")
SPC_K = 4                  # steps_per_call
SPC_STEPS = 8
SPC_BATCH = 8


def leaf_rel(torch, got: dict, ref: dict) -> list:
    """[(relative difference in norm, name)] of two gradient dicts, largest
    last."""
    return sorted((((got[k] - ref[k]).norm() / ref[k].norm().clamp_min(
        1e-30)).item(), k) for k in ref)


def step_grads(trainer, state, batch) -> tuple[float, dict]:
    """The loss and the gradients of one train step's forward and backward
    (the step's own augmentation, mixup and loss), not applied."""
    state.model.zero_grad(set_to_none=True)
    loss = trainer._loss_and_grads(state, batch)[0].item()
    grads = {k: p.grad.detach().clone()
             for k, p in state.model.named_parameters()}
    state.model.zero_grad(set_to_none=True)
    return loss, grads


def phase_remat(torch, attn, create_model, Trainer, state_dict, data: str,
                layers: int, dev) -> dict:
    """18(a): ViT-L nvit, 'fused', batch 64, remat off / 'full' / 'dots':
    img/s over 5 steps after 2, peak memory, K1/K2 launches a step, a
    profile of one more step (device time against wall time); then
    step 1's gradients of 'full' and 'dots' against remat off in f32 without
    TF32. Returns the K1/K2 launches of each policy's 5 timed steps."""
    rng = np.random.default_rng(SEED + 18)
    host = {"image": rng.integers(0, 256, (REMAT_BATCH, 256, 256, 3),
                                  dtype=np.uint8),
            "label": rng.integers(0, NUM_CLASSES, REMAT_BATCH).astype(
                np.int32),
            "mask": np.ones(REMAT_BATCH, bool)}
    cfg = nvit_config(data, global_batch_size=REMAT_BATCH)
    launches, peaks, reserved = {}, {}, {}
    for policy, over in REMAT_POLICIES.items():
        model = create_model("vit-large", num_classes=NUM_CLASSES,
                             compute_dtype="bfloat16", param_dtype="float32",
                             device=dev, **VARIANTS["fused"], **over)
        model.load_state_dict(state_dict)
        trainer = Trainer(cfg, model=model, device=dev)
        state = trainer.init_state()
        batch = trainer.stage(host)
        # the allocated peak from before the first steps, which run eagerly
        # and capture the step's CUDA graph: replays allocate nothing, their
        # activations live in the graph's pool, which the reserved peak over
        # the replays holds
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(2):
            trainer.train_step(state, batch)
        torch.cuda.synchronize()
        first = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts(attn)
        t0 = time.perf_counter()
        for _ in range(5):
            m = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peaks[policy] = max(first, torch.cuda.max_memory_allocated(dev)) / 2 ** 30
        reserved[policy] = torch.cuda.memory_stats(dev)[
            "reserved_bytes.all.peak"] / 2 ** 30
        if trainer.graph_replays != 6:
            raise AssertionError(f"remat {policy}: {trainer.graph_replays} "
                                 "replays in 7 steps, expected 6")
        k1 = 2 * layers if over else layers
        launches[policy] = read_counts(
            attn, f"18(a) remat {policy}, 5 steps", (5 * k1, 5 * layers))
        print(f"18(a) nvit 'fused' batch {REMAT_BATCH}, remat {policy}: "
              f"{5 * REMAT_BATCH / secs:.2f} img/s ({1e3 * secs / 5:.2f} "
              f"ms/step), peak memory {peaks[policy]:.3f} GiB allocated, "
              f"{reserved[policy]:.3f} GiB reserved, K1/K2 a step "
              f"{launches[policy][0] // 5}/{launches[policy][1] // 5}, last "
              f"loss {m['loss']:.4f}")
        if not np.isfinite(m["loss"]):
            raise AssertionError(f"remat {policy}: non-finite loss")
        profile(torch, lambda: trainer.train_step(state, batch),
                f"remat {policy} batch-{REMAT_BATCH} step", trainer)
        del trainer, state, model, batch
        gc.collect()
        torch.cuda.empty_cache()
    for what, read in (("allocated", peaks), ("reserved", reserved)):
        if not read["full"] < read["dots"] < read["off"]:
            raise AssertionError(f"peak memory {what} by policy {read}: "
                                 "expected full < dots < off")

    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grads = {}
    for policy, over in REMAT_POLICIES.items():
        model = create_model("vit-large", num_classes=NUM_CLASSES,
                             compute_dtype="float32", param_dtype="float32",
                             device=dev, **VARIANTS["fused"], **over)
        model.load_state_dict(state_dict)
        trainer = Trainer(cfg, model=model, device=dev)
        state = trainer.init_state()
        grads[policy] = step_grads(trainer, state, trainer.stage(host))[1]
        del trainer, state, model
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    for policy in ("full", "dots"):
        rel = leaf_rel(torch, grads[policy], grads["off"])
        print(f"18(a) step-1 gradients, remat {policy} vs off (f32, no TF32, "
              f"batch {REMAT_BATCH}): worst leaf {rel[-1][0]:.3e} "
              f"({rel[-1][1]}), median {rel[len(rel) // 2][0]:.3e}, bound "
              f"{REMAT_GRAD_RTOL}")
        if rel[-1][0] > REMAT_GRAD_RTOL:
            raise AssertionError(f"remat {policy}: gradients off by "
                                 f"{rel[-1]}")
    del grads
    torch.cuda.empty_cache()
    return launches


def bn_module_check(torch, flax, host, cfg, Trainer, dev) -> None:
    """18(b): the 'batch' variant against flax's BatchNorm2d, one module of
    each ResNet-152 stage (``BN_CHECKED``) on the input a train-mode f32
    forward of the step's images hands it, with a seeded upstream gradient:
    output, running statistics and the gradients of the input, scale and
    bias within ``BN_GRAD_RTOL`` each (relative, in norm). A whole
    random-init ResNet-152's train-mode gradient is ill-conditioned (its
    parameters moved by one ulp move it by percents), so the variant is
    held to flax at that bound here, layer by layer."""
    from touhouimageclassification_tpu_torch.models.resnet import BatchNorm2d
    from touhouimageclassification_tpu_torch.ops.batchnorm import \
        BatchNormVariant

    modules = dict(flax.named_modules())
    inputs = {}
    hooks = [modules[name].register_forward_pre_hook(
        lambda m, args, name=name: inputs.setdefault(name,
                                                     args[0].detach().clone()))
        for name in BN_CHECKED]
    trainer = Trainer(cfg, model=flax, device=dev)
    x = trainer.eval_transform(trainer.stage(host)["image"].float() / 255.0)
    with torch.no_grad():
        flax.train()(x)
    for h in hooks:
        h.remove()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = []
    for name in BN_CHECKED:
        x = inputs[name]
        g = torch.randn(x.shape, generator=gen, device=dev).to(
            memory_format=torch.channels_last)
        sd = modules[name].state_dict()
        outs = []
        for m in (BatchNorm2d(x.shape[1], device=dev),
                  BatchNormVariant(x.shape[1], "batch", device=dev)):
            m.load_state_dict(sd)
            leaf = x.clone().requires_grad_()
            y = m.train()(leaf)
            y.backward(g)
            outs.append({"y": y.detach(), "dx": leaf.grad, "dscale":
                         m.weight.grad, "dbias": m.bias.grad,
                         "running_mean": m.running_mean,
                         "running_var": m.running_var})
        rel = leaf_rel(torch, outs[1], outs[0])
        worst.append((rel[-1][0], f"{name} {rel[-1][1]}"))
        print(f"18(b) 'batch' vs flax BatchNorm2d at {name} {tuple(x.shape)} "
              f"(f32): " + ", ".join(f"{k} {r:.2e}" for r, k in rel))
    del inputs, trainer
    if max(worst)[0] > BN_GRAD_RTOL:
        raise AssertionError(f"'batch' vs flax BatchNorm: {max(worst)}")


def phase_bn_variants(torch, create_model, Trainer, data: str, dev) -> dict:
    """18(b): ResNet-152 at 256x256, the resnet152 preset at batch 80, with
    each bn_variant, from one seeded initialisation whose BN statistics are
    calibrated on 16 of the batch's images (from (0, 1), 'stale' would
    normalise nothing and overflow at once): eval logits of every variant
    equal to 'flax''s; step 1's gradients of 'batch' against 'flax' in f32;
    then img/s over 5 steps after 2, peak memory, the running statistics
    moved and the steps the NaN guard skipped."""
    from touhouimageclassification_tpu_torch.config import PRESETS
    from touhouimageclassification_tpu_torch.models.resnet import BN_VARIANTS

    cfg = dataclasses.replace(PRESETS["resnet152"], data_dir=data, seed=SEED)
    b = cfg.global_batch_size
    rng = np.random.default_rng(SEED + 19)
    host = {"image": rng.integers(0, 256, (b, 256, 256, 3), dtype=np.uint8),
            "label": rng.integers(0, NUM_CLASSES, b).astype(np.int32),
            "mask": np.ones(b, bool)}

    def resnet(variant, dtype="bfloat16", weights=None):
        model = create_model("resnet152", num_classes=NUM_CLASSES, device=dev,
                             compute_dtype=dtype, param_dtype="float32",
                             seed=SEED, bn_variant=variant)
        if weights is not None:
            model.load_state_dict(weights)
        return model

    flax = resnet("flax", "float32")
    trainer = Trainer(cfg, model=flax, device=dev)
    x = trainer.eval_transform(trainer.stage(host)["image"][:16].float()
                               / 255.0)
    calibrate_bn(torch, flax, x)
    weights = {k: v.clone() for k, v in flax.state_dict().items()}
    del trainer, flax
    logits = {}
    for variant in BN_VARIANTS:
        model = resnet(variant, weights=weights)
        with torch.inference_mode():
            logits[variant] = model.eval()(x)
        del model
    same = {v: torch.equal(logits[v], logits["flax"]) for v in BN_VARIANTS}
    finite = bool(torch.isfinite(logits["flax"]).all())
    print(f"18(b) eval logits (bf16, BN calibrated on 16 images) equal to "
          f"'flax''s: {same}; finite: {finite}")
    if not all(same.values()) or not finite:
        raise AssertionError("a variant's eval logits differ from 'flax''s")
    del logits, x

    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bn_module_check(torch, resnet("flax", "float32", weights), host, cfg,
                    Trainer, dev)
    # the whole model's step-1 gradient moves by a few percent when its
    # parameters move by one ulp (channels whose mean dwarfs their spread
    # amplify any rounding): 'batch' is held to that spread of flax's
    nudged = {k: v if "running" in k else torch.nextafter(
        v, torch.full_like(v, float("inf"))) for k, v in weights.items()}
    losses, grads = {}, {}
    for run, variant, start in (("flax", "flax", weights),
                                ("flax nudged", "flax", nudged),
                                ("batch", "batch", weights)):
        trainer = Trainer(cfg, model=resnet(variant, "float32", start),
                          device=dev)
        state = trainer.init_state()
        losses[run], grads[run] = step_grads(trainer, state,
                                             trainer.stage(host))
        del trainer, state
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    dloss = abs(losses["batch"] / losses["flax"] - 1)
    rel = {}
    for run in ("flax nudged", "batch"):
        rel[run] = r = leaf_rel(torch, grads[run], grads["flax"])
        print(f"18(b) whole model, step 1 (f32, no TF32, batch {b}), {run} "
              f"vs flax: loss {losses[run]:.7f} vs {losses['flax']:.7f}; "
              f"gradient by leaf: worst {r[-1][0]:.3e} ({r[-1][1]}), median "
              f"{r[len(r) // 2][0]:.3e}")
    spread, got = rel["flax nudged"], rel["batch"]
    if (dloss > BN_LOSS_RTOL or got[-1][0] > max(BN_GRAD_RTOL,
                                                 4 * spread[-1][0])
            or got[len(got) // 2][0] > max(BN_GRAD_RTOL,
                                           4 * spread[len(spread) // 2][0])):
        raise AssertionError(f"'batch' vs 'flax' whole step: loss off by "
                             f"{dloss}, gradients {got[-1]} beyond 4x the "
                             f"nudged spread {spread[-1]}")
    del grads, nudged

    out = {}
    for variant in BN_VARIANTS:
        model = resnet(variant, weights=weights)
        trainer = Trainer(cfg, model=model, device=dev)
        state = trainer.init_state()
        batch = trainer.stage(host)
        first = trainer.train_step(state, batch)
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        losses = [trainer.train_step(state, batch)["loss"] for _ in range(5)]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        moved = sum(not torch.equal(v, weights[k])
                    for k, v in model.state_dict().items() if "running" in k)
        stats = sum("running" in k for k in weights)
        skipped = state.step - state.optimizer.count
        out[variant] = {"img_s": 5 * b / secs, "peak_gib": peak,
                        "skipped": skipped}
        print(f"18(b) ResNet-152 train, bn_variant {variant}, batch {b} at "
              f"256x256: {5 * b / secs:.2f} img/s ({1e3 * secs / 5:.2f} "
              f"ms/step), peak memory {peak:.3f} GiB, losses "
              f"{first['loss']:.4f} ... {losses[-1]:.4f}, steps the NaN "
              f"guard skipped {skipped} of {state.step}, running statistics "
              f"moved {moved} of {stats}")
        # 'stale' may diverge within a few steps from scratch, as the JAX
        # package found: its first step must train, later ones may be skipped
        if (not np.isfinite(first["loss"]) or moved != stats
                or (variant != "stale" and skipped)):
            raise AssertionError(f"bn_variant {variant}: steps not finite, "
                                 "skipped or statistics unmoved")
        del trainer, state, model, batch
        gc.collect()
        torch.cuda.empty_cache()
    return out


def count_syncs(torch, fn):
    """(fn(), the synchronising CUDA calls it made): torch's sync debug
    mode warns on each."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def phase_steps_per_call(torch, attn, create_model, Trainer, state_dict,
                         data: str, layers: int, dev) -> tuple[int, int]:
    """18(c): 8 nvit steps at batch 8 as two calls of k = 4 against 8
    single steps from one seed: parameters, optimizer state and counters
    bit for bit, the calls' metrics the single steps' means, one host sync a
    call; img/s of both, of fresh trainers and warm (in turns); a NaN batch
    inside a call skipped on the device. Returns the K1/K2 launches of the
    two k = 4 calls."""
    rng = np.random.default_rng(SEED + 20)
    host = [{"image": rng.integers(0, 256, (SPC_BATCH, 256, 256, 3),
                                   dtype=np.uint8),
             "label": rng.integers(0, NUM_CLASSES, SPC_BATCH).astype(
                 np.int32),
             "mask": np.ones(SPC_BATCH, bool)} for _ in range(SPC_STEPS)]

    def make(k):
        cfg = nvit_config(data, global_batch_size=SPC_BATCH,
                          steps_per_call=k)
        trainer = Trainer(cfg, model=train_model(create_model, state_dict,
                                                 "fused", dev), device=dev)
        trainer.init_state()
        return trainer

    def snapshot(trainer):
        st = trainer.state
        out = {f"p:{k}": v.detach().clone()
               for k, v in st.model.named_parameters()}
        names = {id(p): k for k, p in st.model.named_parameters()}
        for p, s in st.optimizer.inner.state.items():
            for key, v in s.items():
                out[f"{key}:{names[id(p)]}"] = v.clone()
        return out, (st.step, st.optimizer.count)

    def worst(a, b):
        if a[1] != b[1] or a[0].keys() != b[0].keys():
            return float("inf")
        return max(((a[0][k].float() - b[0][k].float()).abs().max()
                    / b[0][k].float().abs().max().clamp_min(1e-30)).item()
                   for k in a[0])

    single = make(1)
    batches = [single.stage(h) for h in host]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    per_step, single_syncs = [], []
    for b in batches:
        m, n = count_syncs(torch, lambda: single.train_step(single.state, b))
        per_step.append(m)
        single_syncs.append(n)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    ref = snapshot(single)
    grouped = make(SPC_K)
    batches = [grouped.stage(h) for h in host]
    zero_counts(attn)
    syncs, debug_syncs, means = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for g in range(0, SPC_STEPS, SPC_K):
        before = grouped.host_syncs
        m, n = count_syncs(torch, lambda: grouped.train_steps(
            grouped.state, batches[g:g + SPC_K]))
        syncs.append(grouped.host_syncs - before)
        debug_syncs.append(n)
        means.append(m)
    torch.cuda.synchronize()
    grouped_s = time.perf_counter() - t0
    launches = read_counts(attn, "18(c) steps_per_call 4, 8 steps",
                           (SPC_STEPS * layers, SPC_STEPS * layers))
    check_updates("steps_per_call", SPC_STEPS)
    check_layernorms("steps_per_call", layers, SPC_STEPS, SPC_STEPS)
    got = snapshot(grouped)
    diff = worst(got, ref)
    # once warm: a fresh process's or trainer's first steps make one-time
    # syncs (constants made at first use, the allocator growing)
    warm_syncs = [count_syncs(torch, lambda: grouped.train_steps(
        grouped.state, batches[g:g + SPC_K]))[1]
        for g in range(0, SPC_STEPS, SPC_K)]

    def rate(k):
        """img/s of SPC_STEPS warm steps, as k-step calls."""
        trainer = grouped if k > 1 else single
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for g in range(0, SPC_STEPS, k):
            trainer.train_steps(trainer.state, batches[g:g + k])
        torch.cuda.synchronize()
        return SPC_STEPS * SPC_BATCH / (time.perf_counter() - t0)

    # in turns, k=1, k=4, k=4, k=1, twice
    warm = {1: [], SPC_K: []}
    for _ in range(2):
        for k in (1, SPC_K, SPC_K, 1):
            warm[k].append(rate(k))
    del single
    want = [{k: float(np.mean([m[k] for m in per_step[g:g + SPC_K]]))
             for k in per_step[0]} for g in range(0, SPC_STEPS, SPC_K)]
    mdiff = max(abs(m[k] - w[k]) for m, w in zip(means, want) for k in w)
    print(f"18(c) nvit batch {SPC_BATCH}, {SPC_STEPS} steps as k=4 vs k=1: "
          f"largest relative difference of parameters and AdamW state "
          f"{diff:.3e} (step, update count {got[1]} vs {ref[1]}); call "
          f"metrics vs the single steps' means: largest "
          f"|diff| {mdiff:.3e}; host syncs a call {syncs} (the trainer's "
          f"count), counted by torch's sync debug mode {debug_syncs}, then "
          f"{warm_syncs} in two more calls (a k=1 step: {single_syncs}); "
          f"{SPC_STEPS * SPC_BATCH / grouped_s:.2f} img/s k=4 vs "
          f"{SPC_STEPS * SPC_BATCH / single_s:.2f} img/s k=1 (the first "
          f"steps of fresh trainers); warm, in turns: k=4 "
          f"{statistics.median(warm[SPC_K]):.2f} img/s (median of "
          f"{[round(r, 2) for r in warm[SPC_K]]}) vs k=1 "
          f"{statistics.median(warm[1]):.2f} ({[round(r, 2) for r in warm[1]]}); "
          f"printed only")
    if (diff != 0 or mdiff != 0 or syncs != [1, 1]
            or warm_syncs != [1, 1]):
        raise AssertionError("steps_per_call=4 differs from 4 single steps")
    del grouped

    for poison in (1, SPC_K - 1):
        bad = dict(host[poison], image=host[poison]["image"].astype(
            np.float32))
        bad["image"][0, 0, 0, 0] = np.nan
        group = host[:poison] + [bad] + host[poison + 1:SPC_K]
        single = make(1)
        ms = [single.train_step(single.state, single.stage(h))
              for h in group]
        ref = snapshot(single)
        del single
        grouped = make(SPC_K)
        m = grouped.train_steps(grouped.state,
                                [grouped.stage(h) for h in group])
        got = snapshot(grouped)
        diff = worst(got, ref)
        print(f"18(c) NaN batch at {poison} of a k=4 call: loss mean "
              f"{m['loss']}, (step, update count) {got[1]} vs {ref[1]} by "
              f"single steps, largest relative difference {diff:.3e}")
        if (diff != 0 or got[1] != (SPC_K, SPC_K - 1)
                or np.isfinite(m["loss"]) or np.isfinite(ms[poison]["loss"])):
            raise AssertionError("the NaN batch inside a call was not "
                                 "skipped as a single step skips it")
        del grouped
    torch.cuda.empty_cache()
    return launches


def phase_warmup(torch, attn, serve, export: str, data: str,
                 layers: int) -> int:
    """18(d): Predictor.warmup on the ViT-L export (phase 11): seconds, K1
    launches (one a layer a bucket), then the first predict_array. Returns
    warmup's K1 launches."""
    pred = serve.init(modelt="vit-large", weights=export, data_dir=data,
                      device="cuda")
    zero_counts(attn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred.warmup()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    made = read_counts(attn, "18(d) Predictor.warmup, buckets "
                       f"{serve.BUCKETS}", (layers * len(serve.BUCKETS), 0))
    img = np.random.default_rng(SEED + 21).integers(0, 256, (1, 224, 224, 3),
                                                    dtype=np.uint8)
    zero_counts(attn)
    t0 = time.perf_counter()
    pred.predict_array(img)
    first_ms = (time.perf_counter() - t0) * 1e3
    read_counts(attn, "18(d) first predict_array", (layers, 0))
    print(f"18(d) warmup of the ViT-L export: {secs:.3f} s for buckets "
          f"{serve.BUCKETS}; the first predict_array after it "
          f"{first_ms:.3f} ms")
    del pred
    torch.cuda.empty_cache()
    return made[0]


def phase_options(torch, attn, serve, create_model, Trainer, state_dict,
                  data: str, export: str, layers: int, dev) -> dict:
    """Phase 18: the remat policies, the BatchNorm variants, steps_per_call
    and Predictor.warmup on the card. Returns K1/K2 launches by path."""
    t0 = time.perf_counter()
    remat = phase_remat(torch, attn, create_model, Trainer, state_dict, data,
                        layers, dev)
    phase_bn_variants(torch, create_model, Trainer, data, dev)
    spc = phase_steps_per_call(torch, attn, create_model, Trainer,
                               state_dict, data, layers, dev)
    warm = phase_warmup(torch, attn, serve, export, data, layers)
    print(f"phase 18: {time.perf_counter() - t0:.1f} s")
    return {**{f"remat_{p}": n for p, n in remat.items()},
            "steps_per_call": spc, "warmup": (warm, 0)}


def credited_launches() -> tuple[int, int, int]:
    """The forward (K1, K3, K4), backward (K2, K3) and K5 launches the
    port's counters hold."""
    from touhouimageclassification_tpu_torch.ops import attention as attn
    from touhouimageclassification_tpu_torch.ops import patch_embed as pe

    return (attn.launches + attn.packed_launches + attn.flash_launches,
            attn.bwd_launches + attn.packed_bwd_launches, pe.launches)


def profile(torch, fn, label: str, trainer=None):
    """Device time by kernel of one ``fn()`` (a train step or a serve
    forward), and the device's busy share of its wall time. Given the
    ``trainer`` of a train step: that the step replayed its CUDA graph
    (unless its shape fell back to eager) and that the attention and patch
    embedding kernels in the trace are the launches credited to it, K2 one
    or two kernels a launch (its one- or two-launch form)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    before = credited_launches()
    replays = trainer.graph_replays if trainer is not None else 0
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
    # the attention kernels' share: K1 (attention_fwd_*), K2 (attention_bwd_*)
    attention = {way: sum(e.self_device_time_total for e in events
                          if f"attention_{way}_" in e.key) / 1e3
                 for way in ("fwd", "bwd")}
    print(f"profile, one {label}: wall {wall_ms:.3f} ms (profiler on), "
          f"device kernels {device_ms:.3f} ms, busy share "
          f"{device_ms / wall_ms:.3f}; attention kernels forward "
          f"{attention['fwd']:.3f} ms, backward {attention['bwd']:.3f} ms "
          f"({card_line()})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d} x  "
              f"{e.key[:90]}")
    if trainer is None:
        return
    kernels = tuple(sum(e.count for e in events if name in e.key)
                    for name in ("attention_fwd_", "attention_bwd_",
                                 "patch_embed_"))
    credited = tuple(a - b for a, b in zip(credited_launches(), before))
    replayed = trainer.graph_replays - replays
    print(f"  {label}: replayed {replayed} (fallbacks "
          f"{trainer.graph_fallbacks}); forward/backward/K5 kernels in the "
          f"trace {kernels}, launches credited {credited}")
    if (replayed != (0 if trainer.graph_fallbacks else 1)
            or kernels[0] != credited[0] or kernels[2] != credited[2]
            or kernels[1] not in (credited[1], 2 * credited[1])):
        raise AssertionError(f"{label}: replayed {replayed}, kernels "
                             f"{kernels} against credited {credited}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from touhouimageclassification_tpu_torch.config import vit_config
    from touhouimageclassification_tpu_torch.infer import serve
    from touhouimageclassification_tpu_torch.models import create_model
    from touhouimageclassification_tpu_torch.ops import (_build, adamw,
                                                         layernorm)
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

    stats = {"K1": phase_kernels(torch, attn, study),
             "K2": phase_backward(torch, attn, study),
             **phase_three_operand_kernels(torch, attn),
             "K5": phase_patch_embed(torch, pe)}
    packed_launches = phase_packed_op(torch, attn)
    phase_fresh_thread(torch, attn, pe)
    adamw_stats = phase_adamw(torch, adamw, _build.load_library())
    launched = (layernorm.launches, layernorm.bwd_launches)
    layernorm_stats = phase_layernorm(torch, layernorm)
    LAYERNORM_LAUNCHES["smoke"] = [layernorm.launches - launched[0],
                                   layernorm.bwd_launches - launched[1]]

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
        option_launches = phase_options(torch, attn, serve, create_model,
                                        Trainer, state_dict, data, vit_export,
                                        layers, dev)
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
        ("K1", "slab_attention_fwd", "slab_attention_fwd_sm90.cu",
         "attention.py:455", {"serve": serve_launches,
                              "train": train_launches[0],
                              "fit": fit_launches[0],
                              **loading_launches,
                              **pipeline_launches,
                              **{path: k1 for path, (k1, _) in
                                 mix_launches.items()},
                              **{path: k1 for path, (k1, _) in
                                 multi_launches.items()},
                              **{path: k1 for path, (k1, _) in
                                 option_launches.items()}}, "fit"),
        ("K2", "slab_attention_bwd", "slab_attention_bwd_sm90.cu",
         "attention.py:482", {"train": train_launches[1],
                              "fit": fit_launches[1],
                              **{path: k2 for path, (_, k2) in
                                 mix_launches.items() if k2},
                              **{path: k2 for path, (_, k2) in
                                 multi_launches.items() if k2},
                              **{path: k2 for path, (_, k2) in
                                 option_launches.items() if k2}}, "fit"),
        ("K3 fwd", "packed_attention_fwd", "slab_attention_fwd_sm90.cu",
         "attention.py:253", {"packed_attention": packed_launches[0]},
         "packed_attention"),
        ("K3 bwd", "packed_attention_bwd", "slab_attention_bwd_sm90.cu",
         "attention.py:309", {"packed_attention": packed_launches[1]},
         "packed_attention"),
        ("K4", "flash_attention_fwd", "slab_attention_fwd_sm90.cu",
         "attention.py:38", {"serve": flash_serve[0],
                             "train": flash_train[0]}, "train"),
        ("K5", "patch_embed", "patch_embed.cu", "patch_embed.py:22",
         {"serve": flash_serve[1], "train": flash_train[1]}, "train"),
    ]
    # the device route each wrapper names for ViT-L's shapes, by dtype (the
    # forwards' bf16 launches at other head dims or N > 256 go to mma, in
    # slab_attention_fwd.cu, as their f32 launches do to simt)
    device_routes = {
        key: {dtype_key(dt): (pe.kernel_route(dt, 16, 3, 224) if key == "K5"
                              else attn.kernel_route(dt, 64, 197,
                                                     key in ("K2", "K3 bwd")))
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
        + [{"name": "adamw", "route": "cuda", "source": csrc + "adamw.cu",
            "device_routes": {"float32": "simt"},
            "replaces": "none (optax.adamw, fused by XLA)",
            "launches": U1_LAUNCHES["fit"],
            "launches_by_path": U1_LAUNCHES, **adamw_stats["vit_l"],
            "vmoe": adamw_stats["vmoe"]},
           {"name": "layernorm", "route": "cuda",
            "source": csrc + "layernorm.cu",
            "device_routes": {"bfloat16": "simt", "float32": "simt"},
            "replaces": "none (flax LayerNorm, fused by XLA with its casts)",
            "launches": LAYERNORM_LAUNCHES["fit"],
            "launches_by_path": LAYERNORM_LAUNCHES,
            **layernorm_stats["vitl_b256"],
            "shapes": layernorm_stats}]
        + study_kernels + tile_kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2:]))
    sys.exit(main())
