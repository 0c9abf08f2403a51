#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's serve path and its train step
(``touhouimageclassification_tpu_torch``) at the full width and depth of
ViT-Large/16 at 224x224 with random weights made from a seed, through the
entry points a user would call: with the default configuration
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
5. the same for the three-operand attention (K3, forward and backward), the
   (B, N, H, D) attention forward (K4, on the q, k, v views of a QKV slab,
   as the model hands them) and the patch embedding (K5, against
   ``F.conv2d``), then ``packed_attention`` (K3's op) once under autograd;
6. run ``infer.serve.main`` on a 120-class fixture ImageFolder: ``--full``
   without and with the canvas cache (which resizes on the device), then one
   single image; check the CSVs and that every forward launched K1 once per
   encoder layer;
7. compare the whole model on the same weights and images: plain attention
   and 'flash' + 'pallas' against the default; time bucket-1 latency and
   bucket-64 throughput of each, counting K4 and K5 launches per forward;
   profile one bucket-64 'fused' forward;
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
    and K5 launches per step, and profiles of one batch-64 step of 'fused'
    and of 'flash' + 'pallas' and one batch-8 'fused' step.

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout of the
repository, the script exits non-zero before printing either.
"""
from __future__ import annotations

import csv
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
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
# 'pallas' by the patch embedding's one rounding (f32 bias) where the
# default rounds twice; the residual stream carries those differences to the
# head. Random weights give logits of order 1, so 5e-2 is a few percent of
# their spread; argmax must agree wherever the top-2 margin exceeds it.
LOGIT_TOL = 5e-2
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


def on_route(attn, dtype, launches: int, run):
    """``run()``, which makes ``launches`` kernel launches: every one must
    take the dtype's route (bf16 ``mma``, f32 ``simt``). Returns its
    result."""
    want = ROUTES[dtype_key(dtype)]
    before = dict(attn.route_launches)
    out = run()
    made = {r: attn.route_launches[r] - before[r] for r in before}
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


def phase_three_operand_kernels(torch, attn, pe):
    """K3 (forward and backward), K4 and K5 against their plain versions at
    the shapes their callers give them, in bf16 at ViT-L batch 64 and in f32
    at a small odd shape; times at batch 64 in bf16 beside their plain
    versions, the one PyTorch call that computes the same function, and
    their bounds. Returns {kernel: summary}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    F = torch.nn.functional
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device=dev)).to(dtype)

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

    # K5 on the model's operands: NHWC images in the compute dtype, the
    # (D, P*P*C) nn.Linear weight and the bias, cast to it
    patch, d = 16, 1024
    for name, b, dtype in [("vit-l batch 64", 64, bf16),
                           ("vit-l batch 2", 2, f32)]:
        images = randn(b, 224, 224, 3, dtype=dtype)
        weight = randn(d, patch * patch * 3, dtype=dtype, scale=0.02)
        bias = randn(d, dtype=dtype, scale=0.02)
        before = pe.launches
        fwd = pe.patch_embed_forward(images, weight, bias, patch)
        launched([(pe, "launches")], (before + 1,))
        err = check_close(torch, f"K5 vs plain, {name}", fwd,
                          pe.patch_embed_reference(images, weight, bias, patch),
                          dtype)
        if b == 64:
            conv_w = weight.view(d, patch, patch, 3).permute(0, 3, 1, 2)
            nchw = images.permute(0, 3, 1, 2)
            m, kk = b * (224 // patch) ** 2, patch * patch * 3
            bound_ms, bound_by = bound(
                2 * m * kk * d, 2 * (images.numel() + weight.numel() + d + m * d),
                dtype)
            out["K5"] = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: pe.patch_embed_forward(images, weight, bias,
                                                          patch)),
                plain_ms=cuda_ms(lambda: pe.patch_embed_reference(
                    images, weight, bias, patch)),
                library_ms=cuda_ms(lambda: F.conv2d(nchw, conv_w, bias,
                                                    stride=patch)),
                bound_ms=bound_ms, bound_by=bound_by)
    for key, r in out.items():
        print(f"{key}, ViT-L batch 64 bf16: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library call {r['library_ms']:.4f} ms "
              f"(median of 30); bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return out


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
        metrics[variant] = trainer.train_step(state, trainer.stage(batch))
        made = (attn.flash_launches, pe.launches)
        expect = (layers, 1) if variant == "flash+pallas" else (0, 0)
        if made != expect:
            raise AssertionError(f"{variant} step: K4/K5 launches {made}, "
                                 f"expected {expect}")
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
    the K4 and K5 launches of the 12 'flash' + 'pallas' batch-64 steps."""
    rng = np.random.default_rng(SEED + 4)
    launches = None
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
            flash = variant == "flash+pallas"
            expect = (12 * layers, 12) if flash else (0, 0)
            if made != expect:
                raise AssertionError(f"{variant} batch {b}: K4/K5 launches "
                                     f"{made}, expected {expect}")
            if flash and b == 64:
                launches = made
            if variant == "fused" or (flash and b == 64):
                profile(torch, lambda: trainer.train_step(state, batch),
                        f"{variant} batch-{b} step")
            del trainer, state, batch
            torch.cuda.empty_cache()
    return launches


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
    from touhouimageclassification_tpu_torch.ops import patch_embed as pe
    from touhouimageclassification_tpu_torch.train.trainer import Trainer
    from touhouimageclassification_tpu_torch.utils.convert import load_vit_weights

    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
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
             **phase_three_operand_kernels(torch, attn, pe)}
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
        flash_train = phase_train_throughput(torch, attn, pe, create_model,
                                             Trainer, state_dict, data, layers,
                                             dev)

    borrowed = sorted(m for m in sys.modules if m == "jax"
                      or m.split(".")[0] == "touhouimageclassification_tpu")
    if borrowed:
        raise AssertionError(f"the port imported {borrowed[:5]}")
    csrc = "touhouimageclassification_tpu_torch/csrc/"
    ref = "touhouimageclassification_tpu/ops/"
    kernels = [
        ("K1", "slab_attention_fwd", "slab_attention_fwd.cu",
         "attention.py:455", {"serve": serve_launches,
                              "train": train_launches[0]}, "train"),
        ("K2", "slab_attention_bwd", "slab_attention_bwd.cu",
         "attention.py:482", {"train": train_launches[1]}, "train"),
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
    print(card)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": csrc + source,
        "device_routes": ({"bfloat16": "simt", "float32": "simt"}
                          if key == "K5" else
                          {"bfloat16": "mma", "float32": "simt"}),
        "replaces": ref + replaces, "launches": by_path[main_path],
        "launches_by_path": by_path, **stats[key]}
        for key, name, source, replaces, by_path, main_path in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
