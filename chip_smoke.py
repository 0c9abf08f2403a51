#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's serve path and its train step
(``touhouimageclassification_tpu_torch``) at the full width and depth of
ViT-Large/16 at 224x224 with random weights made from a seed, through the
entry points a user would call. Phases, each fatal on failure:

1. require CUDA; print the card's name and power limit, torch and CUDA;
2. build the CUDA kernels from ``touhouimageclassification_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) and print ptxas's report;
3. hold the slab attention forward kernel (K1) against its plain PyTorch
   version on the card at the serve path's shapes, and time both;
4. the same for the backward kernel (K2) at the train path's shapes, and
   check that autograd through the fused attention runs K1 then K2;
5. run ``infer.serve.main`` on a 120-class fixture ImageFolder: ``--full``
   without and with the canvas cache (which resizes on the device), then one
   single image; check the CSVs and that every forward launched K1 once per
   encoder layer;
6. compare the whole model, kernel against plain attention, on the same
   weights and images, and time bucket-1 latency and bucket-64 throughput;
7. five ``nvit`` train steps (full augmentation, CutMix/MixUp, AdamW, bf16
   over f32 params, NaN guard) through the port's ``Trainer`` on batches of
   the fixture's 256x256 canvases from ``HostImageLoader``: finite, unskipped
   steps with K1 and K2 launched once per layer each, then ``evaluate`` on
   the val split;
8. one step 'fused' (K1 + K2) against 'xla' (plain attention) from the same
   weights and batch: the loss, and every parameter's gradient (an SGD step
   with lr 1 moves each parameter by its gradient);
9. train img/s with both attentions at batches 8 and 64, peak device memory,
   and a profile of one fused batch-64 step.

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
# bf16 attention: P and O are rounded to bf16 (relative step 2^-8 = 3.9e-3)
# and the two sides sum in different orders; the same bound as the JAX
# package's bf16 attention test. f32: summation order only.
TOL = {"bfloat16": dict(atol=2e-2, rtol=2e-2), "float32": dict(atol=1e-4, rtol=1e-4)}
# Whole ViT-L in bf16, kernel vs plain attention: the two attentions differ
# by bf16 rounding of P and O in each of 24 layers, and the residual stream
# carries those differences to the head. Random weights give logits of order
# 1, so 5e-2 is a few percent of their spread; argmax must agree wherever the
# top-2 margin exceeds that bound.
LOGIT_TOL = 5e-2
# One ViT-L train step, 'fused' (K1 + K2) vs 'xla' (autograd of the plain
# attention, which rounds dP to bf16 where K2 keeps it in f32): the largest
# relative difference of any parameter's gradient. On an H100 the kernels
# read 1.93e-2 (in the embeddings, where 24 layers' differences add up);
# K2 with its output scaled by 0.95, its last 8 token rows zeroed or one
# head zeroed reads 9.3e-2 to 0.35. Faults of 1% or less (2.5e-2 to
# 2.6e-2) lie inside the bf16 spread; REL_TOL in the kernel phase finds them.
GRAD_TOL = 3e-2
# K2 vs its plain version, relative difference in norm: the two sides round
# the same f32 values to the output dtype and differ only where summation
# order moves a value across a rounding boundary, so this resolves a fault
# (a scaled or partly wrong gradient) far below the elementwise TOL. On an
# H100 the kernel reads at most 3.5e-5 in bf16 and 1.2e-7 in f32; K2 with
# its output scaled by 0.995 reads 5.7e-3 and 5.0e-3.
REL_TOL = {"bfloat16": 1e-3, "float32": 1e-5}


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
            out = attn.slab_attention(qkv, h)
            torch.cuda.synchronize()
            if attn.launches != before + 1:
                raise AssertionError(f"{name}: launches went {before} -> "
                                     f"{attn.launches}, expected one")
            ref = attn.slab_attention_reference(qkv, h)
            err = (out.float() - ref.float()).abs().max().item()
            tol = TOL[str(dtype).removeprefix("torch.")]
            torch.testing.assert_close(out.float(), ref.float(), **tol)
            errs[(name, dtype)] = err
            print(f"kernel vs plain, {name}, {dtype}: max |diff| {err:.3e} "
                  f"(atol {tol['atol']}, rtol {tol['rtol']}) ok")
        qkv = torch.randn(64, 197, 3 * 1024, generator=gen,
                          device=dev).to(torch.bfloat16)
        ms = cuda_ms(lambda: attn.slab_attention(qkv, 16))
        plain_ms = cuda_ms(lambda: attn.slab_attention_reference(qkv, 16))
    print(f"slab attention, ViT-L bucket 64 bf16 (B 64, N 197, C 1024, H 16): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 30)")
    return errs[("vit-l bucket 64", torch.bfloat16)], ms, plain_ms


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
        out = attn.slab_attention_backward(qkv, g, h)
        torch.cuda.synchronize()
        if attn.bwd_launches != before + 1:
            raise AssertionError(f"{name}: bwd_launches went {before} -> "
                                 f"{attn.bwd_launches}, expected one")
        ref = attn.slab_attention_backward_reference(qkv, g, h).float()
        err = (out.float() - ref).abs().max().item()
        rel = ((out.float() - ref).norm() / ref.norm()).item()
        key = str(dtype).removeprefix("torch.")
        tol = TOL[key]
        print(f"K2 vs plain backward, {name}, {dtype}: max |diff| {err:.3e} "
              f"(atol {tol['atol']}, rtol {tol['rtol']}), relative norm "
              f"{rel:.3e} (bound {REL_TOL[key]})")
        torch.testing.assert_close(out.float(), ref, **tol)
        if rel > REL_TOL[key]:
            raise AssertionError(f"{name} {dtype}: relative norm {rel:.3e}")
        errs[(name, dtype)] = err

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

    qkv = torch.randn(64, 197, 3 * 1024, generator=gen,
                      device=dev).to(torch.bfloat16)
    g = torch.randn(64, 197, 1024, generator=gen, device=dev).to(torch.bfloat16)
    ms = cuda_ms(lambda: attn.slab_attention_backward(qkv, g, 16))
    plain_ms = cuda_ms(
        lambda: attn.slab_attention_backward_reference(qkv, g, 16))
    print(f"slab attention backward, ViT-L batch 64 bf16 (B 64, N 197, C 1024, "
          f"H 16): K2 {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 30)")
    return errs[("vit-l batch 64", torch.bfloat16)], ms, plain_ms


def phase_serve(torch, attn, serve, work: str, pth: str, data: str,
                layers: int) -> int:
    """The serve CLI, three ways; returns the kernel launches it made."""
    n_images = NUM_CLASSES * PER_CLASS
    forwards = -(-n_images // serve.BUCKETS[-1])
    attn.launches = 0
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
    return attn.launches


def phase_model(torch, serve, create_model, load_vit_weights, pth: str,
                data_mean, data_std, dev):
    """Whole ViT-L bf16, kernel vs plain attention; latency and throughput."""
    models = {}
    for impl in ("fused", "xla"):
        m = create_model("vit-large", num_classes=NUM_CLASSES, device=dev,
                         attention_impl=impl)
        m.load_state_dict(load_vit_weights(pth, m.cfg))
        models[impl] = m.eval()
    rng = np.random.default_rng(SEED + 1)
    imgs = rng.integers(0, 256, (64, 224, 224, 3), dtype=np.uint8)
    x = torch.from_numpy(imgs[:8]).to(dev).float() / 255.0
    x = (x - torch.tensor(data_mean, device=dev).float()) / torch.tensor(
        data_std, device=dev).float()
    with torch.inference_mode():
        fused = models["fused"](x)
        plain = models["xla"](x)
    if not (fused.shape == (8, NUM_CLASSES) and torch.isfinite(fused).all()):
        raise AssertionError(f"logits {tuple(fused.shape)} or not finite")
    diff = (fused - plain).abs().max().item()
    top2 = plain.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > LOGIT_TOL
    same = (fused.argmax(-1) == plain.argmax(-1)) | ~sure
    print(f"ViT-L bf16 B 8, kernel vs plain attention: max |d logit| {diff:.3e} "
          f"(bound {LOGIT_TOL}), logit spread {plain.std().item():.3f}, "
          f"argmax equal on {int(sure.sum())} of 8 with margin > {LOGIT_TOL}")
    if diff > LOGIT_TOL or not bool(same.all()):
        raise AssertionError("whole-model kernel vs plain disagreement")

    timings = {}
    for impl, m in models.items():
        pred = serve.Predictor(model=m, class_to_idx={f"c{i}": i for i in
                                                      range(NUM_CLASSES)},
                               image_size=(224, 224), mean=data_mean,
                               std=data_std, device=dev)
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
        timings[impl] = (statistics.median(lat), rate)
        print(f"serve, attention {impl}: bucket-1 p50 "
              f"{statistics.median(lat):.3f} ms (60 requests), bucket-64 "
              f"{rate:.2f} img/s ({reps} batches)")
    return timings


def nvit_config(data: str, **over):
    """The ``nvit`` preset (ViT-L finetune: full augmentation + CutMix/MixUp,
    AdamW lr 1e-5 wd 0.01, bf16 compute over f32 params, batch 8, NaN
    guard) on the fixture dataset, seeded."""
    from touhouimageclassification_tpu_torch.config import PRESETS

    return dataclasses.replace(PRESETS["nvit"], data_dir=data, seed=SEED,
                               **over)


def train_model(create_model, state_dict, impl: str, dev):
    """ViT-L with f32 master parameters and bf16 compute."""
    model = create_model("vit-large", num_classes=NUM_CLASSES,
                         compute_dtype="bfloat16", param_dtype="float32",
                         device=dev, attention_impl=impl)
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
    batches.close()
    out = trainer.evaluate(val)
    if not (np.isfinite(out["val_loss"]) and 0 <= out["val_acc"] <= 1):
        raise AssertionError(f"evaluate: {out}")
    print(f"nvit evaluate on {len(va_idx)} val images: {out}")
    return launches


def phase_train_compare(create_model, Trainer, state_dict, data: str, dev):
    """One step 'fused' (K1 + K2) against 'xla' (plain attention) from
    identical f32 weights on one batch, augmentation and mixup off. The step
    is SGD with lr 1 and no clipping, so each parameter moves by exactly its
    gradient, and the two attentions' gradients are compared leaf by leaf;
    returns the worst leaf's relative difference."""
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
    for impl in ("fused", "xla"):
        trainer = Trainer(cfg, model=train_model(create_model, state_dict,
                                                 impl, dev), device=dev)
        state = trainer.init_state()
        metrics[impl] = trainer.train_step(state, trainer.stage(batch))
        grads[impl] = {k: state_dict[k].to(dev) - p.detach()
                       for k, p in state.model.named_parameters()}
        del trainer, state
    dloss = abs(metrics["fused"]["loss"] - metrics["xla"]["loss"])
    dnorm = abs(metrics["fused"]["grad_norm"] / metrics["xla"]["grad_norm"] - 1)
    rel = sorted((((grads["fused"][k] - grads["xla"][k]).norm()
                   / grads["xla"][k].norm()).item(), k) for k in grads["xla"])
    # CE is 2-Lipschitz in the max-norm of the logits, which differ by less
    # than LOGIT_TOL between the attentions (phase 6)
    loss_bound = 2 * LOGIT_TOL
    print(f"one nvit step fused vs xla (B 8, augmentation off, SGD lr 1): "
          f"loss {metrics['fused']['loss']:.6f} vs {metrics['xla']['loss']:.6f} "
          f"(|diff| {dloss:.3e}, bound {loss_bound}), grad_norm "
          f"{metrics['fused']['grad_norm']:.6f} vs "
          f"{metrics['xla']['grad_norm']:.6f} (rel diff {dnorm:.3e}); "
          f"gradient rel diff by leaf: median {rel[len(rel) // 2][0]:.3e}, "
          f"worst {rel[-1][0]:.3e} (bound {GRAD_TOL}) in "
          + ", ".join(f"{k} {r:.3e}" for r, k in rel[:-4:-1]))
    if dloss > loss_bound or rel[-1][0] > GRAD_TOL:
        raise AssertionError("fused vs xla train step disagreement")
    return rel[-1][0]


def phase_train_throughput(torch, create_model, Trainer, state_dict,
                           data: str, dev):
    """nvit train img/s, both attentions, batches 8 and 64 (device-resident
    256x256 uint8 batches: the loader is not timed), 2 warm-up + 10 timed
    steps, and peak device memory; then a profile of one fused step at each
    batch."""
    rng = np.random.default_rng(SEED + 4)
    results = {}
    for impl in ("fused", "xla"):
        for b in (8, 64):
            cfg = nvit_config(data, global_batch_size=b)
            trainer = Trainer(cfg, model=train_model(create_model, state_dict,
                                                     impl, dev), device=dev)
            state = trainer.init_state()
            batch = trainer.stage({
                "image": rng.integers(0, 256, (b, 256, 256, 3), dtype=np.uint8),
                "label": rng.integers(0, NUM_CLASSES, b).astype(np.int32),
                "mask": np.ones(b, bool)})
            for _ in range(2):
                trainer.train_step(state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            for _ in range(10):
                m = trainer.train_step(state, batch)
            secs = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            results[(impl, b)] = (10 * b / secs, peak)
            print(f"nvit train, attention {impl}, batch {b}: "
                  f"{10 * b / secs:.2f} img/s ({1e3 * secs / 10:.2f} ms/step, "
                  f"10 steps), peak memory {peak:.2f} GiB, last loss "
                  f"{m['loss']:.4f}")
            if not np.isfinite(m["loss"]):
                raise AssertionError(f"{impl} batch {b}: non-finite loss")
            if impl == "fused":
                profile_step(torch, trainer, state, batch)
            del trainer, state, batch
            torch.cuda.empty_cache()
    return results


def profile_step(torch, trainer, state, batch):
    """Device time by kernel of one train step, and the device's busy share
    of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(trainer.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(state, batch)
        torch.cuda.synchronize(trainer.device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: a user annotation (the optimizer's step range) spans
    # kernels that are counted on their own
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profile, one fused batch-{batch['image'].shape[0]} step: wall "
          f"{wall_ms:.3f} ms (profiler "
          f"on), device kernels {device_ms:.3f} ms, busy share "
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

    max_err, ms, plain_ms = phase_kernels(torch, attn)
    bwd_err, bwd_ms, bwd_plain_ms = phase_backward(torch, attn)

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
            stats = json.load(f)
        phase_model(torch, serve, create_model, load_vit_weights, pth,
                    stats["mean"], stats["std"], torch.device("cuda", 0))
        dev = torch.device("cuda", 0)
        state_dict = load_vit_weights(
            pth, vit_config("vit-large", num_classes=NUM_CLASSES))
        train_launches = phase_train(attn, create_model, Trainer, state_dict,
                                     data, layers, dev)
        phase_train_compare(create_model, Trainer, state_dict, data, dev)
        phase_train_throughput(torch, create_model, Trainer, state_dict, data,
                               dev)

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(card)
    print(json.dumps({"kernels": [{
        "name": "slab_attention_fwd",
        "route": "cuda",
        "source": "touhouimageclassification_tpu_torch/csrc/slab_attention_fwd.cu",
        "replaces": "touhouimageclassification_tpu/ops/attention.py:455",
        "launches": train_launches[0],
        "launches_by_path": {"serve": serve_launches,
                             "train": train_launches[0]},
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }, {
        "name": "slab_attention_bwd",
        "route": "cuda",
        "source": "touhouimageclassification_tpu_torch/csrc/slab_attention_bwd.cu",
        "replaces": "touhouimageclassification_tpu/ops/attention.py:482",
        "launches": train_launches[1],
        "max_abs_err": bwd_err,
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
