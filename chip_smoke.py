#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's serve path (``touhouimageclassification_tpu_torch``) at the
full width of ViT-Large/16 at 224x224 with random weights made from a seed,
through the serve CLI a user would call. Phases, each fatal on failure:

1. require CUDA; print the card's name and power limit, torch and CUDA;
2. build the CUDA kernels from ``touhouimageclassification_tpu_torch/csrc``;
3. hold the slab attention kernel against its plain PyTorch version on the
   card at the serve path's shapes, and time both;
4. run ``infer.serve.main`` on a 120-class fixture ImageFolder: ``--full``
   without and with the canvas cache (which resizes on the device), then one
   single image; check the CSVs and that every forward launched the kernel
   once per encoder layer;
5. compare the whole model, kernel against plain attention, on the same
   weights and images, and time bucket-1 latency and bucket-64 throughput.

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout of the
repository, the script exits non-zero before printing either.
"""
from __future__ import annotations

import csv
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from touhouimageclassification_tpu_torch.infer import serve
    from touhouimageclassification_tpu_torch.models import create_model
    from touhouimageclassification_tpu_torch.ops import _build
    from touhouimageclassification_tpu_torch.ops import attention as attn
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
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())

    max_err, ms, plain_ms = phase_kernels(torch, attn)

    layers = 24
    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build_dir) as work:
        data = make_image_folder(os.path.join(work, "data"), NUM_CLASSES,
                                 PER_CLASS)
        pth = os.path.join(work, "vit_large_random.pth")
        torch.save(hf_vit_state_dict(1024, layers, 4096, NUM_CLASSES), pth)
        launches = phase_serve(torch, attn, serve, work, pth, data, layers)
        with open(os.path.join(data, "meta_mean_std.json")) as f:
            stats = json.load(f)
        phase_model(torch, serve, create_model, load_vit_weights, pth,
                    stats["mean"], stats["std"], torch.device("cuda", 0))

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(card)
    print(json.dumps({"kernels": [{
        "name": "slab_attention_fwd",
        "route": "cuda",
        "source": "touhouimageclassification_tpu_torch/csrc/slab_attention_fwd.cu",
        "replaces": "touhouimageclassification_tpu/ops/attention.py:455",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
