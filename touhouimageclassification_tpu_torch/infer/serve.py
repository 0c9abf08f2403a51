"""Serving: model loading, single-image predict, batched dataset judge.

Counterpart of the JAX package's ``infer/serve.py``, with the same CLI flags,
the same batch buckets (1/8/64) and the same judge CSV
``filename,predicted_class,confidence,actual_class,correct,path``. What
differs:

- the device is explicit (``--device``, default ``cuda``) and CUDA without a
  GPU is an error, never a quiet move to the CPU;
- weights go to the device once, in the model's compute dtype;
- ``stage`` pads a batch in pinned host memory and starts a non-blocking
  upload, so the upload of batch i+1 overlaps the predict of batch i;
- ``--dp n`` holds one replica of the model on each of the first n devices
  of this process (JAX's ``--dp``: n adjusted to the device count and to
  a divisor of the 64-image bucket, with JAX's message) and splits each
  judge bucket over them; a bucket n does not divide is served whole. On
  the CPU the n replicas share the host;
- the model is any family the port has (ViT, ResNet, ResMoE, TreeViT),
  dispatched by the model type or by the export's meta;
- weights are reference torch checkpoints (HF-layout ViT, torchvision-
  layout ResNet, the reference's ResMoE and TreeViT of HF ViTs, whose
  member count the model is rebuilt to; ``.pth``/``.pt``/``.bin``/
  ``.safetensors``) or the port's
  serving export (a directory of ``params.safetensors`` and
  ``serving_meta.json``, written by the training CLIs' ``--transform``);
  the JAX package's Orbax exports are not loadable. Without ``--weights``
  the model type's path in :data:`model_checkpoints` is loaded, as in the
  JAX package.

CLI: ``python -m touhouimageclassification_tpu_torch.infer.serve --model
vit-large --image data/testset --weights <ckpt> --output result/x.csv --full``
"""
from __future__ import annotations

import contextlib
import copy
import json
import os
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..config import FILTERED_DATA_DIR
from ..data.folder import IMG_EXTENSIONS, get_class_to_idx
from ..device import resolve_device
from ..models import EXPORT_CONFIGS, config_from_dict, create_model, input_size
from ..ops.augment import normalize, resize
from ..train.checkpoint import SERVING_META, SERVING_PARAMS, load_params
from ..utils.convert import (convert_checkpoint, member_overrides,
                             read_checkpoint)
from ..utils.mean_std import get_mean_std

# Default checkpoint registry (serving exports), the JAX package's
# ``model_checkpoints`` path for path: a training run's ``--transform``
# writes there
model_checkpoints: dict[str, str] = {
    "resnet": "checkpoint/serving/resnet152",
    "vit-base": "checkpoint/serving/vit_base_finetune",
    "vit-large": "checkpoint/serving/vit_large_finetune",
    "nvit": "checkpoint/serving/nvit",
    "resmoe": "checkpoint/serving/resmoe",
}

MODEL_CHOICES = ["resnet", "vit-base", "vit-large", "nvit", "resmoe",
                 "treevit"]
_SERVE_TYPE_ALIASES = {"resnet": "resnet152", "nvit": "vit-large",
                       "resmoe": "vit-moe", "treevit": "tree-vit"}
TORCH_CKPT_EXTS = (".pth", ".pt", ".bin", ".safetensors")

BUCKETS = (1, 8, 64)


@dataclass
class Predictor:
    """Frozen-weights inference with padded batch buckets.

    ``model`` (any module mapping NHWC images to logits, or to a tuple whose
    first entry is the logits, as ResMoE and TreeViT return) is moved to
    ``device`` once, as it is (its compute dtype was fixed when it was
    built), in eval mode."""

    model: nn.Module
    class_to_idx: dict[str, int]
    image_size: tuple[int, int]
    mean: np.ndarray
    std: np.ndarray
    device: torch.device

    def __post_init__(self):
        self.idx_to_class = {v: k for k, v in self.class_to_idx.items()}
        self.model = self.model.to(self.device).eval()
        self._mean = tuple(float(m) for m in np.asarray(self.mean).reshape(-1))
        self._std = tuple(float(s) for s in np.asarray(self.std).reshape(-1))
        self.replicas: list[tuple[nn.Module, torch.device]] = [
            (self.model, self.device)]

    def replicate(self, n: int) -> "Predictor":
        """Hold ``n`` replicas: this one's device, then the first other
        CUDA devices (on the CPU, n replicas on the host); returns self."""
        if self.device.type == "cuda":
            others = [torch.device("cuda", i)
                      for i in range(torch.cuda.device_count())
                      if i != self.device.index]
        else:
            others = [self.device] * (n - 1)
        if len(others) < n - 1:
            raise ValueError(f"{n} replicas need {n} devices, have "
                             f"{len(others) + 1}")
        self.replicas = [(self.model, self.device)] + [
            (copy.deepcopy(self.model).to(d).eval(), d)
            for d in others[:n - 1]]
        return self

    def _logits(self, model: nn.Module,
                images_u8: torch.Tensor) -> torch.Tensor:
        imgs = images_u8.float() / 255.0
        if tuple(imgs.shape[1:3]) != tuple(self.image_size):
            imgs = resize(imgs, self.image_size)
        imgs = normalize(imgs, self._mean, self._std)
        outputs = model(imgs)
        return outputs[0] if isinstance(outputs, tuple) else outputs

    @torch.inference_mode()
    def _predict(self, images_u8: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 on the device -> (2, B) f32: predicted index and
        confidence, one tensor so a request costs one device->host copy.
        With replicas, a batch they divide is split over them."""
        n = len(self.replicas)
        if n > 1 and images_u8.shape[0] % n == 0:
            parts = [self._logits(model, chunk.to(dev, non_blocking=True))
                     for (model, dev), chunk in zip(self.replicas,
                                                    images_u8.chunk(n))]
            logits = torch.cat([p.to(self.device) for p in parts])
        else:
            logits = self._logits(self.model, images_u8)
        probs = torch.softmax(logits.float(), dim=-1)
        conf, pred = probs.max(dim=-1)
        return torch.stack([pred.float(), conf])

    def stage(self, images_u8: np.ndarray):
        """Pad to a bucket in pinned host memory and start the upload; returns
        the device batch for :meth:`predict_staged`, or None when N exceeds
        the largest bucket (the caller then uses :meth:`predict_array`)."""
        n = images_u8.shape[0]
        bucket = next((b for b in BUCKETS if b >= n), None)
        if bucket is None:
            return None
        host = torch.zeros((bucket, *images_u8.shape[1:]), dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        host[:n] = torch.from_numpy(np.ascontiguousarray(images_u8))
        return host.to(self.device, non_blocking=True)

    def predict_staged(self, staged, count: int) -> tuple[np.ndarray, np.ndarray]:
        """Predict on a batch previously staged with :meth:`stage`."""
        out = self._predict(staged).cpu().numpy()
        return out[0, :count].astype(np.int64), out[1, :count]

    def predict_array(self, images_u8: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(N, H, W, 3) uint8 -> (pred_idx (N,), confidence (N,)). Pads to the
        smallest bucket >= N; larger N runs in chunks of the largest bucket,
        all launched before the first result is read back."""
        step = BUCKETS[-1]
        outs = []
        for i in range(0, max(len(images_u8), 1), step):
            chunk = images_u8[i:i + step]
            outs.append((self._predict(self.stage(chunk)), len(chunk)))
        host = [(out.cpu().numpy(), cnt) for out, cnt in outs]
        return (np.concatenate([o[0, :c] for o, c in host]).astype(np.int64),
                np.concatenate([o[1, :c] for o, c in host]))

    def predict_images(self, pil_images) -> list[tuple[str, float]]:
        arr = np.stack([_pil_to_canvas(im, self.image_size)
                        for im in pil_images])
        pred, conf = self.predict_array(arr)
        return [(self.idx_to_class[int(p)], float(c)) for p, c in zip(pred, conf)]


def _pil_to_canvas(im, image_size) -> np.ndarray:
    from PIL import Image

    im = im.convert("RGB").resize((image_size[1], image_size[0]), Image.BILINEAR)
    return np.asarray(im, np.uint8)


def serve(predictor: Predictor, image) -> tuple[str, float]:
    """Single-image predict: returns (class_name, confidence)."""
    return predictor.predict_images([image])[0]


def dp_replicas(dp: int, device: torch.device) -> int:
    """The replica count for ``--dp dp``: at most the CUDA device count (on
    the CPU, ``dp`` itself) and a divisor of the largest bucket, adjusted
    with the JAX package's message."""
    if not dp or dp <= 1:
        return 1
    available = (torch.cuda.device_count() if device.type == "cuda"
                 else dp)
    n = min(dp, available)
    while n > 1 and BUCKETS[-1] % n:
        n -= 1
    if n != dp:
        print(f"--dp {dp} adjusted to {n} "
              f"(must divide the {BUCKETS[-1]}-image judge bucket and "
              f"fit {available} devices)")
    return n


def init(args=None, modelt=None, weights=None,
         data_dir: str = FILTERED_DATA_DIR, device="cuda",
         dp: int = 0) -> Predictor:
    """:func:`build_predictor` with ``dp`` replicas (``args.dp`` on the
    command line; see :func:`dp_replicas`)."""
    if args:
        dp = getattr(args, "dp", 0) or 0
    predictor = build_predictor(args, modelt, weights, data_dir, device)
    n = dp_replicas(dp, predictor.device)
    return predictor.replicate(n) if n > 1 else predictor


def build_predictor(args=None, modelt=None, weights=None,
                    data_dir: str = FILTERED_DATA_DIR,
                    device="cuda") -> Predictor:
    """Build a Predictor: class map + weights + normalisation statistics.

    ``weights`` is a reference torch checkpoint of the model type's family
    (served at its config's image size: 224 for a ViT and the mixtures'
    ViT-B members, 256 for a ResNet, with the dataset's mean and std; a
    ResMoE or TreeViT is built with the checkpoint's member count), or a
    serving export directory: there, as in the JAX package's ``init``, the
    model's config, the class map and the mean and std come from
    ``serving_meta.json`` and the parameters from ``params.safetensors``.
    ``weights=None`` takes the model type's :data:`model_checkpoints`
    path."""
    if args:
        modelt = args.model
        weights = getattr(args, "weights", None)
        data_dir = getattr(args, "data_dir", None) or data_dir
        device = getattr(args, "device", None) or device
    device = resolve_device(device)
    mt = modelt.lower().replace("_", "-")
    if weights is None:
        weights = model_checkpoints.get(mt)
        if weights is None:
            raise ValueError(f"No default checkpoint found for model type: "
                             f"{mt}")
        if not os.path.exists(weights):
            raise FileNotFoundError(
                f"{weights}: no checkpoint at the default path for {modelt!r} "
                "(pass --weights, or write a serving export there with a "
                "training CLI's --transform)")
    mt = _SERVE_TYPE_ALIASES.get(mt, mt)
    if os.path.isdir(weights):
        return _init_export(weights, data_dir, device)
    if not weights.endswith(TORCH_CKPT_EXTS):
        raise ValueError(
            f"{weights}: expected a .pth/.pt/.bin/.safetensors checkpoint "
            f"or a serving export directory ({SERVING_META} + "
            f"{SERVING_PARAMS})")

    class_to_idx = get_class_to_idx(data_dir)
    state_dict = read_checkpoint(weights)
    model = create_model(mt, num_classes=len(class_to_idx), device=device,
                         **member_overrides(state_dict, mt))
    model.load_state_dict(convert_checkpoint(state_dict, model.cfg))
    image_size = input_size(model)
    mean, std = get_mean_std(data_dir, image_size)
    return Predictor(model=model, class_to_idx=class_to_idx,
                     image_size=image_size, mean=mean, std=std, device=device)


def _init_export(export_dir: str, data_dir: str,
                 device: torch.device) -> Predictor:
    """A Predictor on a serving export directory (``--transform``): the
    model's config (``vit_config``, ``resnet_config``, ``moe_config`` or
    ``treevit_config``), the mean and std and (when the export has it) the
    class map from its meta."""
    missing = [name for name in (SERVING_META, SERVING_PARAMS)
               if not os.path.exists(os.path.join(export_dir, name))]
    if missing:
        raise FileNotFoundError(
            f"{export_dir} is not a serving export: no {' or '.join(missing)} "
            "(write one with a training CLI's --transform)")
    with open(os.path.join(export_dir, SERVING_META)) as f:
        meta = json.load(f)
    if meta.get("class_to_idx"):
        class_to_idx = {k: int(v) for k, v in meta["class_to_idx"].items()}
    else:
        class_to_idx = get_class_to_idx(data_dir)
    key = next((k for k in EXPORT_CONFIGS if k in meta), None)
    if key is None:
        raise ValueError(f"{export_dir}/{SERVING_META} names no model config "
                         f"({' or '.join(EXPORT_CONFIGS)})")
    family, config = EXPORT_CONFIGS[key]
    model = family(config_from_dict(config, meta[key]), device=device)
    model.load_state_dict(load_params(os.path.join(export_dir,
                                                   SERVING_PARAMS)))
    return Predictor(model=model, class_to_idx=class_to_idx,
                     image_size=input_size(model),
                     mean=np.asarray(meta["mean"]),
                     std=np.asarray(meta["std"]), device=device)


def _judge_canvas_cache(image_dir: str, image_size: tuple[int, int],
                        mode: str):
    """Resolve a decoded-canvas cache for judging ``image_dir``: ``'off'``
    never; ``'auto'`` reuse a valid existing one; ``'on'`` create or fill one
    at the trainer's default 256x256 canvas.

    Returns ``(cache, slot_of_path, canvas)`` or ``(None, None, image_size)``."""
    if mode == "off":
        return None, None, image_size
    from ..data.canvas_cache import CanvasCache, find_existing_canvas
    from ..data.folder import scan_image_folder

    try:
        index = scan_image_folder(image_dir, persist_class_map=False)
    except (FileNotFoundError, NotADirectoryError):
        return None, None, image_size
    # never an upscaling canvas (min_size): feeding the model from a
    # smaller-than-input cache would change predictions
    canvas, fp = find_existing_canvas(index, min_size=image_size,
                                      with_fingerprint=True)
    if canvas is None:
        if mode != "on":
            return None, None, image_size
        canvas = (max(256, image_size[0]), max(256, image_size[1]))
    cache = CanvasCache(index, canvas, fingerprint=fp)
    slot_of_path = {p: i for i, p in enumerate(index.paths)}
    return cache, slot_of_path, canvas


def full_judge(
    predictor: Predictor,
    image_dir: str,
    output: str | None = None,
    batch_size: int = 64,
    progress: bool = True,
    canvas_cache: str | bool = "auto",
) -> float:
    """Directory walk -> batched scoring -> CSV + accuracy.

    Host decode of batch i+1 (and its upload, through :meth:`Predictor.stage`)
    overlaps the predict of batch i. With ``canvas_cache`` a training run's
    decoded-canvas memmap feeds the judge, resized to the model size on the
    device; undecodable images are skipped and reported."""
    from concurrent.futures import ThreadPoolExecutor

    from ..data.loader import decode_batch_into

    entries: list[tuple[str, str, str]] = []  # (filename, label, path)
    for root, _dirs, files in os.walk(image_dir):
        for filename in sorted(files):
            if os.path.splitext(filename)[1].lower() in IMG_EXTENSIONS:
                entries.append((filename, os.path.basename(root),
                                os.path.join(root, filename)))
    print(f"scoring {len(entries)} images under {image_dir}")

    mode = {True: "on", False: "off"}.get(canvas_cache, canvas_cache)
    cache, slot_of_path, canvas = _judge_canvas_cache(
        image_dir, predictor.image_size, mode)
    if cache is not None and not all(e[2] in slot_of_path for e in entries):
        # files outside the class-dir layout: judge without the cache
        cache, canvas = None, predictor.image_size
    if cache is not None:
        print(f"canvas cache: {canvas[0]}x{canvas[1]}, "
              f"{cache.hit_rate() * 100:.0f}% warm")

    out_f = csv_w = None
    if output:
        import csv as _csv

        # csv.writer quotes commas for filter's DictReader; the \n terminator
        # keeps byte parity with the reference's CSVs
        out_f = open(output, "w", newline="")
        csv_w = _csv.writer(out_f, lineterminator="\n")
        csv_w.writerow(["filename", "predicted_class", "confidence",
                        "actual_class", "correct", "path"])

    def prep(chunk):
        imgs = np.empty((len(chunk), *canvas, 3), np.uint8)
        paths = [e[2] for e in chunk]
        # undecodable slots are zero-filled, skipped in the CSV and accuracy
        if cache is not None:
            ids = np.asarray([slot_of_path[p] for p in paths])
            hit = cache.fetch(ids, imgs)
            miss = np.nonzero(~hit)[0]
            bad: set[int] = set()
            if miss.size:
                decoded = np.empty((miss.size, *canvas, 3), np.uint8)
                failed = decode_batch_into(
                    [paths[j] for j in miss], canvas, decoded, pool=pool,
                    on_error="zero")
                imgs[miss] = decoded
                failed = np.asarray(sorted(failed), np.int64)
                bad = {int(j) for j in miss[failed]}
                # never mark an undecodable slot cache-done
                good = np.setdiff1d(np.arange(miss.size), failed)
                if good.size:
                    cache.store(ids[miss[good]], decoded[good])
        else:
            failed = decode_batch_into(paths, canvas, imgs, pool=pool,
                                       on_error="zero")
            bad = {int(j) for j in failed}
        staged = predictor.stage(imgs)
        return ((imgs, None) if staged is None else (staged, len(chunk)),
                bad)

    correct_cnt, cnt, skipped = 0, 0, []
    starts = list(range(0, len(entries), batch_size))
    iterator = starts
    if progress:
        import tqdm

        iterator = tqdm.tqdm(starts, desc="Processing batches", unit="batch")
    with out_f or contextlib.nullcontext(), \
            ThreadPoolExecutor(max_workers=16) as pool, \
            ThreadPoolExecutor(max_workers=1) as ahead:
        pending = ahead.submit(prep, entries[:batch_size]) if starts else None
        for i, start in enumerate(iterator):
            chunk = entries[start:start + batch_size]
            (imgs, staged_n), bad = pending.result()
            if i + 1 < len(starts):  # overlap next host prep with this predict
                nxt = entries[starts[i + 1]:starts[i + 1] + batch_size]
                pending = ahead.submit(prep, nxt)
            if staged_n is not None:
                pred, conf = predictor.predict_staged(imgs, staged_n)
            else:
                pred, conf = predictor.predict_array(imgs)
            for j, ((filename, label, path), p, c) in enumerate(
                    zip(chunk, pred, conf)):
                if j in bad:
                    skipped.append(path)
                    continue
                predicted = predictor.idx_to_class[int(p)]
                ok = predicted == label
                cnt += 1
                correct_cnt += ok
                if csv_w:
                    csv_w.writerow([filename, predicted, f"{float(c):.4f}",
                                    label, ok, path])
    if cache is not None:
        cache.flush()
    acc = correct_cnt / cnt if cnt else 0.0
    if skipped:
        print(f"skipped {len(skipped)} undecodable image(s), e.g. "
              f"{skipped[0]} (excluded from the CSV and accuracy)")
    print(f"scored {cnt} images, {correct_cnt} correct -> top-1 {acc * 100:.2f}%")
    return acc


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Serve a model for inference.")
    parser.add_argument("--model", type=str, required=True,
                        choices=MODEL_CHOICES)
    parser.add_argument("--image", type=str, required=True,
                        help="Path to an image or a directory of images.")
    parser.add_argument("--weights", type=str, default=None)
    parser.add_argument("--data-dir", type=str, default=FILTERED_DATA_DIR)
    parser.add_argument("-o", "--output", type=str, default="serve.out")
    parser.add_argument("--full", action="store_true")
    parser.add_argument("--dp", type=int, default=0,
                        help="shard judge batches over this many devices "
                             "(0/1 = single device)")
    parser.add_argument("--canvas-cache", choices=["auto", "on", "off"],
                        default="auto",
                        help="with --full: reuse (auto) or build (on) the "
                             "dataset's decoded-canvas cache so repeat "
                             "judge sweeps skip JPEG decode")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)

    predictor = init(args, data_dir=args.data_dir)
    if args.full:
        full_judge(predictor, args.image, args.output,
                   canvas_cache=args.canvas_cache)
        return
    if os.path.isfile(args.image):
        from PIL import Image

        with Image.open(args.image) as im:
            predicted, confidence = serve(predictor, im)
        print(f"Prediction: {predicted} (Confidence: {confidence:.4f})")
    elif os.path.isdir(args.image):
        from PIL import Image

        with open(args.output, "a") as f:
            for filename in sorted(os.listdir(args.image)):
                path = os.path.join(args.image, filename)
                if (os.path.isfile(path) and os.path.splitext(filename)[1]
                        .lower() in IMG_EXTENSIONS):
                    with Image.open(path) as im:
                        predicted, confidence = serve(predictor, im)
                    print(f"Prediction: {predicted} "
                          f"(Confidence: {confidence:.4f})")
                    f.write(f"{filename} {predicted} {confidence:.4f}\n")
    else:
        raise SystemExit(f"Error: Image path '{args.image}' is not valid.")


if __name__ == "__main__":
    main()
