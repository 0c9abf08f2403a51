"""On-device image augmentation, batched (counterpart of the JAX package's
``ops/augment.py``).

Images are NHWC float tensors in [0, 1], computed in f32. Every random op is a
sampler, which draws the per-image parameters from a ``torch.Generator`` on
the images' device, and a deterministic apply that takes them, so a test can
hand both packages the same numbers. The samplers follow the JAX package's
distributions and keep its documented deviations from torchvision
(``augment.py:9-24``):

- RandomResizedCrop and RandomErasing clamp the sampled box to the image
  instead of rejection-sampling it;
- ColorJitter applies brightness -> contrast -> saturation -> hue in this
  fixed order, clamping to [0, 1] after every op, with floor-mod hue;
- grayscale is ITU-R 601-2 luma (0.299, 0.587, 0.114).

Resizes are two matmuls with antialiased-linear interpolation-weight
matrices, per image for the crop boxes, so the port resamples exactly as the
JAX package does and every shape stays static.
"""
from __future__ import annotations

import functools
import math
from typing import Callable

import torch

from ..config import AugmentConfig

_LUMA = (0.299, 0.587, 0.114)


@functools.lru_cache(maxsize=32)
def _constant(values: tuple[float, ...], dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """A small constant vector on ``device``, made once: a fresh host tensor
    copied per call would make every call wait for the device. Read only."""
    return torch.tensor(values, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def _linear_resize_weights(in_size: int, out_size: int, crop_size, offset,
                           device: torch.device) -> torch.Tensor:
    """(out_size, in_size) antialiased-linear interpolation matrix for
    resampling ``[offset, offset + crop_size)`` of an ``in_size`` axis:
    triangle kernel with support max(crop/out, 1), rows renormalised
    (PIL-style edges). ``crop_size`` and ``offset`` are Python floats, or
    (B,) tensors, which give (B, out_size, in_size)."""
    o = torch.arange(out_size, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(in_size, dtype=torch.float32, device=device)
    if torch.is_tensor(crop_size):
        scale = (crop_size.float() / out_size)[:, None, None]   # (B, 1, 1)
        support = scale.clamp(min=1.0)
        offset = offset.float()[:, None, None]
    else:
        scale = crop_size / out_size
        support = max(scale, 1.0)
    centers = (o + 0.5) * scale - 0.5 + offset            # (..., out, 1)
    dist = (i - centers).abs() / support                  # (..., out, in)
    w = (1.0 - dist).clamp(min=0.0)
    return w / w.sum(-1, keepdim=True).clamp(min=1e-8)


def crop_and_resize(images: torch.Tensor, top, left, crop_h, crop_w,
                    out_size: tuple[int, int]) -> torch.Tensor:
    """Per-image crop-box resample: (B, H, W, C) and (B,) boxes ->
    (B, out_h, out_w, C). Two batched matmuls."""
    _, h, w, _ = images.shape
    wh = _linear_resize_weights(h, out_size[0], crop_h, top, images.device)
    ww = _linear_resize_weights(w, out_size[1], crop_w, left, images.device)
    y = torch.einsum("boi,bijc->bojc", wh, images.float())
    y = torch.einsum("bpj,bojc->bopc", ww, y)
    return y.to(images.dtype)


def resize(images: torch.Tensor, out_size: tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) -> (B, out_h, out_w, C), computed in f32, returned in the
    input dtype."""
    _, h, w, _ = images.shape
    wh = _linear_resize_weights(h, out_size[0], float(h), 0.0, images.device)
    ww = _linear_resize_weights(w, out_size[1], float(w), 0.0, images.device)
    y = torch.einsum("oi,bijc->bojc", wh, images.float())
    y = torch.einsum("pj,bojc->bopc", ww, y)
    return y.to(images.dtype)


def _uniform(gen: torch.Generator, b: int, lo: float, hi: float,
             device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(b, generator=gen, device=device)


def _sample_box(gen, b: int, h: int, w: int, scale, ratio, device):
    """Area ~ U(scale) * H * W, log-aspect ~ U(log ratio), sides clamped to
    [1, H] and [1, W], top-left uniform over the room left:
    (top, left, box_h, box_w), each (B,)."""
    area = _uniform(gen, b, scale[0], scale[1], device) * (h * w)
    aspect = torch.exp(_uniform(gen, b, math.log(ratio[0]), math.log(ratio[1]),
                                device))
    box_w = torch.sqrt(area * aspect).clamp(1.0, w)
    box_h = torch.sqrt(area / aspect).clamp(1.0, h)
    top = torch.rand(b, generator=gen, device=device) * (h - box_h)
    left = torch.rand(b, generator=gen, device=device) * (w - box_w)
    return top, left, box_h, box_w


def sample_resized_crop(gen: torch.Generator, images: torch.Tensor,
                        scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """RandomResizedCrop boxes for a batch: (top, left, crop_h, crop_w)."""
    b, h, w, _ = images.shape
    return _sample_box(gen, b, h, w, scale, ratio, images.device)


def random_resized_crop(gen: torch.Generator, images: torch.Tensor,
                        out_size: tuple[int, int], scale=(0.08, 1.0),
                        ratio=(3 / 4, 4 / 3)) -> torch.Tensor:
    """Batched RandomResizedCrop: (B, H, W, C) -> (B, out_h, out_w, C)."""
    return crop_and_resize(images, *sample_resized_crop(gen, images, scale,
                                                        ratio), out_size)


def _coin(gen: torch.Generator, images: torch.Tensor, p: float) -> torch.Tensor:
    """(B,) bool, each True with probability p."""
    return torch.rand(images.shape[0], generator=gen,
                      device=images.device) < p


def hflip(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Mirror the images where ``flip`` (B,) is True."""
    return torch.where(flip[:, None, None, None], images.flip(2), images)


def random_hflip(gen: torch.Generator, images: torch.Tensor,
                 p: float = 0.5) -> torch.Tensor:
    return hflip(images, _coin(gen, images, p))


# ---------------------------------------------------------------------------
# color
# ---------------------------------------------------------------------------

def _luma(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H, W) grayscale."""
    return images @ _constant(_LUMA, images.dtype, images.device)


def _grayscale(images: torch.Tensor) -> torch.Tensor:
    return _luma(images)[..., None].expand(images.shape)


def _adjust_brightness(images: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    # clamp after every op, as torchvision's _blend: a saturated value feeds
    # the next op clamped
    return (images * factor[:, None, None, None]).clamp(0.0, 1.0)


def _adjust_contrast(images: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    mean = _luma(images).mean(dim=(1, 2), keepdim=True)[..., None]
    f = factor[:, None, None, None]
    return (images * f + mean * (1.0 - f)).clamp(0.0, 1.0)


def _adjust_saturation(images: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    f = factor[:, None, None, None]
    return (images * f + _grayscale(images) * (1.0 - f)).clamp(0.0, 1.0)


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb.unbind(-1)
    maxc = rgb.amax(-1)
    minc = rgb.amin(-1)
    delta = maxc - minc
    safe_delta = torch.where(delta == 0, 1.0, delta)
    s = torch.where(maxc == 0, 0.0,
                    delta / torch.where(maxc == 0, 1.0, maxc))
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, 0.0, h)
    h = (h / 6.0) % 1.0
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sector = (i.long() % 6)[..., None]

    def pick(*choices):
        return torch.stack(choices, dim=-1).gather(-1, sector)[..., 0]

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def _adjust_hue(images: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    hsv = _rgb_to_hsv(images.float().clamp(0.0, 1.0))
    h = (hsv[..., 0] + shift[:, None, None]) % 1.0
    return _hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]],
                                   dim=-1)).to(images.dtype)


def sample_color_jitter(gen: torch.Generator, images: torch.Tensor,
                        brightness: float = 0.2, contrast: float = 0.2,
                        saturation: float = 0.2,
                        hue: float = 0.1) -> dict[str, torch.Tensor]:
    """Per-image factors of the enabled ops: brightness, contrast and
    saturation ~ U(1 - x, 1 + x), hue shift ~ U(-h, h) of a full circle."""
    b, dev = images.shape[0], images.device
    spans = {"brightness": (1 - brightness, 1 + brightness, brightness),
             "contrast": (1 - contrast, 1 + contrast, contrast),
             "saturation": (1 - saturation, 1 + saturation, saturation),
             "hue": (-hue, hue, hue)}
    return {name: _uniform(gen, b, lo, hi, dev)
            for name, (lo, hi, x) in spans.items() if x > 0}


def apply_color_jitter(images: torch.Tensor,
                       factors: dict[str, torch.Tensor]) -> torch.Tensor:
    """Fixed order b -> c -> s -> h; ops without a factor are skipped."""
    for name, op in (("brightness", _adjust_brightness),
                     ("contrast", _adjust_contrast),
                     ("saturation", _adjust_saturation), ("hue", _adjust_hue)):
        if name in factors:
            images = op(images, factors[name])
    return images.clamp(0.0, 1.0)


def color_jitter(gen: torch.Generator, images: torch.Tensor,
                 brightness: float = 0.2, contrast: float = 0.2,
                 saturation: float = 0.2, hue: float = 0.1) -> torch.Tensor:
    return apply_color_jitter(images, sample_color_jitter(
        gen, images, brightness, contrast, saturation, hue))


def apply_grayscale(images: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    """Grayscale the images where ``on`` (B,) is True."""
    return torch.where(on[:, None, None, None], _grayscale(images), images)


def random_grayscale(gen: torch.Generator, images: torch.Tensor,
                     p: float = 0.2) -> torch.Tensor:
    return apply_grayscale(images, _coin(gen, images, p))


# ---------------------------------------------------------------------------
# erasing
# ---------------------------------------------------------------------------

def sample_erasing(gen: torch.Generator, images: torch.Tensor, p: float = 0.5,
                   scale=(0.02, 0.33), ratio=(0.3, 3.3)):
    """RandomErasing draws: (on, top, left, box_h, box_w), each (B,)."""
    b, h, w, _ = images.shape
    on = _coin(gen, images, p)
    return (on, *_sample_box(gen, b, h, w, scale, ratio, images.device))


def apply_erasing(images: torch.Tensor, on, top, left, box_h, box_w,
                  value: float = 0.0) -> torch.Tensor:
    """Fill each box [top, top + box_h) x [left, left + box_w) with
    ``value`` where ``on`` is True."""
    _, h, w, _ = images.shape
    rows = torch.arange(h, dtype=torch.float32, device=images.device)
    cols = torch.arange(w, dtype=torch.float32, device=images.device)
    in_rows = ((rows >= top[:, None]) & (rows < (top + box_h)[:, None]))
    in_cols = ((cols >= left[:, None]) & (cols < (left + box_w)[:, None]))
    mask = in_rows[:, :, None] & in_cols[:, None, :] & on[:, None, None]
    return torch.where(mask[..., None], value, images)


def random_erasing(gen: torch.Generator, images: torch.Tensor, p: float = 0.5,
                   scale=(0.02, 0.33), ratio=(0.3, 3.3),
                   value: float = 0.0) -> torch.Tensor:
    return apply_erasing(images, *sample_erasing(gen, images, p, scale, ratio),
                         value)


# ---------------------------------------------------------------------------
# normalize + recipes
# ---------------------------------------------------------------------------

def normalize(images: torch.Tensor, mean, std) -> torch.Tensor:
    """(x - mean) / std per channel; ``mean`` and ``std`` are sequences of
    floats."""
    mean = _constant(tuple(float(m) for m in mean), images.dtype, images.device)
    std = _constant(tuple(float(s) for s in std), images.dtype, images.device)
    return (images - mean) / std


def build_augment_fn(cfg: AugmentConfig, out_size: tuple[int, int]
                     ) -> Callable[[torch.Generator, torch.Tensor], torch.Tensor]:
    """One of the five reference recipes (``TIC/ViT/ntrain.py:96-136``), as
    the JAX ``build_augment_fn`` selects it. Returns ``fn(gen, images01) ->
    normalized``; ``gen`` is a generator on the images' device."""

    def eval_fn(gen, images):
        del gen
        return normalize(resize(images, out_size), cfg.mean, cfg.std)

    if not cfg.enable_augmentation:
        return eval_fn

    if cfg.only_grey_augmentation:
        def grey_fn(gen, images):
            images = random_grayscale(gen, resize(images, out_size),
                                      cfg.grayscale_prob)
            return normalize(images, cfg.mean, cfg.std)
        return grey_fn

    div, gen_on = cfg.enable_diversity, cfg.enable_generalization

    def fn(gen, images):
        if gen_on:
            images = random_resized_crop(gen, images, out_size, cfg.rrc_scale,
                                         cfg.rrc_ratio)
            images = random_hflip(gen, images, cfg.hflip_prob)
        else:
            images = resize(images, out_size)
        if div:
            images = color_jitter(gen, images, cfg.brightness, cfg.contrast,
                                  cfg.saturation, cfg.hue)
            images = random_grayscale(gen, images, cfg.grayscale_prob)
        if gen_on:
            images = random_erasing(gen, images, cfg.erasing_prob,
                                    cfg.erasing_scale, cfg.erasing_ratio)
        return normalize(images, cfg.mean, cfg.std)

    return fn


def build_eval_fn(cfg: AugmentConfig, out_size: tuple[int, int]
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """resize + normalize only (the val/test transform)."""
    def fn(images):
        return normalize(resize(images, out_size), cfg.mean, cfg.std)
    return fn
