"""A frozen copy of the training recipe's input pipeline, written out in
plain PyTorch and NumPy: the ``nvit`` augmentation (random resized crop,
horizontal flip, colour jitter, random grayscale, random erasing,
ImageNet normalisation) and the batch-level CutMix-or-MixUp, with the
same draws in the same order from the same generators as the recipe the
port trains with, and the antialiased-linear resize its serving path uses.

Per step ``t`` of a run seeded ``s``: a NumPy generator seeded ``[s, t]``
draws first the seed of a ``torch.Generator`` on the device, which draws
the per-image numbers (crop box, flip, jitter factors, grayscale, erasing
box, in that order), then the mix (coin, lambda, box centre).
"""
from __future__ import annotations

import math

import numpy as np
import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
LUMA = (0.299, 0.587, 0.114)


def resize_matrix(in_size: int, out_size: int, crop, offset, device):
    """(out, in) or (B, out, in) antialiased-linear weights for resampling
    ``[offset, offset + crop)`` of an axis: a triangle of support
    max(crop / out, 1), rows summing to one."""
    o = torch.arange(out_size, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(in_size, dtype=torch.float32, device=device)
    if torch.is_tensor(crop):
        scale = (crop.float() / out_size)[:, None, None]
        support = scale.clamp(min=1.0)
        offset = offset.float()[:, None, None]
    else:
        scale = crop / out_size
        support = max(scale, 1.0)
    dist = (i - ((o + 0.5) * scale - 0.5 + offset)).abs() / support
    w = (1.0 - dist).clamp(min=0.0)
    return w / w.sum(-1, keepdim=True).clamp(min=1e-8)


def resize(images: torch.Tensor, out: tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) float32 -> (B, out_h, out_w, C)."""
    _, h, w, _ = images.shape
    wh = resize_matrix(h, out[0], float(h), 0.0, images.device)
    ww = resize_matrix(w, out[1], float(w), 0.0, images.device)
    y = torch.einsum("oi,bijc->bojc", wh, images)
    return torch.einsum("pj,bojc->bopc", ww, y)


def normalize(images: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(MEAN, device=images.device)
    std = torch.tensor(STD, device=images.device)
    return (images - mean) / std


def _luma(x):
    return x @ torch.tensor(LUMA, device=x.device)


def _rgb_to_hsv(rgb):
    r, g, b = rgb.unbind(-1)
    maxc, minc = rgb.amax(-1), rgb.amin(-1)
    delta = maxc - minc
    safe = torch.where(delta == 0, 1.0, delta)
    s = torch.where(maxc == 0, 0.0, delta / torch.where(maxc == 0, 1.0, maxc))
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (torch.where(delta == 0, 0.0, h) / 6.0) % 1.0
    return h, s, maxc


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    sector = (i.long() % 6)[..., None]

    def pick(*xs):
        return torch.stack(xs, dim=-1).gather(-1, sector)[..., 0]
    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def _box(gen, b, h, w, scale, ratio, device):
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(b, generator=gen,
                                                   device=device)
    area = u(*scale) * (h * w)
    aspect = torch.exp(u(math.log(ratio[0]), math.log(ratio[1])))
    bw = torch.sqrt(area * aspect).clamp(1.0, w)
    bh = torch.sqrt(area / aspect).clamp(1.0, h)
    top = torch.rand(b, generator=gen, device=device) * (h - bh)
    left = torch.rand(b, generator=gen, device=device) * (w - bw)
    return top, left, bh, bw


def augment(gen: torch.Generator, x: torch.Tensor,
            out: tuple[int, int]) -> torch.Tensor:
    """The ``nvit`` recipe on (B, H, W, 3) images in [0, 1] -> normalised
    (B, out_h, out_w, 3)."""
    b, h, w, _ = x.shape
    dev = x.device
    rand = lambda: torch.rand(b, generator=gen, device=dev)
    # random resized crop, scale (0.08, 1), ratio (3/4, 4/3)
    top, left, bh, bw = _box(gen, b, h, w, (0.08, 1.0), (3 / 4, 4 / 3), dev)
    wh = resize_matrix(h, out[0], bh, top, dev)
    ww = resize_matrix(w, out[1], bw, left, dev)
    x = torch.einsum("boi,bijc->bojc", wh, x)
    x = torch.einsum("bpj,bojc->bopc", ww, x)
    # horizontal flip, p 0.5
    flip = rand() < 0.5
    x = torch.where(flip[:, None, None, None], x.flip(2), x)
    # colour jitter: brightness, contrast, saturation 0.2, hue 0.1
    f_b, f_c, f_s = (0.8 + 0.4 * rand() for _ in range(3))
    shift = -0.1 + 0.2 * rand()
    x = (x * f_b[:, None, None, None]).clamp(0.0, 1.0)
    mean = _luma(x).mean(dim=(1, 2), keepdim=True)[..., None]
    f = f_c[:, None, None, None]
    x = (x * f + mean * (1.0 - f)).clamp(0.0, 1.0)
    f = f_s[:, None, None, None]
    x = (x * f + _luma(x)[..., None] * (1.0 - f)).clamp(0.0, 1.0)
    hh, ss, vv = _rgb_to_hsv(x.clamp(0.0, 1.0))
    x = _hsv_to_rgb((hh + shift[:, None, None]) % 1.0, ss, vv).clamp(0.0, 1.0)
    # random grayscale, p 0.2
    grey = rand() < 0.2
    x = torch.where(grey[:, None, None, None],
                    _luma(x)[..., None].expand(x.shape), x)
    # random erasing, p 0.5, scale (0.02, 0.33), ratio (0.3, 3.3), value 0
    on = rand() < 0.5
    top, left, bh, bw = _box(gen, b, *out, (0.02, 0.33), (0.3, 3.3), dev)
    rows = torch.arange(out[0], dtype=torch.float32, device=dev)
    cols = torch.arange(out[1], dtype=torch.float32, device=dev)
    in_r = (rows >= top[:, None]) & (rows < (top + bh)[:, None])
    in_c = (cols >= left[:, None]) & (cols < (left + bw)[:, None])
    mask = in_r[:, :, None] & in_c[:, None, :] & on[:, None, None]
    x = torch.where(mask[..., None], 0.0, x)
    return normalize(x)


def mix(rng: np.random.Generator, x: torch.Tensor, y: torch.Tensor):
    """CutMix or MixUp (alpha 1 both, a coin a batch), the partner of each
    row the row before it (the batch rolled by one); (images, soft labels)."""
    f32 = np.float32
    roll = lambda t: torch.roll(t, 1, dims=0)
    if rng.random() < 0.5:
        lam = rng.beta(1.0, 1.0)
        _, h, w, _ = x.shape
        cy = float(f32(rng.random()) * f32(h))
        cx = float(f32(rng.random()) * f32(w))
        cut = np.sqrt(f32(1.0) - f32(lam))
        hh, hw = cut * f32(h) / f32(2), cut * f32(w) / f32(2)
        y0, y1 = (np.clip(f32(cy) + d, f32(0), f32(h)) for d in (-hh, hh))
        x0, x1 = (np.clip(f32(cx) + d, f32(0), f32(w)) for d in (-hw, hw))
        lam = float(f32(1.0) - ((y1 - y0) * (x1 - x0)) / f32(h * w))
        rows = torch.arange(h, dtype=torch.float32, device=x.device)
        cols = torch.arange(w, dtype=torch.float32, device=x.device)
        box = (((rows >= float(y0)) & (rows < float(y1)))[:, None]
               & ((cols >= float(x0)) & (cols < float(x1)))[None, :])
        x = torch.where(box[None, :, :, None], roll(x), x)
    else:
        lam = float(f32(rng.beta(1.0, 1.0)))
        x = lam * x + float(f32(1.0) - f32(lam)) * roll(x)
    rest = float(f32(1.0) - f32(lam))
    return x, lam * y + rest * roll(y)


def step_inputs(seed: int, step: int, images_u8: torch.Tensor,
                labels: torch.Tensor, classes: int, out: tuple[int, int]):
    """The normalised, mixed images and soft labels of step ``step``."""
    rng = np.random.default_rng([seed, step])
    gen = torch.Generator(device=images_u8.device)
    gen.manual_seed(int(rng.integers(2 ** 63)))
    x = augment(gen, images_u8.float() / 255.0, out)
    y = torch.nn.functional.one_hot(labels.long(), classes).float()
    return mix(rng, x, y)
