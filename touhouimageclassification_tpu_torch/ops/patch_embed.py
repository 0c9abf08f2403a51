"""Patch embedding: space-to-depth + projection + bias (K5).

Counterpart of ``touhouimageclassification_tpu/ops/patch_embed.py``
(``pallas_patch_embed``), the ViT's ``patch_embed_impl='pallas'``: NHWC
images (B, H, W, C) unfolded into P x P patches in (ph, pw, c) order, times
the projection, plus the bias, summed in f32 with one rounding to the image
dtype. The weight is the port's ``patch_embed.proj.weight`` as stored, (D, K)
in ``nn.Linear`` layout, K = P*P*C.

- :func:`patch_embed_reference` is the plain version (``_xla_forward``): the
  CPU path and the oracle the kernel is held to.
- :func:`patch_embed_forward` wraps the CUDA kernel
  (``csrc/patch_embed.cu``, an implicit-im2col GEMM); it takes the plain
  version only for tensors on the CPU, and a CUDA tensor launches the kernel
  or raises. ``launches`` counts its launches, ``route_launches`` the same
  launches by device route (:func:`kernel_route`): bf16 runs on the tensor
  cores (``'wgmma'``: the weight by TMA, the image gathered with
  ``cp.async``), f32 on SIMT FMAs (``'simt'``; the tensor cores take f32
  only as TF32). A bf16 shape the tensor-core route cannot take raises.
- :func:`patch_embed` is a ``torch.autograd.Function``: the kernel forward
  and the plain backward of JAX's ``_bwd`` (the unfold is a permutation, so
  the gradients are two products and a sum, in f32, cast to the operands'
  dtypes).

This is not the model's ``'xla'`` patch embedding, which rounds the product
to the compute dtype before a bias add in that dtype (``models/vit.py``):
in bf16 the two differ by that rounding, in JAX too.
"""
from __future__ import annotations

import torch

from ._build import load_library

launches = 0
route_launches = {"wgmma": 0, "simt": 0}
# every launch counter of this module, which a replayed CUDA graph credits
# (``train/step_graph.py``)
LAUNCH_COUNTERS = ("launches", "route_launches")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {torch.bfloat16: "wgmma", torch.float32: "simt"}


def unfold(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, P*P*C) in (ph, pw, c) order (``_unfold``)."""
    b, h, w, c = images.shape
    x = images.reshape(b, h // patch, patch, w // patch, patch, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, -1, patch * patch * c)


def fold(unfolded: torch.Tensor, patch: int, h: int, w: int, c: int) -> torch.Tensor:
    """Inverse of :func:`unfold` (``_fold``)."""
    b = unfolded.shape[0]
    x = unfolded.reshape(b, h // patch, w // patch, patch, patch, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def patch_embed_reference(images: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, patch: int) -> torch.Tensor:
    """Plain patch embedding: the f32 product of the unfolded images and the
    (D, K) weight, plus the f32 bias, rounded once to the image dtype."""
    y = torch.einsum("bnk,dk->bnd", unfold(images, patch).float(),
                     weight.float())
    return (y + bias.float()).to(images.dtype)


def kernel_route(dtype: torch.dtype, patch: int, c: int, w: int) -> str:
    """The device route K5 takes for ``dtype`` at patch P, C channels and
    image width W: ``'wgmma'`` (bf16, tensor cores) or ``'simt'`` (f32).
    Raises TypeError for any other dtype, and ValueError for a bf16 shape
    the tensor-core route cannot take: its 16-byte image copies need P*C
    and W*C to be multiples of 8 elements, and its k16 steps a K = P*P*C
    that is a multiple of 16 (ViT at P 16 or 8, C 3 and any W that is a
    multiple of 8 qualifies)."""
    if dtype not in _ROUTES:
        raise TypeError(f"patch_embed kernel takes float32 or bfloat16, got "
                        f"{dtype}")
    if dtype == torch.bfloat16 and ((patch * c) % 8 or (w * c) % 8
                                    or (patch * patch * c) % 16):
        raise ValueError(f"patch_embed bf16 kernel (wgmma route) needs P*C "
                         f"and W*C multiples of 8 and P*P*C a multiple of 16, "
                         f"got P={patch}, C={c}, W={w}")
    return _ROUTES[dtype]


def _check(images: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           patch: int) -> str:
    """Shapes, dtypes and devices of the kernel's operands; returns the
    route (:func:`kernel_route`, which raises for an unsupported dtype)."""
    if images.dim() != 4:
        raise ValueError(f"patch_embed expects (B, H, W, C) images, got "
                         f"{tuple(images.shape)}")
    b, h, w, c = images.shape
    if h % patch or w % patch:
        raise ValueError(f"patch_embed: image {h}x{w} is not a multiple of "
                         f"patch {patch}")
    d = weight.shape[0]
    if weight.shape != (d, patch * patch * c) or bias.shape != (d,):
        raise ValueError(f"patch_embed: weight must be (D, {patch * patch * c}) "
                         f"and bias (D,), got {tuple(weight.shape)} and "
                         f"{tuple(bias.shape)}")
    for x in (weight, bias):
        if x.dtype != images.dtype or x.device != images.device:
            raise ValueError(f"patch_embed: weight and bias must be "
                             f"{images.dtype} on {images.device}, got "
                             f"{x.dtype} on {x.device}")
    return kernel_route(images.dtype, patch, c, w)


def patch_embed_forward(images: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, patch: int) -> torch.Tensor:
    """K5: images (B, H, W, C), weight (D, P*P*C), bias (D,) -> (B, N, D), no
    autograd. CPU tensors take :func:`patch_embed_reference`. CUDA tensors
    launch the kernel on the current stream, without synchronising; the
    three operands are made contiguous (a no-op for the model's)."""
    global launches
    if images.device.type == "cpu":
        return patch_embed_reference(images, weight, bias, patch)
    if images.device.type != "cuda":
        raise ValueError(f"patch_embed runs on cpu or cuda, got {images.device}")
    route = _check(images, weight, bias, patch)
    images, weight, bias = (x.contiguous() for x in (images, weight, bias))
    if route == "wgmma" and (images.data_ptr() % 16 or weight.data_ptr() % 16):
        raise ValueError("patch_embed kernel (wgmma route) reads 16-byte "
                         "chunks: images and weight must start on such a "
                         "boundary")
    b, h, w, c = images.shape
    d = weight.shape[0]
    lib = load_library()
    with torch.cuda.device(images.device):
        out = torch.empty((b, (h // patch) * (w // patch), d),
                          dtype=images.dtype, device=images.device)
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = lib.tic_patch_embed(images.data_ptr(), weight.data_ptr(),
                                  bias.data_ptr(), out.data_ptr(), b, h, w, c,
                                  patch, d, _DTYPE_CODES[images.dtype], stream)
    if err:
        raise RuntimeError(f"patch_embed kernel launch failed with CUDA error "
                           f"{err} (B={b}, H={h}, W={w}, C={c}, P={patch}, "
                           f"D={d}, {images.dtype})")
    launches += 1
    route_launches[route] += 1
    return out


class _PatchEmbed(torch.autograd.Function):
    """K5 forward; the plain backward of JAX's ``_bwd``."""

    @staticmethod
    def forward(ctx, images, weight, bias, patch: int) -> torch.Tensor:
        ctx.save_for_backward(images, weight)
        ctx.patch = patch
        ctx.bias_dtype = bias.dtype
        return patch_embed_forward(images, weight, bias, patch)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        images, weight = ctx.saved_tensors
        patch = ctx.patch
        gf = g.float()
        d_images = d_weight = d_bias = None
        if ctx.needs_input_grad[0]:
            b, h, w, c = images.shape
            d_unfolded = torch.einsum("bnd,dk->bnk", gf, weight.float())
            d_images = fold(d_unfolded, patch, h, w, c).to(images.dtype)
        if ctx.needs_input_grad[1]:
            d_weight = torch.einsum("bnd,bnk->dk", gf,
                                    unfold(images, patch).float()).to(weight.dtype)
        if ctx.needs_input_grad[2]:
            d_bias = gf.sum(dim=(0, 1)).to(ctx.bias_dtype)
        return d_images, d_weight, d_bias, None


def patch_embed(images: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                patch: int) -> torch.Tensor:
    """images (B, H, W, C) x weight (D, P*P*C) + bias (D,) -> (B, N, D)
    (counterpart of JAX ``pallas_patch_embed``, with the weight in
    ``nn.Linear`` layout)."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (images, weight, bias)):
        return _PatchEmbed.apply(images, weight, bias, patch)
    return patch_embed_forward(images, weight, bias, patch)
