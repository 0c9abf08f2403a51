"""Kernel studies of the slab attention: the roofline peels of K1 and K2 (S5)
and the slab null copy (S6), measurement kernels on no path of the model.

Counterpart of two TPU studies of the JAX package's repository:

- ``tools/roofline_attn.py`` (S5) times cumulative peels of the shipped slab
  kernels on their own grid and data movement, so that the differences of
  adjacent peels attribute the kernel's time. Here
  :func:`slab_attention_peel_forward` and :func:`slab_attention_peel_backward`
  launch K1's and K2's bf16 kernels cut to a level (``Peel`` in
  ``csrc/slab_attention_common.cuh``):

  - ``dma``: the staging and the stores; the output is the input it stores
    (the forward writes q, the backward [q | k | v]);
  - ``layout`` (forward only): ``dma`` plus every fragment load of K and V
    that both sweeps make (ldmatrix, ldmatrix.trans), the Hopper counterpart
    of the TPU's head relayout; the output is still q;
  - ``matmul``: every product of the kernel, with the softmax replaced by
    ``P = S * D^-1/2 / N`` (and ``dS = dP / N``) in f32, P and dS rounded to
    bf16 before their products, as the TPU peels do;
  - ``full``: K1 (K2) itself.

- ``tools/bench_dma.py`` (S6) times a null copy through the slab kernels'
  tilings. :func:`null_copy` launches ``csrc/slab_null_copy.cu``: it reads
  every byte of a bf16 (B, n, 3C) slab through shared memory and writes one
  (B, n, C) third, tiled as :data:`NULL_COPY_VARIANTS` says.

Beside each wrapper is its plain PyTorch version (``*_reference``), the CPU
path and the oracle of the tests and ``chip_smoke.py``. The wrappers take
their plain version only for tensors on the CPU; a CUDA tensor launches the
kernel or raises, and nothing falls back. The kernels are bf16 at D 64 (the
studies' dtype and ViT-L's head dim): f32 raises, the SIMT routes are not
peeled. ``peel_launches``, ``peel_bwd_launches`` and ``null_copy_launches``
count launches by level and variant.
"""
from __future__ import annotations

import torch

from ._build import load_library
from .attention import (
    _check_aligned,
    _check_smem,
    _heads,
    _require_cuda,
    _split_heads,
    slab_attention_backward_reference,
    slab_attention_reference,
)

PEEL_LEVELS = ("dma", "layout", "matmul", "full")
BWD_PEEL_LEVELS = ("dma", "matmul", "full")
_LEVEL_CODES = {level: code for code, level in enumerate(PEEL_LEVELS)}
PEEL_HEAD_DIM = 64
# The study's null-copy variants (the keys of tools/bench_dma.py): the tiling
# of the grid, the whole images one block streams (tiling "images"), and the
# rows the input must have been padded to (None: any).
# - rows64: 64 rows of one image a block, grid (ceil(n / 64), B), as K1 tiles;
# - images: whole images a block, grid (ceil(B / images)); the TPU study's
#   "fewer, bigger DMAs" (img1 is its n197 block, one image a step);
# - lanes: grid (B, 3), each block reads one third; the j = 2 blocks store,
#   so the output is the last third, as the TPU's sequential grid leaves it.
NULL_COPY_VARIANTS = {
    "n197": ("rows64", 1, None),
    "n208": ("rows64", 1, 208),
    "n256": ("rows64", 1, 256),
    "img1": ("images", 1, None),
    "img2": ("images", 2, None),
    "img4": ("images", 4, None),
    "img4n208": ("images", 4, 208),
    "lanes": ("lanes", 1, None),
}
_TILING_CODES = {"rows64": 0, "images": 1, "lanes": 2}

peel_launches = dict.fromkeys(PEEL_LEVELS, 0)
peel_bwd_launches = dict.fromkeys(BWD_PEEL_LEVELS, 0)
null_copy_launches = dict.fromkeys(NULL_COPY_VARIANTS, 0)


def reset_launches() -> None:
    """Sets every launch count of the studies to 0."""
    for counts in (peel_launches, peel_bwd_launches, null_copy_launches):
        for key in counts:
            counts[key] = 0


def _check_choice(name: str, value: str, choices) -> None:
    if value not in choices:
        raise ValueError(f"{name}: unknown {value!r}, expected one of "
                         f"{tuple(choices)}")


def _check_slab(name: str, qkv: torch.Tensor, num_heads: int) -> int:
    """(B, N, 3C) whose C splits into ``num_heads`` heads; returns C."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"{name} expects a (B, N, 3C) slab, got "
                         f"{tuple(qkv.shape)}")
    c = qkv.shape[-1] // 3
    if c % num_heads:
        raise ValueError(f"{name}: C={c} does not split into {num_heads} heads")
    return c


def _check_kernel_slab(name: str, qkv: torch.Tensor, c: int, num_heads: int):
    """What the peel kernels take: bf16, D 64, contiguous, 16-byte aligned, on
    a CUDA device. Raises before any launch otherwise."""
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the peel kernels are bf16 (the SIMT routes "
                        f"are not peeled), got {qkv.dtype}")
    if c // num_heads != PEEL_HEAD_DIM:
        raise ValueError(f"{name}: the peel kernels take head dim "
                         f"{PEEL_HEAD_DIM}, got {c // num_heads}")
    _require_cuda(name, qkv)
    if not qkv.is_contiguous():
        raise ValueError(f"{name} kernel needs contiguous operands")
    _check_aligned(name, qkv, "mma")


def peel_forward_reference(qkv: torch.Tensor, num_heads: int,
                           level: str) -> torch.Tensor:
    """Plain version of a forward peel: (B, N, 3C) -> (B, N, C).

    ``dma`` and ``layout`` return q as it is; ``matmul`` S = Q K^T D^-1/2 in
    f32, P = S * (1 / N) rounded to the input dtype, P V; ``full`` the slab
    attention (:func:`slab_attention_reference`)."""
    _check_choice("peel_forward_reference", level, PEEL_LEVELS)
    c = _check_slab("peel_forward_reference", qkv, num_heads)
    b, n, _ = qkv.shape
    if level in ("dma", "layout"):
        return qkv[..., :c].clone(memory_format=torch.contiguous_format)
    if level == "full":
        return slab_attention_reference(qkv, num_heads)
    q, k, v = _split_heads(qkv, num_heads)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        c // num_heads) ** -0.5
    p = (s * (1.0 / n)).to(qkv.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, n, c)


def peel_backward_reference(qkv: torch.Tensor, g: torch.Tensor,
                            num_heads: int, level: str) -> torch.Tensor:
    """Plain version of a backward peel: slab (B, N, 3C) and upstream g
    (B, N, C) -> (B, N, 3C).

    ``dma`` returns the slab as it is ([q | k | v]); ``matmul`` the slab
    gradient's five products with P = S * (1 / N) and dS = dP * (1 / N) in
    f32 (S = Q K^T D^-1/2, dP = g V^T), dS and P rounded to the input dtype
    before dQ = dS K D^-1/2, dK = dS^T Q D^-1/2, dV = P^T g; ``full`` the slab
    attention's gradient (:func:`slab_attention_backward_reference`)."""
    _check_choice("peel_backward_reference", level, BWD_PEEL_LEVELS)
    c = _check_slab("peel_backward_reference", qkv, num_heads)
    if level == "dma":
        return qkv.clone(memory_format=torch.contiguous_format)
    if level == "full":
        return slab_attention_backward_reference(qkv, g, num_heads)
    b, n, _ = qkv.shape
    dtype = qkv.dtype
    q, k, v = (x.float() for x in _split_heads(qkv, num_heads))
    gh = _heads(g, num_heads).float()
    scale = (c // num_heads) ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, v)
    p_c = (s * (1.0 / n)).to(dtype).float()
    ds_c = (dp * (1.0 / n)).to(dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_c, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_c, q) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p_c, gh)
    return torch.cat([x.to(dtype).reshape(b, n, c) for x in (dq, dk, dv)],
                     dim=-1)


def slab_attention_peel_forward(qkv: torch.Tensor, num_heads: int,
                                level: str) -> torch.Tensor:
    """K1 cut to ``level`` on a (B, N, 3C) slab -> (B, N, C).

    CPU tensors take :func:`peel_forward_reference`. CUDA tensors (bf16, head
    dim 64) launch ``tic_attention_fwd_peel`` on the current stream, without
    synchronising."""
    name = "slab_attention_peel_forward"
    _check_choice(name, level, PEEL_LEVELS)
    if qkv.device.type == "cpu":
        return peel_forward_reference(qkv, num_heads, level)
    c = _check_slab(name, qkv, num_heads)
    _check_kernel_slab(name, qkv, c, num_heads)
    b, n, _ = qkv.shape
    d = c // num_heads
    lib = load_library()
    with torch.cuda.device(qkv.device):
        _check_smem(name, lib, "mma", False, qkv, d, "K and V")
        out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.tic_attention_fwd_peel(qkv.data_ptr(), out.data_ptr(), b, n,
                                         num_heads, d, d ** -0.5,
                                         _LEVEL_CODES[level], stream)
    if err:
        raise RuntimeError(f"{name} ({level}) kernel launch failed with CUDA "
                           f"error {err} (B={b}, N={n}, H={num_heads})")
    peel_launches[level] += 1
    return out


def slab_attention_peel_backward(qkv: torch.Tensor, g: torch.Tensor,
                                 num_heads: int, level: str) -> torch.Tensor:
    """K2 (both passes) cut to ``level``: slab (B, N, 3C) and upstream g
    (B, N, C) -> (B, N, 3C).

    CPU tensors take :func:`peel_backward_reference`. CUDA tensors (bf16,
    head dim 64) launch ``tic_attention_bwd_peel`` on the current stream,
    without synchronising; ``g`` is made contiguous first."""
    name = "slab_attention_peel_backward"
    _check_choice(name, level, BWD_PEEL_LEVELS)
    if qkv.device.type == "cpu" and g.device.type == "cpu":
        return peel_backward_reference(qkv, g, num_heads, level)
    c = _check_slab(name, qkv, num_heads)
    _check_kernel_slab(name, qkv, c, num_heads)
    b, n, _ = qkv.shape
    if g.device != qkv.device or g.dtype != qkv.dtype or g.shape != (b, n, c):
        raise ValueError(f"{name}: g must be ({b}, {n}, {c}) {qkv.dtype} on "
                         f"{qkv.device}, got {tuple(g.shape)} {g.dtype} on "
                         f"{g.device}")
    g = g.contiguous()
    _check_aligned(name, g, "mma")
    d = c // num_heads
    lib = load_library()
    with torch.cuda.device(qkv.device):
        _check_smem(name, lib, "mma", True, qkv, d, "two head operands")
        dqkv = torch.empty_like(qkv)
        stats = torch.empty((3, b, num_heads, n), dtype=torch.float32,
                            device=qkv.device)
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.tic_attention_bwd_peel(qkv.data_ptr(), g.data_ptr(),
                                         dqkv.data_ptr(), stats.data_ptr(), b,
                                         n, num_heads, d, d ** -0.5,
                                         _LEVEL_CODES[level], stream)
    if err:
        raise RuntimeError(f"{name} ({level}) kernel launch failed with CUDA "
                           f"error {err} (B={b}, N={n}, H={num_heads})")
    peel_bwd_launches[level] += 1
    return dqkv


def null_copy_smem_bytes(c: int, variant: str) -> int:
    """Dynamic shared memory of one null-copy block: a ring of 3 stages of 4
    rows, each row 3C bf16 (C for ``lanes``), as ``ring_bytes`` in
    ``csrc/slab_null_copy.cu`` sizes it."""
    _check_choice("null_copy_smem_bytes", variant, NULL_COPY_VARIANTS)
    width = c if NULL_COPY_VARIANTS[variant][0] == "lanes" else 3 * c
    return 3 * 4 * width * 2


def _check_copy_args(name: str, qkv: torch.Tensor, c: int, variant: str):
    _check_choice(name, variant, NULL_COPY_VARIANTS)
    if qkv.dim() != 3 or qkv.shape[-1] != 3 * c:
        raise ValueError(f"{name} expects a (B, n, 3C) slab with C={c}, got "
                         f"{tuple(qkv.shape)}")
    rows = NULL_COPY_VARIANTS[variant][2]
    if rows is not None and qkv.shape[1] != rows:
        raise ValueError(f"{name} ({variant}) takes the slab padded to {rows} "
                         f"rows, got {qkv.shape[1]}")


def null_copy_reference(qkv: torch.Tensor, c: int,
                        variant: str) -> torch.Tensor:
    """Plain version of the null copy: the slab's first third (the last third
    for ``lanes``) as a contiguous (B, n, C)."""
    _check_copy_args("null_copy_reference", qkv, c, variant)
    lo = 2 * c if NULL_COPY_VARIANTS[variant][0] == "lanes" else 0
    return qkv[..., lo:lo + c].clone(memory_format=torch.contiguous_format)


def null_copy(qkv: torch.Tensor, c: int, variant: str) -> torch.Tensor:
    """The null copy of a (B, n, 3C) slab -> (B, n, C), tiled as ``variant``.

    CPU tensors take :func:`null_copy_reference`. CUDA tensors (bf16, C a
    multiple of 8) launch ``tic_slab_null_copy`` on the current stream,
    without synchronising."""
    name = "null_copy"
    _check_copy_args(name, qkv, c, variant)
    if qkv.device.type == "cpu":
        return null_copy_reference(qkv, c, variant)
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the null copy is bf16, got {qkv.dtype}")
    if c % 8:
        raise ValueError(f"{name} copies 16-byte chunks: C={c} must be a "
                         "multiple of 8")
    _require_cuda(name, qkv)
    if not qkv.is_contiguous():
        raise ValueError(f"{name} kernel needs a contiguous slab")
    _check_aligned(name, qkv, "mma")
    tiling, images, _ = NULL_COPY_VARIANTS[variant]
    b, n, _ = qkv.shape
    lib = load_library()
    with torch.cuda.device(qkv.device):
        need = null_copy_smem_bytes(c, variant)
        limit = lib.tic_max_smem_optin(qkv.device.index)
        if need > limit:
            raise ValueError(f"{name} ({variant}) rings {need} bytes of shared "
                             f"memory, {limit} available")
        out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.tic_slab_null_copy(qkv.data_ptr(), out.data_ptr(), b, n, c,
                                     _TILING_CODES[tiling], images, stream)
    if err:
        raise RuntimeError(f"{name} ({variant}) kernel launch failed with CUDA "
                           f"error {err} (B={b}, n={n}, C={c})")
    null_copy_launches[variant] += 1
    return out
