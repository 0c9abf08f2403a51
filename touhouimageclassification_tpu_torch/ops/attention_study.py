"""Kernel studies of the slab attention: the roofline peels of K1 and K2 (S5),
the slab null copy (S6) and the tiles of K1 and K2 (S1-S4), measurement
kernels on no path of the model.

Counterpart of six TPU studies of the JAX package's repository:

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

- ``tools/bench_attn4.py`` (S1, whole images a grid step),
  ``tools/bench_attn6.py`` (S2, exp vs exp2 and the divide of P vs 1 / l
  after PV), ``tools/bench_attn7.py`` (S3, head batching) and
  ``tools/bench_attn8.py`` (S4, H / S heads a step) time the forward (and
  backward) with another grid step. Here a :class:`Tile` says what one block
  of 4 warps walks: whole images, heads, heads staged together, all rows of a
  head or 64, and the ring stages of ``cp.async`` staging
  (``csrc/slab_attention_tile.cu``); :data:`STUDY_TILES` maps each study key
  to its tile. :func:`slab_attention_tile_forward` and
  :func:`slab_attention_tile_backward` run K1's and K2's arithmetic on a tile,
  so their plain versions are K1's and K2's and their outputs K1's and K2's
  bit for bit; :func:`softmax_variant_forward` runs S2's four softmax
  variants on K1's own kernel and grid (``post_mul`` a template argument of
  ``csrc/slab_attention_fwd.cu``), beside :func:`softmax_variant_reference`.

"K1" in these studies is K1's ``mma.sync`` kernel (``csrc/slab_attention_fwd.cu``):
the model's bf16 forward at head dim 64 and N <= 256 has since moved to the
Hopper ``wgmma`` route (``csrc/slab_attention_fwd_sm90.cu``), and the
``mma.sync`` kernel stays the route of the other bf16 shapes. The studies
dissect that kernel, so they are held to it: the ``full`` peel, every forward
tile and S2's exp2 variant without ``post_mul`` equal it bit for bit (that
variant is the kernel itself, the twin ``chip_smoke.py`` holds them to).

Beside each wrapper is its plain PyTorch version (``*_reference``), the CPU
path and the oracle of the tests and ``chip_smoke.py``. The wrappers take
their plain version only for tensors on the CPU; a CUDA tensor launches the
kernel or raises, and nothing falls back. The kernels are bf16 at D 64 (the
studies' dtype and ViT-L's head dim): f32 raises, the SIMT routes are not
peeled. ``peel_launches``, ``peel_bwd_launches``, ``null_copy_launches``,
``tile_launches``, ``tile_bwd_launches`` and ``softmax_launches`` count
launches by level, variant and tile.
"""
from __future__ import annotations

import itertools
from typing import NamedTuple

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


class Tile(NamedTuple):
    """What one block of a tile kernel walks (``csrc/slab_attention_tile.cu``):
    ``images`` whole images; the heads of an image split over ``splits``
    blocks (``None``: a block per head); ``staged`` heads staged together (2:
    the 256-byte row segment of two adjacent heads); every row of a head
    (``all_rows``) or 64 rows a block; ``stages`` ring stages of the staged
    operands (2: the next item lands while the block computes this one)."""

    images: int = 1
    splits: int | None = 1
    staged: int = 1
    all_rows: bool = True
    stages: int = 2


# K1's and K2's own tile: grid (ceil(N / 64), H, B), one stage. S2's variants
# run on K1's kernel itself; the tile kernels on it measure what the tile
# machinery costs.
SHIPPED_TILE = Tile(splits=None, all_rows=False, stages=1)
LOOP_TILE = Tile()
# The studies' keys (the JSON keys of the TPU tools) -> tiles. Shared
# configurations are one tile: S1 ``block_b`` 1 = S3 ``loop`` = S4 ``splits``
# 1, S1 ``block_b`` 2 = S3 ``loop-i2``. S3's ``batched`` stacks the heads in
# the TPU's vregs, which the Hopper kernels address by column offset: it is
# the ``loop`` tile. S2's keys are (exp2, post_mul) on the shipped tile.
SOFTMAX_VARIANTS = tuple(itertools.product((False, True), repeat=2))
STUDY_TILES = {
    "S1": {1: LOOP_TILE, 2: Tile(images=2), 4: Tile(images=4)},
    "S2": dict.fromkeys(SOFTMAX_VARIANTS, SHIPPED_TILE),
    "S3": {"loop": LOOP_TILE, "batched": LOOP_TILE,
           "pairs": Tile(staged=2, stages=1), "loop-i2": Tile(images=2)},
    "S4": {1: LOOP_TILE, 2: Tile(splits=2), 4: Tile(splits=4)},
}
# The keys whose TPU study also times a backward.
STUDY_BACKWARD = {"S3": ("loop", "batched", "loop-i2"), "S4": (1, 2, 4)}
FWD_TILES = tuple(dict.fromkeys(
    tile for study in ("S1", "S3", "S4")
    for tile in STUDY_TILES[study].values()))
BWD_TILES = tuple(dict.fromkeys(
    STUDY_TILES[study][key] for study, keys in STUDY_BACKWARD.items()
    for key in keys))
_LOG2E = 1.4426950408889634

peel_launches = dict.fromkeys(PEEL_LEVELS, 0)
peel_bwd_launches = dict.fromkeys(BWD_PEEL_LEVELS, 0)
null_copy_launches = dict.fromkeys(NULL_COPY_VARIANTS, 0)
tile_launches = dict.fromkeys(FWD_TILES, 0)
tile_bwd_launches = dict.fromkeys(BWD_TILES, 0)
softmax_launches = dict.fromkeys(SOFTMAX_VARIANTS, 0)


def reset_launches() -> None:
    """Sets every launch count of the studies to 0."""
    for counts in (peel_launches, peel_bwd_launches, null_copy_launches,
                   tile_launches, tile_bwd_launches, softmax_launches):
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
    """What the study kernels take: bf16, D 64, contiguous, 16-byte aligned,
    on a CUDA device. Raises before any launch otherwise."""
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the study kernels are bf16 (the SIMT routes "
                        f"are not studied), got {qkv.dtype}")
    if c // num_heads != PEEL_HEAD_DIM:
        raise ValueError(f"{name}: the study kernels take head dim "
                         f"{PEEL_HEAD_DIM}, got {c // num_heads}")
    _require_cuda(name, qkv)
    if not qkv.is_contiguous():
        raise ValueError(f"{name} kernel needs contiguous operands")
    _check_aligned(name, qkv, "mma")


def _check_forward(name: str, qkv: torch.Tensor, num_heads: int):
    """The slab a study forward kernel takes; returns (B, N, C, D)."""
    c = _check_slab(name, qkv, num_heads)
    _check_kernel_slab(name, qkv, c, num_heads)
    b, n, _ = qkv.shape
    return b, n, c, c // num_heads


def _check_upstream(name: str, qkv: torch.Tensor, g: torch.Tensor,
                    c: int) -> torch.Tensor:
    """The upstream gradient a backward kernel takes: (B, N, C) of the slab's
    dtype on its device, made contiguous."""
    b, n, _ = qkv.shape
    if g.device != qkv.device or g.dtype != qkv.dtype or g.shape != (b, n, c):
        raise ValueError(f"{name}: g must be ({b}, {n}, {c}) {qkv.dtype} on "
                         f"{qkv.device}, got {tuple(g.shape)} {g.dtype} on "
                         f"{g.device}")
    g = g.contiguous()
    _check_aligned(name, g, "mma")
    return g


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
    b, n, c, d = _check_forward(name, qkv, num_heads)
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
    g = _check_upstream(name, qkv, g, c)
    b, n, _ = qkv.shape
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


# --- S1-S4: the tiles of K1 and K2 -------------------------------------------

def tile_heads(tile: Tile, num_heads: int, backward: bool = False) -> int:
    """Heads one block of ``tile`` takes of an image's ``num_heads``. Raises
    ``ValueError`` for a tile the kernels do not take: heads a block that do
    not divide H or are not whole groups of ``staged``, and, ``backward``, a
    tile that stages two heads (the study's ``pairs`` is forward only)."""
    if not isinstance(tile, Tile):
        raise TypeError(f"expected a Tile, got {tile!r}")
    if (tile.images < 1 or tile.staged not in (1, 2)
            or tile.stages not in (1, 2)
            or (tile.splits is not None and tile.splits < 1)):
        raise ValueError(f"not a tile the kernels take: {tile}")
    if tile.splits is None:
        heads = 1
    elif num_heads % tile.splits:
        raise ValueError(f"{num_heads} heads do not split into {tile.splits} "
                         f"blocks of whole heads ({tile})")
    else:
        heads = num_heads // tile.splits
    if heads % tile.staged:
        raise ValueError(f"{heads} heads a block are not whole groups of "
                         f"{tile.staged} staged heads ({tile})")
    if backward and tile.staged != 1:
        raise ValueError(f"the backward stages one head at a time ({tile})")
    return heads


def tile_grid(tile: Tile, b: int, n: int, num_heads: int) -> tuple:
    """The grid (x, y, z) of a tile launch: row blocks (1 with all rows),
    head groups and image groups (the last one ragged where B is not a
    multiple of ``images``)."""
    rows = 1 if tile.all_rows else -(-n // 64)
    return (rows, num_heads // tile_heads(tile, num_heads),
            -(-b // tile.images))


def tile_smem_bytes(tile: Tile, n: int, d: int, backward: bool) -> int:
    """Dynamic shared memory of one tile block, as
    ``tic_attention_tile_smem_bytes`` sums it: ``stages`` stages of K and V
    of ``staged`` heads (the backward's larger pass 2: Q and g and three f32
    statistics a row), each head N rows rounded up to 16 (at least 64) at a
    pitch of D + 8 bf16, and the output area of 4 warps x 16 rows."""
    rows = max(-(-n // 16) * 16, 64)
    head = rows * (d + 8) * 2
    out = 4 * 16 * (d + 8) * 2
    if backward:
        return tile.stages * (2 * head + 3 * rows * 4) + out
    return tile.stages * 2 * tile.staged * head + out


def _check_tile_smem(name: str, lib, tile: Tile, n: int, d: int,
                     backward: bool, device: int) -> None:
    need = tile_smem_bytes(tile, n, d, backward)
    limit = lib.tic_max_smem_optin(device)
    if need > limit:
        raise ValueError(f"{name}: {tile} stages {need} bytes of shared memory "
                         f"at N={n}, {limit} available")


def softmax_variant_reference(qkv: torch.Tensor, num_heads: int, exp2: bool,
                              post_mul: bool) -> torch.Tensor:
    """Plain version of an S2 variant (``make_fwd`` of
    tools/bench_attn6.py), cast for cast: S = Q K^T in f32 times D^-1/2 (and
    log2(e) for ``exp2``), e = exp2 (or exp) of S - max; ``post_mul``: e
    rounded to the input dtype, O = (e V) * (1 / sum e); else P = e / sum e
    rounded, O = P V; O rounded to the input dtype. (B, N, 3C) -> (B, N, C)."""
    c = _check_slab("softmax_variant_reference", qkv, num_heads)
    b, n, _ = qkv.shape
    dtype = qkv.dtype
    q, k, v = (x.float() for x in _split_heads(qkv, num_heads))
    scale = (c // num_heads) ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (
        scale * _LOG2E if exp2 else scale)
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp2(s) if exp2 else torch.exp(s)
    total = e.sum(dim=-1, keepdim=True)
    if post_mul:
        o = torch.einsum("bhqk,bkhd->bhqd", e.to(dtype).float(), v) * (
            1.0 / total)
    else:
        o = torch.einsum("bhqk,bkhd->bhqd", (e / total).to(dtype).float(), v)
    return o.transpose(1, 2).to(dtype).reshape(b, n, c)


def slab_attention_tile_forward(qkv: torch.Tensor, num_heads: int,
                                tile: Tile) -> torch.Tensor:
    """K1's forward on ``tile``: (B, N, 3C) slab -> (B, N, C).

    CPU tensors take :func:`slab_attention_reference` (a tile changes who
    computes, not what). CUDA tensors (bf16, head dim 64) launch
    ``tic_attention_fwd_tile`` on the current stream, without
    synchronising."""
    name = "slab_attention_tile_forward"
    heads = tile_heads(tile, num_heads)
    if qkv.device.type == "cpu":
        return slab_attention_reference(qkv, num_heads)
    b, n, c, d = _check_forward(name, qkv, num_heads)
    lib = load_library()
    with torch.cuda.device(qkv.device):
        _check_tile_smem(name, lib, tile, n, d, False, qkv.device.index)
        out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.tic_attention_fwd_tile(
            qkv.data_ptr(), out.data_ptr(), b, n, num_heads, d, d ** -0.5,
            tile.images, heads, tile.staged, int(tile.all_rows), tile.stages,
            stream)
    if err:
        raise RuntimeError(f"{name} ({tile}) kernel launch failed with CUDA "
                           f"error {err} (B={b}, N={n}, H={num_heads})")
    tile_launches[tile] = tile_launches.get(tile, 0) + 1
    return out


def softmax_variant_forward(qkv: torch.Tensor, num_heads: int, exp2: bool,
                            post_mul: bool) -> torch.Tensor:
    """An S2 softmax variant on K1's kernel and grid: (B, N, 3C) ->
    (B, N, C). ``exp2`` without ``post_mul`` is K1.

    CPU tensors take :func:`softmax_variant_reference`. CUDA tensors (bf16,
    head dim 64) launch ``tic_attention_fwd_softmax`` on the current stream,
    without synchronising."""
    name = "softmax_variant_forward"
    key = (bool(exp2), bool(post_mul))
    if qkv.device.type == "cpu":
        return softmax_variant_reference(qkv, num_heads, *key)
    b, n, c, d = _check_forward(name, qkv, num_heads)
    lib = load_library()
    with torch.cuda.device(qkv.device):
        _check_smem(name, lib, "mma", False, qkv, d, "K and V")
        out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.tic_attention_fwd_softmax(
            qkv.data_ptr(), out.data_ptr(), b, n, num_heads, d, d ** -0.5,
            int(key[0]), int(key[1]), stream)
    if err:
        raise RuntimeError(f"{name} {key} kernel launch failed with CUDA "
                           f"error {err} (B={b}, N={n}, H={num_heads})")
    softmax_launches[key] += 1
    return out


def slab_attention_tile_backward(qkv: torch.Tensor, g: torch.Tensor,
                                 num_heads: int, tile: Tile) -> torch.Tensor:
    """K2 (both passes) on ``tile``: slab (B, N, 3C) and upstream g
    (B, N, C) -> (B, N, 3C).

    CPU tensors take :func:`slab_attention_backward_reference`. CUDA tensors
    (bf16, head dim 64) launch ``tic_attention_bwd_tile`` on the current
    stream, without synchronising; ``g`` is made contiguous first."""
    name = "slab_attention_tile_backward"
    heads = tile_heads(tile, num_heads, backward=True)
    if qkv.device.type == "cpu" and g.device.type == "cpu":
        return slab_attention_backward_reference(qkv, g, num_heads)
    c = _check_slab(name, qkv, num_heads)
    _check_kernel_slab(name, qkv, c, num_heads)
    g = _check_upstream(name, qkv, g, c)
    b, n, _ = qkv.shape
    d = c // num_heads
    lib = load_library()
    with torch.cuda.device(qkv.device):
        _check_tile_smem(name, lib, tile, n, d, True, qkv.device.index)
        dqkv = torch.empty_like(qkv)
        stats = torch.empty((3, b, num_heads, n), dtype=torch.float32,
                            device=qkv.device)
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.tic_attention_bwd_tile(
            qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), stats.data_ptr(), b,
            n, num_heads, d, d ** -0.5, tile.images, heads, int(tile.all_rows),
            tile.stages, stream)
    if err:
        raise RuntimeError(f"{name} ({tile}) kernel launch failed with CUDA "
                           f"error {err} (B={b}, N={n}, H={num_heads})")
    tile_bwd_launches[tile] = tile_bwd_launches.get(tile, 0) + 1
    return dqkv
