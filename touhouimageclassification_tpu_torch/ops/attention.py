"""Attention: the slab form (K1, K2), the three-operand form (K3) and the
(B, N, H, D) form (K4), one pair of CUDA kernels underneath.

Counterpart of ``touhouimageclassification_tpu/ops/attention.py``:

- the slab form, ``packed_attention_slab`` and its VJP: a (B, N, 3C) fused
  QKV slab (q | k | v along the last dim, head h at columns h*D ... (h+1)*D
  of each third) -> (B, N, C), the gradient one (B, N, 3C) slab
  [dq | dk | dv]; the ViT's ``attention_impl='fused'``;
- the three-operand form, ``packed_attention``: three (B, N, C) operands,
  three gradients; reached by tests and studies, as in JAX;
- the (B, N, H, D) form, ``flash_attention``; the ViT's
  ``attention_impl='flash'``. Its backward is not a kernel in JAX either: it
  differentiates :func:`reference_attention`, recomputed.

The plain PyTorch versions are the CPU path and the oracles the kernels are
held to: :func:`slab_attention_reference` (also the ``'xla'`` attention of
the model, which autograd differentiates), :func:`packed_attention_reference`,
:func:`flash_attention_reference` and the two backward references. The kernel
wrappers take their plain version only for tensors on the CPU; a CUDA tensor
launches the kernel or raises:

- K1 :func:`slab_attention_forward`, K3 :func:`packed_attention_forward` and
  K4 :func:`flash_attention_forward` launch ``csrc/slab_attention_fwd.cu``,
  which reads q, k and v through three base pointers and a row stride;
- K2 :func:`slab_attention_backward` and K3 :func:`packed_attention_backward`
  launch ``csrc/slab_attention_bwd.cu`` the same way.

Each source has two routes, one per dtype (:func:`kernel_route`): bf16
runs on the tensor cores (``mma.sync`` fed by ``cp.async``), f32 on SIMT
FMAs (tensor cores take f32 only as TF32). A launch the route cannot take
raises; nothing falls back.

``launches``, ``bwd_launches`` (K1, K2), ``packed_launches``,
``packed_bwd_launches`` (K3) and ``flash_launches`` (K4) count launches, and
``route_launches`` counts the same launches by route, so a run can show that
its main path went through the kernels, and on which route.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import load_library

launches = 0
bwd_launches = 0
packed_launches = 0
packed_bwd_launches = 0
flash_launches = 0
route_launches = {"mma": 0, "simt": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {torch.bfloat16: "mma", torch.float32: "simt"}
_HEAD_DIMS = (32, 64, 128)
# Bytes a kernel reads at once: the mma route stages 16-byte chunks with
# cp.async, the SIMT route reads element pairs (float2).
_ALIGN = {"mma": 16, "simt": 8}


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, C) -> (B, N, H, D) view."""
    b, n, c = x.shape
    return x.reshape(b, n, num_heads, c // num_heads)


def _split_heads(qkv: torch.Tensor, num_heads: int):
    """(B, N, 3C) slab -> q, k, v as (B, N, H, D) views."""
    b, n, c3 = qkv.shape
    return qkv.reshape(b, n, 3, num_heads, c3 // (3 * num_heads)).unbind(2)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              dropout: float = 0.0) -> torch.Tensor:
    """Plain attention on (B, N, H, D) q, k, v -> (B, N, H, D), as the TPU
    kernels compute it (``_attention_kernel``, ``_packed_fwd_kernel_body``):
    S = Q K^T D^-1/2 in f32, f32 softmax, P cast to the input dtype before
    PV. ``dropout > 0`` drops probabilities after the cast, as the JAX
    model's plain attention does in training."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    p = torch.softmax(s, dim=-1).to(q.dtype)
    if dropout > 0:
        p = F.dropout(p, dropout)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def packed_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               num_heads: int) -> torch.Tensor:
    """Plain attention on three (B, N, C) operands -> (B, N, C)."""
    out = flash_attention_reference(*(_heads(x, num_heads) for x in (q, k, v)))
    return out.reshape(q.shape)


def slab_attention_reference(qkv: torch.Tensor, num_heads: int,
                             dropout: float = 0.0) -> torch.Tensor:
    """Plain attention on the (B, N, 3C) slab -> (B, N, C)."""
    b, n, c3 = qkv.shape
    out = flash_attention_reference(*_split_heads(qkv, num_heads), dropout)
    return out.reshape(b, n, c3 // 3)


def reference_attention(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """``_reference_attention`` cast for cast: S = einsum(q, k) * D^-1/2 in
    the INPUT dtype (bf16 in training), upcast for the softmax, P cast back
    before PV. K4's backward differentiates it, as JAX's ``flash_attention``
    VJP does; in f32 it is :func:`flash_attention_reference`."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _attention_backward_reference(q, k, v, g):
    """(B, N, H, D) q, k, v and g -> dq, dk, dv in the input dtype, cast for
    cast as ``_packed_bwd_kernel_body``: S, P, dP and dS in f32; dS and P
    rounded to the input dtype before the three products; every product
    accumulates in f32 (inputs are upcast, which is exact for bf16 values).

    Not autograd of :func:`flash_attention_reference`: that would hand the
    softmax a dP computed from the bf16-rounded P, which the TPU kernel does
    not; the two agree in f32 only."""
    dtype = q.dtype
    q, k, v, g = (x.float() for x in (q, k, v, g))
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds_c = ds.to(dtype).float()
    p_c = p.to(dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_c, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_c, q) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p_c, g)
    return tuple(x.to(dtype) for x in (dq, dk, dv))


def packed_attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                        v: torch.Tensor, g: torch.Tensor,
                                        num_heads: int):
    """Plain backward of the three-operand attention: (B, N, C) q, k, v and
    upstream g -> (dq, dk, dv), each (B, N, C) in the input dtype."""
    grads = _attention_backward_reference(
        *(_heads(x, num_heads) for x in (q, k, v, g)))
    return tuple(x.reshape(q.shape) for x in grads)


def slab_attention_backward_reference(qkv: torch.Tensor, g: torch.Tensor,
                                      num_heads: int) -> torch.Tensor:
    """Plain backward of the slab attention: the (B, N, 3C) gradient
    [dq | dk | dv] in the input dtype."""
    b, n, c3 = qkv.shape
    grads = _attention_backward_reference(*_split_heads(qkv, num_heads),
                                          _heads(g, num_heads))
    return torch.cat([x.reshape(b, n, c3 // 3) for x in grads], dim=-1)


def kernel_route(dtype: torch.dtype, head_dim: int) -> str:
    """The device route the attention kernels take for ``dtype``: ``'mma'``
    (bf16, tensor cores) or ``'simt'`` (f32). Raises for any other dtype or
    a head dim outside ``(32, 64, 128)``."""
    if dtype not in _ROUTES:
        raise TypeError(f"attention kernels take float32 or bfloat16, got "
                        f"{dtype}")
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"attention kernels take head dims {_HEAD_DIMS}, got "
                         f"{head_dim}")
    return _ROUTES[dtype]


def kernel_smem_bytes(route: str, backward: bool, n: int, d: int) -> int:
    """Dynamic shared memory one block of the forward (or the larger pass of
    the backward) needs at N rows and head dim D; the same sums as the C
    functions ``tic_slab_attention_{fwd,bwd}_smem_bytes``.

    - mma: K and V (backward pass 2: Q and g) of all N rows in bf16 at a
      pitch of D + 8, N rounded up to 16 and at least 64; pass 2 adds three
      f32 statistics per row;
    - simt: two head operands in f32 at a pitch of D + 2, plus f32 rows of
      scores per warp (forward one, backward two, and pass 2's statistics)."""
    if route == "mma":
        rows = max(-(-n // 16) * 16, 64)
        return 2 * rows * (d + 8) * 2 + (3 * rows * 4 if backward else 0)
    operands = 2 * n * (d + 2) * 4
    return operands + (3 * n * 4 + 4 * 2 * n * 4 if backward else 4 * n * 4)


def _check_heads(name: str, dtype: torch.dtype, c: int, num_heads: int) -> str:
    if c % num_heads:
        raise ValueError(f"{name}: C={c} does not split into {num_heads} heads")
    return kernel_route(dtype, c // num_heads)


def _check_kernel_args(name: str, x: torch.Tensor, num_heads: int) -> str:
    if x.dim() != 3 or x.shape[-1] % 3:
        raise ValueError(f"{name} expects a (B, N, 3C) slab, got "
                         f"{tuple(x.shape)}")
    route = _check_heads(name, x.dtype, x.shape[-1] // 3, num_heads)
    _check_dense(name, x, route)
    return route


def _check_dense(name: str, x: torch.Tensor, route: str) -> None:
    if not x.is_contiguous():
        raise ValueError(f"{name} kernel needs contiguous operands")
    _check_aligned(name, x, route)


def _check_aligned(name: str, x: torch.Tensor, route: str) -> None:
    if x.data_ptr() % _ALIGN[route]:
        raise ValueError(f"{name} kernel ({route} route) reads "
                         f"{_ALIGN[route]}-byte chunks: operands must start on "
                         "such a boundary")


def _check_smem(name: str, lib, route: str, backward: bool, x: torch.Tensor,
                d: int, what: str) -> None:
    need = kernel_smem_bytes(route, backward, x.shape[1], d)
    limit = lib.tic_max_smem_optin(x.device.index)
    if need > limit:
        raise ValueError(f"{name} kernel ({route} route) keeps {what} of all "
                         f"{x.shape[1]} rows in shared memory: {need} bytes "
                         f"needed, {limit} available")


def _require_cuda(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {x.device}")


def slab_attention_forward(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Attention forward on a (B, N, 3C) slab -> (B, N, C), no autograd.

    CPU tensors take :func:`slab_attention_reference`. CUDA tensors launch
    K1 on the current stream, without synchronising."""
    global launches
    if qkv.device.type == "cpu":
        return slab_attention_reference(qkv, num_heads)
    _require_cuda("slab_attention", qkv)
    route = _check_kernel_args("slab_attention", qkv, num_heads)
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    code = _DTYPE_CODES[qkv.dtype]
    lib = load_library()
    with torch.cuda.device(qkv.device):
        _check_smem("slab_attention", lib, route, False, qkv, d, "K and V")
        out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.tic_slab_attention_fwd(qkv.data_ptr(), out.data_ptr(), b, n,
                                         num_heads, d, code, d ** -0.5, stream)
    if err:
        raise RuntimeError(f"slab_attention kernel launch failed with CUDA "
                           f"error {err} (B={b}, N={n}, H={num_heads}, D={d}, "
                           f"{qkv.dtype})")
    launches += 1
    route_launches[route] += 1
    return out


def slab_attention_backward(qkv: torch.Tensor, g: torch.Tensor,
                            num_heads: int) -> torch.Tensor:
    """Gradient of the slab attention: slab (B, N, 3C) and upstream g
    (B, N, C) -> (B, N, 3C) [dq | dk | dv].

    CPU tensors take :func:`slab_attention_backward_reference`. CUDA tensors
    launch K2 (both of its passes) on the current stream, without
    synchronising; ``g`` is made contiguous first, as autograd may hand a
    strided gradient."""
    global bwd_launches
    if qkv.device.type == "cpu" and g.device.type == "cpu":
        return slab_attention_backward_reference(qkv, g, num_heads)
    _require_cuda("slab_attention_backward", qkv)
    route = _check_kernel_args("slab_attention_backward", qkv, num_heads)
    b, n, c3 = qkv.shape
    c = c3 // 3
    if g.device != qkv.device or g.dtype != qkv.dtype or g.shape != (b, n, c):
        raise ValueError(f"slab_attention_backward: g must be ({b}, {n}, {c}) "
                         f"{qkv.dtype} on {qkv.device}, got {tuple(g.shape)} "
                         f"{g.dtype} on {g.device}")
    g = g.contiguous()
    _check_dense("slab_attention_backward", g, route)
    d = c // num_heads
    code = _DTYPE_CODES[qkv.dtype]
    lib = load_library()
    with torch.cuda.device(qkv.device):
        _check_smem("slab_attention_backward", lib, route, True, qkv, d,
                    "two head operands")
        dqkv = torch.empty_like(qkv)
        stats = torch.empty((3, b, num_heads, n), dtype=torch.float32,
                            device=qkv.device)
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.tic_slab_attention_bwd(qkv.data_ptr(), g.data_ptr(),
                                         dqkv.data_ptr(), stats.data_ptr(), b,
                                         n, num_heads, d, code, d ** -0.5,
                                         stream)
    if err:
        raise RuntimeError(f"slab_attention_backward kernel launch failed with "
                           f"CUDA error {err} (B={b}, N={n}, H={num_heads}, "
                           f"D={d}, {qkv.dtype})")
    bwd_launches += 1
    route_launches[route] += 1
    return dqkv


class _SlabAttention(torch.autograd.Function):
    """K1 forward, K2 backward (their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
        ctx.save_for_backward(qkv)
        ctx.num_heads = num_heads
        return slab_attention_forward(qkv, num_heads)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (qkv,) = ctx.saved_tensors
        return slab_attention_backward(qkv, g, ctx.num_heads), None


def slab_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Fused attention on a (B, N, 3C) slab -> (B, N, C).

    Without a gradient to track (``torch.no_grad``, ``inference_mode``, or a
    slab that needs none) this is :func:`slab_attention_forward` alone and
    saves nothing; otherwise the autograd function, whose backward is
    :func:`slab_attention_backward`."""
    if qkv.requires_grad and torch.is_grad_enabled():
        return _SlabAttention.apply(qkv, num_heads)
    return slab_attention_forward(qkv, num_heads)


# --- the three-operand form: K3 (three (B, N, C)) and K4 ((B, N, H, D)) -----

def _rows(name: str, xs: tuple[torch.Tensor, ...], num_heads: int):
    """Checks q, k, v (and g) of one shape (B, N, C) or (B, N, H, D) for the
    three-operand kernels; returns them with their shared batch and row
    strides, and the route. Each row's C = H*D elements must be dense, and
    the strides shared and whole multiples of the route's read (16 bytes for
    mma, an element pair for simt); views that are not, such as a
    transposed tensor, are copied to contiguous ones. The model's q, k, v
    views of the (B, N, 3C) slab pass as they are, row stride 3C."""
    x = xs[0]
    if any(y.shape != x.shape or y.dtype != x.dtype or y.device != x.device
           for y in xs) or x.dim() not in (3, 4):
        raise ValueError(f"{name}: operands must share one (B, N, C) or (B, N, "
                         f"H, D) shape, dtype and device, got "
                         + ", ".join(f"{tuple(y.shape)} {y.dtype} {y.device}"
                                     for y in xs))
    b, n = x.shape[:2]
    c = x[0, 0].numel()
    route = _check_heads(name, x.dtype, c, num_heads)
    unit = _ALIGN[route] // x.element_size()

    def dense(y):
        return y.stride(-1) == 1 and (y.dim() == 3 or y.stride(2) == y.shape[3])

    if (len({y.stride()[:2] for y in xs}) != 1 or not all(map(dense, xs))
            or x.stride(0) % unit or x.stride(1) % unit):
        xs = tuple(y.contiguous() for y in xs)
    for y in xs:
        _check_aligned(name, y, route)
    return xs, xs[0].stride(0), xs[0].stride(1), b, n, c, route


def _attention_forward(name: str, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Launches the forward kernel on three operands -> (B, N, C)."""
    (q, k, v), batch_stride, row_stride, b, n, c, route = _rows(
        name, (q, k, v), num_heads)
    d = c // num_heads
    code = _DTYPE_CODES[q.dtype]
    lib = load_library()
    with torch.cuda.device(q.device):
        _check_smem(name, lib, route, False, q, d, "K and V")
        out = torch.empty((b, n, c), dtype=q.dtype, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.tic_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    batch_stride, row_stride, out.data_ptr(), b,
                                    n, num_heads, d, code, d ** -0.5, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err} "
                           f"(B={b}, N={n}, H={num_heads}, D={d}, {q.dtype})")
    route_launches[route] += 1
    return out


def packed_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             num_heads: int) -> torch.Tensor:
    """K3 forward: three (B, N, C) operands -> (B, N, C), no autograd.

    CPU tensors take :func:`packed_attention_reference`. CUDA tensors launch
    the forward kernel on the current stream, without synchronising."""
    global packed_launches
    if q.device.type == "cpu":
        return packed_attention_reference(q, k, v, num_heads)
    _require_cuda("packed_attention", q)
    if q.dim() != 3:
        raise ValueError(f"packed_attention expects (B, N, C) operands, got "
                         f"{tuple(q.shape)}")
    out = _attention_forward("packed_attention", q, k, v, num_heads)
    packed_launches += 1
    return out


def packed_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              g: torch.Tensor, num_heads: int):
    """K3 backward: three (B, N, C) operands and upstream g -> (dq, dk, dv),
    each (B, N, C).

    CPU tensors take :func:`packed_attention_backward_reference`. CUDA
    tensors launch the backward kernel (both passes) on the current stream,
    without synchronising; ``g`` is made contiguous first."""
    global packed_bwd_launches
    if q.device.type == "cpu" and g.device.type == "cpu":
        return packed_attention_backward_reference(q, k, v, g, num_heads)
    name = "packed_attention_backward"
    _require_cuda(name, q)
    if q.dim() != 3:
        raise ValueError(f"{name} expects (B, N, C) operands, got "
                         f"{tuple(q.shape)}")
    (q, k, v), in_batch, in_row, b, n, c, route = _rows(name, (q, k, v),
                                                        num_heads)
    if g.device != q.device or g.dtype != q.dtype or g.shape != q.shape:
        raise ValueError(f"{name}: g must be {tuple(q.shape)} {q.dtype} on "
                         f"{q.device}, got {tuple(g.shape)} {g.dtype} on "
                         f"{g.device}")
    g = g.contiguous()
    _check_dense(name, g, route)
    d = c // num_heads
    code = _DTYPE_CODES[q.dtype]
    lib = load_library()
    with torch.cuda.device(q.device):
        _check_smem(name, lib, route, True, q, d, "two head operands")
        dq, dk, dv = (torch.empty((b, n, c), dtype=q.dtype, device=q.device)
                      for _ in range(3))
        stats = torch.empty((3, b, num_heads, n), dtype=torch.float32,
                            device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.tic_attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    in_batch, in_row, g.data_ptr(),
                                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                    n * c, c, stats.data_ptr(), b, n, num_heads,
                                    d, code, d ** -0.5, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err} "
                           f"(B={b}, N={n}, H={num_heads}, D={d}, {q.dtype})")
    packed_bwd_launches += 1
    route_launches[route] += 1
    return dq, dk, dv


def backward_probabilities(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           g: torch.Tensor, num_heads: int):
    """A measurement on the card, on no path of the model: runs the bf16
    backward (both passes) on three contiguous (B, N, C) CUDA operands and
    returns the probabilities each pass forms, two f32 (B, H, N, N) tensors
    P[i, j] (pass 1 by query rows, pass 2 by key rows), so that their
    difference can be read. Counts no launch."""
    name = "backward_probabilities"
    _require_cuda(name, q)
    if q.dtype != torch.bfloat16 or q.dim() != 3:
        raise ValueError(f"{name} takes bf16 (B, N, C) operands, got "
                         f"{tuple(q.shape)} {q.dtype}")
    q, k, v, g = (x.contiguous() for x in (q, k, v, g))
    (q, k, v), in_batch, in_row, b, n, c, route = _rows(name, (q, k, v),
                                                        num_heads)
    d = c // num_heads
    lib = load_library()
    with torch.cuda.device(q.device):
        _check_smem(name, lib, route, True, q, d, "two head operands")
        grads = [torch.empty_like(q) for _ in range(3)]
        stats = torch.empty((3, b, num_heads, n), dtype=torch.float32,
                            device=q.device)
        probes = [torch.full((b, num_heads, n, n), float("nan"),
                             device=q.device) for _ in range(2)]
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.tic_attention_bwd_probes(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), in_batch, in_row,
            g.data_ptr(), *(x.data_ptr() for x in grads), n * c, c,
            stats.data_ptr(), b, n, num_heads, d, d ** -0.5,
            *(x.data_ptr() for x in probes), stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
    return tuple(probes)


class _PackedAttention(torch.autograd.Function):
    """K3 forward and backward (their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int) -> torch.Tensor:
        ctx.save_for_backward(q, k, v)
        ctx.num_heads = num_heads
        return packed_attention_forward(q, k, v, num_heads)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        q, k, v = ctx.saved_tensors
        return (*packed_attention_backward(q, k, v, g, ctx.num_heads), None)


def packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_heads: int) -> torch.Tensor:
    """Attention on three (B, N, C) operands, heads as contiguous C-slices
    (counterpart of JAX ``packed_attention``) -> (B, N, C). Its gradient is
    :func:`packed_attention_backward`, three (B, N, C) tensors."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _PackedAttention.apply(q, k, v, num_heads)
    return packed_attention_forward(q, k, v, num_heads)


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """K4: (B, N, H, D) q, k, v -> (B, N, H, D), no autograd.

    CPU tensors take :func:`flash_attention_reference`. CUDA tensors launch
    the forward kernel on the current stream, without synchronising. Any
    (B, N, H, D) views whose (H, D) rows are dense and share their strides
    pass without a copy: the model hands it the q, k, v views of its
    (B, N, 3C) QKV projection, row stride 3C."""
    global flash_launches
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    _require_cuda("flash_attention", q)
    if q.dim() != 4:
        raise ValueError(f"flash_attention expects (B, N, H, D) operands, got "
                         f"{tuple(q.shape)}")
    out = _attention_forward("flash_attention", q, k, v, q.shape[2])
    flash_launches += 1
    return out.view(q.shape)


class _FlashAttention(torch.autograd.Function):
    """K4 forward; the backward recomputes :func:`reference_attention` and
    differentiates it, as JAX's ``flash_attention`` VJP (``_bwd``) does."""

    @staticmethod
    def forward(ctx, q, k, v) -> torch.Tensor:
        ctx.save_for_backward(q, k, v)
        return flash_attention_forward(q, k, v)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        inputs = tuple(x.detach().requires_grad_() for x in ctx.saved_tensors)
        with torch.enable_grad():
            out = reference_attention(*inputs)
        return torch.autograd.grad(out, inputs, g)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Attention on (B, N, H, D) tensors (counterpart of JAX
    ``flash_attention``, the ViT's ``attention_impl='flash'``) ->
    (B, N, H, D): the K4 forward, and where a gradient is needed the plain
    recomputed backward of :class:`_FlashAttention`."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v)
    return flash_attention_forward(q, k, v)
