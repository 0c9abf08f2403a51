"""Slab attention: multi-head self-attention on the fused (B, N, 3C) QKV slab.

Counterpart of ``touhouimageclassification_tpu/ops/attention.py``'s slab form
(``packed_attention_slab`` and its VJP). The slab holds q | k | v along the
last dim, head h at columns h*D ... (h+1)*D of each third; the result is
(B, N, C) with the heads concatenated, and the gradient one (B, N, 3C) slab
[dq | dk | dv].

- :func:`slab_attention_reference` and :func:`slab_attention_backward_reference`
  are the plain PyTorch versions: the CPU path and the oracles the kernels are
  held to. The first is also the ``'xla'`` attention of the model, which
  autograd differentiates.
- :func:`slab_attention_forward` (K1, ``csrc/slab_attention_fwd.cu``) and
  :func:`slab_attention_backward` (K2, ``csrc/slab_attention_bwd.cu``) wrap
  the CUDA kernels. Each takes its plain version only for tensors on the CPU;
  a CUDA tensor launches the kernel or raises.
- :func:`slab_attention` is the ``'fused'`` attention: the forward wrapper,
  and, where a gradient is needed, a ``torch.autograd.Function`` that saves
  only the slab (as ``_slab_fwd_rule`` does) and runs the backward wrapper.

``launches`` and ``bwd_launches`` count K1 and K2 launches, so a run can show
that its main path went through the kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import load_library

launches = 0
bwd_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def _split_heads(qkv: torch.Tensor, num_heads: int):
    """(B, N, 3C) slab -> q, k, v as (B, N, H, D) views."""
    b, n, c3 = qkv.shape
    return qkv.reshape(b, n, 3, num_heads, c3 // (3 * num_heads)).unbind(2)


def slab_attention_reference(qkv: torch.Tensor, num_heads: int,
                             dropout: float = 0.0) -> torch.Tensor:
    """Plain attention on the slab: S = Q K^T D^-1/2 in f32, f32 softmax, P
    cast to the input dtype before PV (as ``_packed_fwd_kernel_body`` does).
    ``dropout > 0`` drops probabilities after the cast, as the JAX model's
    plain attention does in training."""
    b, n, c3 = qkv.shape
    q, k, v = _split_heads(qkv, num_heads)                     # (B, N, H, D)
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    if dropout > 0:
        p = F.dropout(p, dropout)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, n, c3 // 3)


def slab_attention_backward_reference(qkv: torch.Tensor, g: torch.Tensor,
                                      num_heads: int) -> torch.Tensor:
    """Plain backward of the slab attention, cast for cast as
    ``_packed_bwd_kernel_body``: S, P, dP and dS in f32; dS and P rounded to
    the input dtype before the three products; every product accumulates in
    f32 (inputs are upcast, which is exact for bf16 values). Returns the
    (B, N, 3C) gradient [dq | dk | dv] in the input dtype.

    Not autograd of :func:`slab_attention_reference`: that would hand the
    softmax a dP computed from the bf16-rounded P, which the TPU kernel does
    not; the two agree in f32 only."""
    b, n, c3 = qkv.shape
    dtype = qkv.dtype
    q, k, v = (x.float() for x in _split_heads(qkv, num_heads))  # (B, N, H, D)
    d = q.shape[-1]
    scale = d ** -0.5
    gh = g.reshape(b, n, num_heads, d).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, v)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds_c = ds.to(dtype).float()
    p_c = p.to(dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_c, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_c, q) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p_c, gh)
    return torch.cat([x.reshape(b, n, c3 // 3) for x in (dq, dk, dv)],
                     dim=-1).to(dtype)


def _check_kernel_args(name: str, x: torch.Tensor, num_heads: int) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or x.shape[-1] % 3:
        raise ValueError(f"{name} expects a (B, N, 3C) slab, got "
                         f"{tuple(x.shape)}")
    c = x.shape[-1] // 3
    if c % num_heads or c // num_heads not in _HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head dims {_HEAD_DIMS}; C={c} "
                         f"with {num_heads} heads gives {c / num_heads:g}")
    _check_pairs(name, x)


def _check_pairs(name: str, x: torch.Tensor) -> None:
    if not x.is_contiguous():
        raise ValueError(f"{name} kernel needs contiguous operands")
    if x.data_ptr() % (2 * x.element_size()):
        raise ValueError(f"{name} kernel reads element pairs: operands must "
                         "start on a pair boundary")


def _check_smem(name: str, lib, need: int, x: torch.Tensor, what: str) -> None:
    limit = lib.tic_max_smem_optin(x.device.index)
    if need > limit:
        raise ValueError(f"{name} kernel keeps {what} of all {x.shape[1]} rows "
                         f"in shared memory: {need} bytes needed, {limit} "
                         "available")


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
    _check_kernel_args("slab_attention", qkv, num_heads)
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    code = _DTYPE_CODES[qkv.dtype]
    lib = load_library()
    with torch.cuda.device(qkv.device):
        _check_smem("slab_attention", lib,
                    lib.tic_slab_attention_fwd_smem_bytes(n, d, code), qkv,
                    "K and V")
        out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.tic_slab_attention_fwd(qkv.data_ptr(), out.data_ptr(), b, n,
                                         num_heads, d, code, d ** -0.5, stream)
    if err:
        raise RuntimeError(f"slab_attention kernel launch failed with CUDA "
                           f"error {err} (B={b}, N={n}, H={num_heads}, D={d}, "
                           f"{qkv.dtype})")
    launches += 1
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
    _check_kernel_args("slab_attention_backward", qkv, num_heads)
    b, n, c3 = qkv.shape
    c = c3 // 3
    if g.device != qkv.device or g.dtype != qkv.dtype or g.shape != (b, n, c):
        raise ValueError(f"slab_attention_backward: g must be ({b}, {n}, {c}) "
                         f"{qkv.dtype} on {qkv.device}, got {tuple(g.shape)} "
                         f"{g.dtype} on {g.device}")
    g = g.contiguous()
    _check_pairs("slab_attention_backward", g)
    d = c // num_heads
    code = _DTYPE_CODES[qkv.dtype]
    lib = load_library()
    with torch.cuda.device(qkv.device):
        _check_smem("slab_attention_backward", lib,
                    lib.tic_slab_attention_bwd_smem_bytes(n, d, code), qkv,
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
