"""Slab attention: multi-head self-attention on the fused (B, N, 3C) QKV slab.

Counterpart of ``touhouimageclassification_tpu/ops/attention.py``'s slab form
(``packed_attention_slab``). The slab holds q | k | v along the last dim, head
h at columns h*D ... (h+1)*D of each third; the result is (B, N, C) with the
heads concatenated.

- :func:`slab_attention_reference` is the plain PyTorch version: the CPU path,
  the ``'xla'`` attention of the model and the oracle the kernel is held to.
- :func:`slab_attention` is the wrapper of the CUDA kernel
  ``csrc/slab_attention_fwd.cu``. It takes the plain version only for a tensor
  on the CPU; a CUDA tensor launches the kernel or raises.

``launches`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""
from __future__ import annotations

import torch

from ._build import load_library

launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def slab_attention_reference(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain attention on the slab: S = Q K^T D^-1/2 in f32, f32 softmax, P
    cast to the input dtype before PV (as ``_packed_fwd_kernel_body`` does)."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    q, k, v = qkv.reshape(b, n, 3, num_heads, d).unbind(2)     # (B, N, H, D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, n, c)


def _check_kernel_args(qkv: torch.Tensor, num_heads: int) -> None:
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"slab_attention kernel takes float32 or bfloat16, "
                        f"got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"slab_attention expects (B, N, 3C), got "
                         f"{tuple(qkv.shape)}")
    c = qkv.shape[-1] // 3
    if c % num_heads or c // num_heads not in _HEAD_DIMS:
        raise ValueError(f"slab_attention kernel takes head dims {_HEAD_DIMS}; "
                         f"C={c} with {num_heads} heads gives "
                         f"{c / num_heads:g}")
    if not qkv.is_contiguous():
        raise ValueError("slab_attention kernel needs a contiguous slab")
    if qkv.data_ptr() % (2 * qkv.element_size()):
        raise ValueError("slab_attention kernel reads element pairs: the slab "
                         "must start on a pair boundary")
    if qkv.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "slab_attention has no backward kernel yet (K2, ROADMAP.md "
            "queue 2); call it under torch.no_grad() or torch.inference_mode()")


def slab_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Fused attention on a (B, N, 3C) slab -> (B, N, C).

    CPU tensors take :func:`slab_attention_reference`. CUDA tensors launch
    the kernel on the current stream, without synchronising."""
    global launches
    if qkv.device.type == "cpu":
        return slab_attention_reference(qkv, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"slab_attention runs on cpu or cuda, got {qkv.device}")
    _check_kernel_args(qkv, num_heads)
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    code = _DTYPE_CODES[qkv.dtype]
    lib = load_library()
    with torch.cuda.device(qkv.device):
        need = lib.tic_slab_attention_fwd_smem_bytes(n, d, code)
        limit = lib.tic_max_smem_optin(qkv.device.index)
        if need > limit:
            raise ValueError(f"slab_attention kernel keeps K and V of all {n} "
                             f"keys in shared memory: {need} bytes needed, "
                             f"{limit} available")
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
