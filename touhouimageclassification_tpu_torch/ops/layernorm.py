"""LayerNorm over the last dimension as one pair of CUDA kernels (N1).

The JAX model's LayerNorm is flax's ``LayerNorm(dtype=compute,
param_dtype=float32)``: f32 statistics, scale and bias over an input in the
compute dtype, the output rounded once to the compute dtype. XLA fuses it
with its casts, so it had no Pallas kernel. In the port it is one
``torch.autograd.Function`` over ``csrc/layernorm.cu``, which reads the
input in its own dtype, keeps the statistics and the affine in f32
registers and rounds each output once: no f32 copy of the activation or of
its gradient is written.

- :func:`layer_norm_reference` is the plain version,
  ``F.layer_norm(x.float(), ...).to(out_dtype)``, and autograd through it:
  the CPU path and the oracle the kernels are held to.
- :func:`layer_norm` takes the plain version only for tensors on the CPU;
  a CUDA tensor launches the kernels or raises. x is bf16 or f32, the
  output bf16 or f32 (``out_dtype``, default x's: V-MoE's router takes an
  f32 output of a bf16 input), the scale and bias f32 of shape (width,),
  width at most :data:`MAX_WIDTH`.
- The forward (:func:`layer_norm_forward`) writes y and each row's mean
  and rstd; the autograd function saves x itself with them, and its
  backward (:func:`layer_norm_backward`) writes dx in x's dtype and the
  scale's and bias's f32 gradients, their sums over rows taken in a fixed
  order (the same bits every call).

``launches`` counts forward launches and ``bwd_launches`` backward calls
(two kernels each: dx with per-block sums, then their sum).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import load_library

launches = 0
bwd_launches = 0
# every launch counter of this module, which a replayed CUDA graph credits
# (``train/step_graph.py``)
LAUNCH_COUNTERS = ("launches", "bwd_launches")

MAX_WIDTH = 4096
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float,
                         out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain LayerNorm: f32 statistics, scale and bias over x widened to
    f32, the output rounded to ``out_dtype`` (default x's)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    return F.layer_norm(x.float(), (x.shape[-1],), weight, bias,
                        eps).to(out_dtype)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           out_dtype: torch.dtype) -> None:
    """What the kernels take: x and the output bf16 or f32 on a CUDA
    device, an f32 scale and bias of x's width on the same device."""
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm runs on cpu or cuda, got {x.device}")
    for name, dtype in (("input", x.dtype), ("output", out_dtype)):
        if dtype not in _DTYPE_CODES:
            raise TypeError(f"layer_norm kernel takes a float32 or bfloat16 "
                            f"{name}, got {dtype}")
    width = x.shape[-1] if x.dim() else 0
    if not 0 < width <= MAX_WIDTH:
        raise ValueError(f"layer_norm kernel takes widths 1 to {MAX_WIDTH}, "
                         f"got {tuple(x.shape)}")
    for name, p in (("weight", weight), ("bias", bias)):
        if p is None or p.shape != (width,) or p.dtype != torch.float32 \
                or p.device != x.device:
            raise ValueError(
                f"layer_norm kernel takes a float32 {name} of shape "
                f"({width},) on {x.device}, got "
                + ("None" if p is None else
                   f"{p.dtype} {tuple(p.shape)} on {p.device}"))


def layer_norm_forward(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, eps: float,
                       out_dtype: torch.dtype):
    """``(y, mean, rstd)``: y of x's shape in ``out_dtype`` and each row's
    f32 mean and rstd, from one launch on the current stream, without
    synchronising."""
    global launches
    _check(x, weight, bias, out_dtype)
    x, weight, bias = (t.contiguous() for t in (x, weight, bias))
    width = x.shape[-1]
    rows = x.numel() // width
    with torch.cuda.device(x.device):
        y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
        mean, rstd = torch.empty((2, rows), dtype=torch.float32,
                                 device=x.device).unbind(0)
        if not rows:
            return y, mean, rstd
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = load_library().tic_layernorm_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), rows, width, eps,
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype], stream)
    if err:
        raise RuntimeError(f"layer_norm forward launch failed with CUDA error "
                           f"{err} ({rows} rows of {width}, {x.dtype} -> "
                           f"{out_dtype})")
    launches += 1
    return y, mean, rstd


def layer_norm_backward(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
                        rstd: torch.Tensor, weight: torch.Tensor):
    """``(dx, dweight, dbias)`` of the LayerNorm of x at the forward's mean
    and rstd: dx in x's dtype, the f32 sums over rows in a fixed order. Two
    launches on the current stream, without synchronising."""
    global bwd_launches
    x, dy, weight = x.contiguous(), dy.contiguous(), weight.contiguous()
    if dy.shape != x.shape or dy.dtype not in _DTYPE_CODES:
        raise ValueError(f"layer_norm backward takes a float32 or bfloat16 "
                         f"gradient of x's shape {tuple(x.shape)}, got "
                         f"{dy.dtype} {tuple(dy.shape)}")
    width = x.shape[-1]
    rows = x.numel() // width
    codes = _DTYPE_CODES[x.dtype], _DTYPE_CODES[dy.dtype]
    lib = load_library()
    with torch.cuda.device(x.device):
        dx = torch.empty_like(x)
        dparams = torch.empty((2, width), dtype=torch.float32, device=x.device)
        if not rows:
            return dx, *dparams.zero_().unbind(0)
        blocks = lib.tic_layernorm_bwd_blocks(
            x.data_ptr(), dy.data_ptr(), weight.data_ptr(), dx.data_ptr(),
            rows, width, *codes)
        if blocks <= 0:
            raise RuntimeError(f"layer_norm backward: no grid for {rows} rows "
                               f"of {width} (CUDA error {-blocks})")
        partial = torch.empty((blocks, 2, width), dtype=torch.float32,
                              device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        dweight, dbias = dparams.unbind(0)
        err = lib.tic_layernorm_bwd(
            x.data_ptr(), dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            weight.data_ptr(), dx.data_ptr(), partial.data_ptr(), blocks,
            dweight.data_ptr(), dbias.data_ptr(), rows, width, *codes, stream)
    if err:
        raise RuntimeError(f"layer_norm backward launch failed with CUDA "
                           f"error {err} ({rows} rows of {width}, x "
                           f"{x.dtype}, dy {dy.dtype})")
    bwd_launches += 1
    return dx, dweight, dbias


class _LayerNorm(torch.autograd.Function):
    """The kernel pair: x, mean and rstd saved, no f32 copy of x."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, out_dtype: torch.dtype):
        y, mean, rstd = layer_norm_forward(x, weight, bias, eps, out_dtype)
        ctx.save_for_backward(x, weight, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, weight, mean, rstd = ctx.saved_tensors
        return (*layer_norm_backward(x, dy, mean, rstd, weight), None, None)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, out_dtype: torch.dtype | None = None
               ) -> torch.Tensor:
    """LayerNorm of x over its last dimension with an f32 scale and bias, in
    f32, rounded once to ``out_dtype`` (default x's)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps, out_dtype)
    return _LayerNorm.apply(x, weight, bias, eps, out_dtype)
