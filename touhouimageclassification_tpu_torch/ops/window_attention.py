"""Window attention of SwinV2 (``models/swin.py``): scaled cosine attention
among the tokens of each window, with an additive bias shared by every
image of the batch.

    A = softmax(cos(q, k) exp(min(tau_h, ln 100)) + bias),   out = A v

The input is the window rows' fused projection, a (B nW, N, 3C) slab (q |
k | v along the last dim, head h at columns h D ... (h + 1) D of each
third), the nW windows of an image consecutive, so that window index ``w``
is row ``r % nW``; the output is (B nW, N, C). ``tau`` is the learnt
per-head log-scale, (H, 1, 1). ``bias`` is (1, H, N, N), one per-head bias
for every window, or (nW, H, N, N), a bias per window index: the per-head
bias plus that window's shift mask (``models/swin.py`` builds both in its
span ``swin.bias``). Neither is ever expanded to the batch in memory.

On CUDA the op is W1, one hand-written kernel pair (``csrc/window_
attention.cu``): the forward reads the slab and the bias in place,
multiplies the raw bf16 q and k, applies the f32 inverse norms and the
head's scale to the f32 scores and saves the inverse norms and each
query's log-sum-exp; the backward writes the slab's gradient (the
normalisation's backward in its epilogues), the bias's gradient summed
over the images inside the kernel, and tau's, each in a fixed order (the
same bits every call). It takes a bf16 slab and bias, an f32 tau, D 16 or
32 and N up to :data:`MAX_TOKENS`; anything else raises.

On the CPU the op is plain torch: q and k normalised, q times its head's
clamped scale, in the slab's own order (:class:`_ScaledCosineQKV`, whose
backward writes the slab's gradient), then an explicit f32 softmax.
:func:`window_attention_reference` is the plain form step by step, the
oracle both are held to.

``launches`` and ``bwd_launches`` count W1's forward and backward calls; a
replayed CUDA graph credits them (``train/step_graph.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ._build import load_library

LOGIT_SCALE_MAX = math.log(100.0)
# F.normalize's: a row's norm is taken as at least this
NORM_EPS = 1e-12
# W1's shapes (``csrc/window_attention.cu``: kMaxTokens)
MAX_TOKENS = 576
HEAD_DIMS = (16, 32)

launches = 0
bwd_launches = 0
# every launch counter of this module, which a replayed CUDA graph credits
# (``train/step_graph.py``)
LAUNCH_COUNTERS = ("launches", "bwd_launches")


class _ScaledCosineQKV(torch.autograd.Function):
    """(B nW, N, 3C) slab -> (q / |q| s, k / |k|, v) as (B nW, H, N, D)
    views, with s = exp(min(tau, ln 100)) per head: q and k of one new
    (B nW, N, 2, H, D) tensor in the slab's own order, each rounded once
    from float32, and v of the slab. A row's squared norm is a product with
    a vector of ones (float32 sums of the squares in the slab's dtype).

    Backward, with m = s / |x| for q (1 / |x| for k): dx = m (dy - x <x,
    dy> / |x|²), q's and k's written with dv into one gradient in the
    slab's layout, and dtau = s <q / |q|, dq> summed per head where tau <=
    ln 100."""

    @staticmethod
    def forward(ctx, qkv, logit_scale, heads):
        rows, n, _ = qkv.shape
        x = qkv.view(rows, n, 3, heads, -1)
        qk = x[:, :, :2]
        inv = _row_sums(qk.square()).clamp_min(NORM_EPS ** 2).rsqrt()
        scale = logit_scale.clamp(max=LOGIT_SCALE_MAX).exp().view(
            1, 1, 1, heads, 1)
        mult = inv * torch.cat((scale, torch.ones_like(scale)), 2)
        y = torch.mul(qk, mult, out=torch.empty(qk.shape, dtype=qkv.dtype,
                                                device=qkv.device))
        ctx.save_for_backward(qkv, logit_scale, inv, mult)
        ctx.heads = heads
        return (y[:, :, 0].transpose(1, 2), y[:, :, 1].transpose(1, 2),
                x[:, :, 2].transpose(1, 2))

    @staticmethod
    def backward(ctx, dq, dk, dv):
        qkv, logit_scale, inv, mult = ctx.saved_tensors
        rows, n, _ = qkv.shape
        x = qkv.view(rows, n, 3, ctx.heads, -1)
        dx = torch.empty_like(x)
        for j, dy in enumerate((dq.transpose(1, 2), dk.transpose(1, 2))):
            xj, inv_j = x[:, :, j], inv[:, :, j]
            dot = _row_sums(xj * dy)
            if j == 0:
                dscale = (dot * inv_j).sum((0, 1))
            torch.mul(torch.addcmul(dy, xj, (inv_j * inv_j * dot).to(
                dy.dtype), value=-1.0), mult[:, :, j], out=dx[:, :, j])
        dx[:, :, 2].copy_(dv.transpose(1, 2))
        scale = logit_scale.clamp(max=LOGIT_SCALE_MAX).exp()
        dtau = dscale.view_as(scale) * scale * (logit_scale <= LOGIT_SCALE_MAX)
        return dx.view_as(qkv), dtau, None


def _row_sums(x: torch.Tensor) -> torch.Tensor:
    """The sums over x's last dimension, keeping it as 1, in float32 (or
    float64 for a float64 x), as a product with a vector of ones."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return torch.matmul(x, x.new_ones(x.shape[-1], 1)).to(acc)


def window_attention_reference(qkv: torch.Tensor, logit_scale: torch.Tensor,
                               bias: torch.Tensor) -> torch.Tensor:
    """The plain form, step by step: ``F.normalize``, the scores, the bias,
    an f32 softmax, the product with v."""
    rows, n, c3 = qkv.shape
    heads = logit_scale.shape[0]
    q, k, v = qkv.view(rows, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    scale = logit_scale.clamp(max=LOGIT_SCALE_MAX).exp()
    s = (F.normalize(q, dim=-1) @ F.normalize(k, dim=-1).transpose(-1, -2)
         * scale)
    s = s.view(-1, bias.shape[0], heads, n, n) + bias
    p = torch.softmax(s.float(), dim=-1).to(v.dtype).view(rows, heads, n, n)
    return (p @ v).transpose(1, 2).reshape(rows, n, c3 // 3)


def _check(qkv: torch.Tensor, logit_scale: torch.Tensor,
           bias: torch.Tensor, heads: int, d: int) -> None:
    """What W1 takes: a contiguous bf16 slab and bias on one CUDA device, an
    f32 tau on it, D 16 or 32 and N up to :data:`MAX_TOKENS`."""
    n = qkv.shape[1]
    if qkv.dtype != torch.bfloat16 or bias.dtype != torch.bfloat16 \
            or logit_scale.dtype != torch.float32:
        raise ValueError(f"window attention on CUDA takes a bfloat16 slab and "
                         f"bias and a float32 tau, got {qkv.dtype}, "
                         f"{bias.dtype} and {logit_scale.dtype}")
    if d not in HEAD_DIMS or not 0 < n <= MAX_TOKENS:
        raise ValueError(f"window attention on CUDA takes heads of "
                         f"{HEAD_DIMS} and up to {MAX_TOKENS} tokens, got "
                         f"D {d} and N {n}")
    if bias.device != qkv.device or logit_scale.device != qkv.device:
        raise ValueError(f"window attention's operands lie on {qkv.device}, "
                         f"{bias.device} and {logit_scale.device}")


def window_attention_forward(qkv: torch.Tensor, logit_scale: torch.Tensor,
                             bias: torch.Tensor):
    """``(out, lse, inv)``: W1's (B nW, N, C) output, each query's f32
    log-sum-exp (log2 domain), (B nW, H, N), and the f32 inverse norms of q
    and k, (B nW, 2, H, N), launched on the current stream without
    synchronising."""
    global launches
    rows, n, c3 = qkv.shape
    heads, windows = logit_scale.shape[0], bias.shape[0]
    qkv, logit_scale, bias = (t.contiguous() for t in (qkv, logit_scale,
                                                       bias))
    with torch.cuda.device(qkv.device):
        out = torch.empty(rows, n, c3 // 3, dtype=qkv.dtype, device=qkv.device)
        lse = torch.empty(rows, heads, n, dtype=torch.float32,
                          device=qkv.device)
        inv = torch.empty(rows, 2, heads, n, dtype=torch.float32,
                          device=qkv.device)
        err = load_library().tic_window_attention_fwd(
            qkv.data_ptr(), logit_scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), lse.data_ptr(), inv.data_ptr(), rows, n, heads,
            c3 // 3 // heads, windows,
            torch.cuda.current_stream(qkv.device).cuda_stream)
    if err:
        raise RuntimeError(f"window attention forward launch failed with "
                           f"CUDA error {err} (slab {tuple(qkv.shape)}, bias "
                           f"{tuple(bias.shape)})")
    launches += 1
    return out, lse, inv


def window_attention_backward(qkv: torch.Tensor, logit_scale: torch.Tensor,
                              bias: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, inv: torch.Tensor,
                              dout: torch.Tensor):
    """``(dqkv, dtau, dbias)`` of W1 at the forward's ``(out, lse, inv)``:
    the slab's and the bias's bf16 gradients and tau's f32 one, each summed
    in a fixed order. Launches on the current stream, without
    synchronising."""
    global bwd_launches
    rows, n, c3 = qkv.shape
    heads, windows = logit_scale.shape[0], bias.shape[0]
    d = c3 // 3 // heads
    qkv, logit_scale, bias, dout = (t.contiguous() for t in (
        qkv, logit_scale, bias, dout.to(qkv.dtype)))
    lib = load_library()
    dev = qkv.device
    with torch.cuda.device(dev):
        groups = lib.tic_window_attention_groups(rows, n, heads, d, windows)
        if groups <= 0:
            raise RuntimeError(f"window attention backward: no grid for slab "
                               f"{tuple(qkv.shape)} (CUDA error {-groups})")
        tiles = -(-n // 64)
        f32 = dict(dtype=torch.float32, device=dev)
        dqkv = torch.empty_like(qkv)
        dtau = torch.empty_like(logit_scale)
        dbias = torch.empty_like(bias)
        dsum = torch.empty(rows, heads, n, **f32)
        bias_part = torch.empty(groups, *bias.shape, **f32)
        tau_part = torch.empty(heads, windows, groups, tiles * tiles, **f32)
        err = lib.tic_window_attention_bwd(
            qkv.data_ptr(), logit_scale.data_ptr(), bias.data_ptr(),
            inv.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            dsum.data_ptr(), dqkv.data_ptr(), dbias.data_ptr(),
            dtau.data_ptr(), bias_part.data_ptr(), tau_part.data_ptr(), groups,
            rows, n, heads, d, windows,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"window attention backward launch failed with "
                           f"CUDA error {err} (slab {tuple(qkv.shape)}, bias "
                           f"{tuple(bias.shape)})")
    bwd_launches += 1
    return dqkv, dtau, dbias


class _WindowAttention(torch.autograd.Function):
    """W1: the slab, tau, the bias and the forward's output, log-sum-exp
    and inverse norms saved."""

    @staticmethod
    def forward(ctx, qkv, logit_scale, bias):
        saved = window_attention_forward(qkv, logit_scale, bias)
        ctx.save_for_backward(qkv, logit_scale, bias, *saved)
        return saved[0]

    @staticmethod
    def backward(ctx, dout):
        return window_attention_backward(*ctx.saved_tensors, dout)


def window_attention(qkv: torch.Tensor, logit_scale: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """(B nW, N, 3C) ``qkv``, (H, 1, 1) ``logit_scale``, (1 or nW, H, N, N)
    ``bias`` -> (B nW, N, C) in qkv's dtype (module docstring)."""
    rows, n, c3 = qkv.shape
    heads, windows = logit_scale.shape[0], bias.shape[0]
    c = c3 // 3
    d = c // heads
    if (rows % windows or c3 != 3 * heads * d
            or bias.shape[1:] != (heads, n, n)):
        raise ValueError(f"a bias of {tuple(bias.shape)} and {heads} heads "
                         f"do not fit windows of {tuple(qkv.shape)}")
    if qkv.device.type != "cpu":
        _check(qkv, logit_scale, bias, heads, d)
        return _WindowAttention.apply(qkv, logit_scale, bias)
    q, k, v = _ScaledCosineQKV.apply(qkv, logit_scale, heads)
    s = (q @ k.transpose(-1, -2)).view(-1, windows, heads, n, n) + bias
    p = torch.softmax(s.float(), dim=-1).to(v.dtype)
    out = p.view(rows, heads, n, n) @ v
    return out.transpose(1, 2).reshape(rows, n, c)
