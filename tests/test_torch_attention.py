"""Attention of the PyTorch port against the JAX package's: the slab form
(K1, K2), the three-operand form ``packed_attention`` (K3) and the
(B, N, H, D) form ``flash_attention`` (K4).

The same numpy inputs go through the JAX ops (their Pallas kernels
interpreted on the CPU, forward and VJP), the JAX plain versions
(``packed_reference_attention``, ``_reference_attention``, and ``jax.grad``
through them) and the port's ops, which take their plain versions on the
CPU. f32 unless stated, so the bounds cover summation order only. The CUDA
kernels themselves run only on a GPU (``cuda`` marker).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touhouimageclassification_tpu.ops.attention import (
    _reference_attention,
    flash_attention,
    packed_attention,
    packed_attention_slab,
    packed_reference_attention,
)
from touhouimageclassification_tpu_torch.ops import attention as port

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-5


def _slab(b, n, c, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, n, 3 * c)).astype(np.float32)


def _jax_reference(x, heads):
    c = x.shape[-1] // 3
    q, k, v = (jnp.asarray(x[..., i * c:(i + 1) * c]) for i in range(3))
    return np.asarray(packed_reference_attention(q, k, v, heads))


@pytest.mark.parametrize("heads,d", [(4, 64), (3, 16), (5, 16), (6, 16),
                                     (12, 16)])
def test_reference_matches_jax_slab_kernel(heads, d):
    x = _slab(2, 67, heads * d, seed=heads)
    ours = port.slab_attention_reference(torch.from_numpy(x), heads).numpy()
    np.testing.assert_allclose(
        ours, np.asarray(packed_attention_slab(jnp.asarray(x), heads)),
        atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ours, _jax_reference(x, heads),
                               atol=ATOL, rtol=RTOL)


def test_cpu_tensor_takes_plain_version():
    x = torch.from_numpy(_slab(2, 17, 64, seed=1))
    before = port.launches
    out = port.slab_attention(x, 4)
    assert port.launches == before
    torch.testing.assert_close(out, port.slab_attention_reference(x, 4),
                               atol=0, rtol=0)


def test_bf16_reference_casts_probabilities_before_pv():
    """bf16 in, bf16 out, and within the JAX bf16 attention bound of f32."""
    x = _slab(2, 67, 4 * 16, seed=2)
    got = port.slab_attention_reference(
        torch.from_numpy(x).to(torch.bfloat16), 4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _jax_reference(x, 4),
                               atol=2e-2, rtol=2e-2)


def _jax_slab_vjp(x, g, heads):
    _, vjp = jax.vjp(lambda s: packed_attention_slab(s, heads), jnp.asarray(x))
    return np.asarray(vjp(jnp.asarray(g))[0])


def _jax_reference_grad(x, g, heads):
    c = x.shape[-1] // 3

    def loss(s):
        out = packed_reference_attention(s[..., :c], s[..., c:2 * c],
                                         s[..., 2 * c:], heads)
        return jnp.sum(out * g)

    return np.asarray(jax.grad(loss)(jnp.asarray(x)))


# the shapes of test_attention.py's slab gradient tests: 4 heads, and 12
# heads (the TPU kernel's 8 + 4 head-group split), at ragged N 67
@pytest.mark.parametrize("b,heads,d", [(2, 4, 16), (1, 12, 16), (2, 5, 32),
                                       (1, 2, 64)])
def test_backward_reference_matches_jax_vjp(b, heads, d):
    """f32 gradients within 1e-4 of the Pallas K2 (interpreted) and of
    jax.grad through the XLA reference: summation order only."""
    x = _slab(b, 67, heads * d, seed=10 + heads)
    g = np.random.default_rng(heads).standard_normal(
        (b, 67, heads * d)).astype(np.float32)
    ours = port.slab_attention_backward_reference(
        torch.from_numpy(x), torch.from_numpy(g), heads).numpy()
    assert ours.shape == x.shape
    np.testing.assert_allclose(ours, _jax_slab_vjp(x, g, heads),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ours, _jax_reference_grad(x, g, heads),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_returns_reference_gradient(dtype):
    """On the CPU the 'fused' attention's autograd function runs the plain
    backward: its gradient is the reference's, bit for bit, and no kernel
    launch is counted."""
    x = torch.from_numpy(_slab(2, 17, 4 * 16, seed=4)).to(dtype)
    g = torch.from_numpy(_slab(2, 17, 4 * 16, seed=5)[..., :64]).to(dtype)
    before = (port.launches, port.bwd_launches)
    leaf = x.clone().requires_grad_()
    out = port.slab_attention(leaf, 4)
    out.backward(g)
    assert (port.launches, port.bwd_launches) == before
    torch.testing.assert_close(out, port.slab_attention_reference(x, 4),
                               atol=0, rtol=0)
    torch.testing.assert_close(
        leaf.grad, port.slab_attention_backward_reference(x, g, 4),
        atol=0, rtol=0)


def test_autograd_of_reference_agrees_in_f32():
    """In f32 the plain backward is the gradient of the plain forward."""
    x = torch.from_numpy(_slab(2, 33, 3 * 32, seed=6)).requires_grad_()
    g = torch.from_numpy(_slab(2, 33, 32, seed=7)[..., :96])
    port.slab_attention_reference(x, 3).backward(g)
    torch.testing.assert_close(
        x.grad, port.slab_attention_backward_reference(x.detach(), g, 3),
        atol=1e-5, rtol=1e-5)


def test_bf16_backward_within_jax_bf16_rounding():
    """bf16 in, bf16 out; the port's bf16 gradient differs from the JAX
    kernel's bf16 gradient by no more than that differs from its own f32
    gradient (both round P, dS and the output to bf16)."""
    x = _slab(2, 67, 4 * 16, seed=8)
    g = np.random.default_rng(8).standard_normal((2, 67, 64)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda s: packed_attention_slab(s, 4), xb)
    want = np.asarray(vjp(gb)[0].astype(jnp.float32))
    want32 = _jax_slab_vjp(np.asarray(xb.astype(jnp.float32)),
                           np.asarray(gb.astype(jnp.float32)), 4)
    got = port.slab_attention_backward_reference(
        torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(g).to(torch.bfloat16), 4)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= np.abs(
        want - want32).max()


def test_backward_wrapper_cpu_takes_plain_version():
    x = torch.from_numpy(_slab(1, 9, 64, seed=9))
    g = torch.from_numpy(_slab(1, 9, 64, seed=10)[..., :64])
    before = port.bwd_launches
    out = port.slab_attention_backward(x, g, 4)
    assert port.bwd_launches == before
    torch.testing.assert_close(
        out, port.slab_attention_backward_reference(x, g, 4), atol=0, rtol=0)


# --- K3: packed_attention, three (B, N, C) operands --------------------------

def _three(shape, seed, count=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(count)]


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_packed_forward_matches_jax_kernel(dtype, tol):
    """test_attention.py:78 and :88: the port's packed_attention against
    the JAX Pallas kernel and the JAX plain version, f32 and bf16 (the JAX
    tests' bounds)."""
    xs = _three((2, 67, 64), seed=20)
    jx = [jnp.asarray(x).astype(dtype) for x in xs]
    got = port.packed_attention(
        *(torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs), 4)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    for want in (packed_attention(*jx, 4), packed_reference_attention(*jx, 4)):
        np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                                   atol=tol, rtol=tol)


# test_attention.py:98 (2 heads) and :114 (12 heads: the TPU kernel's
# 8 + 4 head-group split)
@pytest.mark.parametrize("c,heads", [(64, 2), (12 * 16, 12)])
def test_packed_gradients_match_jax_kernel(c, heads):
    """Gradients of sum(out * w), w a non-symmetric cotangent, through the
    port's autograd function and through the JAX Pallas VJP: three (B, N, C)
    gradients, f32."""
    q, k, v, w = _three((1, 67, c), seed=21 + heads, count=4)

    def loss(q, k, v):
        return jnp.sum(packed_attention(q, k, v, heads) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    before = (port.packed_launches, port.packed_bwd_launches)
    (port.packed_attention(*leaves, heads) * torch.from_numpy(w)).sum().backward()
    assert (port.packed_launches, port.packed_bwd_launches) == before
    for leaf, g in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   atol=1e-4, rtol=1e-4)


def test_packed_backward_reference_is_the_slab_backward():
    """The three-operand plain backward is the slab's on the concatenated
    operands, split in three: one set of arithmetic for K2 and K3."""
    q, k, v, g = (torch.from_numpy(x) for x in _three((2, 33, 96), 22, 4))
    got = port.packed_attention_backward_reference(q, k, v, g, 3)
    want = port.slab_attention_backward_reference(torch.cat([q, k, v], -1), g,
                                                  3)
    torch.testing.assert_close(torch.cat(got, -1), want, atol=0, rtol=0)
    torch.testing.assert_close(
        port.packed_attention_reference(q, k, v, 3),
        port.slab_attention_reference(torch.cat([q, k, v], -1), 3),
        atol=0, rtol=0)


def test_packed_bf16_backward_within_jax_bf16_rounding():
    """bf16 gradients: the port's differ from the JAX kernel's bf16
    gradients by no more than those differ from its own f32 gradients."""
    q, k, v, g = _three((2, 67, 64), seed=23, count=4)
    jb = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda *a: packed_attention(*a, 4), *jb)
    want = [np.asarray(x.astype(jnp.float32)) for x in vjp(gb)]
    _, vjp32 = jax.vjp(lambda *a: packed_attention(*a, 4),
                       *(x.astype(jnp.float32) for x in jb))
    want32 = [np.asarray(x) for x in vjp32(gb.astype(jnp.float32))]
    got = port.packed_attention_backward(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, g)), 4)
    for ours, w, w32 in zip(got, want, want32):
        assert ours.dtype == torch.bfloat16
        assert np.abs(ours.float().numpy() - w).max() <= np.abs(w - w32).max()


# --- K4: flash_attention, (B, N, H, D) ---------------------------------------

def _bnhd(b=2, n=67, h=4, d=16, seed=30):
    return _three((b, n, h, d), seed)


@pytest.mark.parametrize("n,dtype,tol", [
    (67, "float32", 2e-5),     # test_attention.py:20
    (67, "bfloat16", 2e-2),    # :27
    (130, "float32", 2e-5),    # :34, the TPU kernel pads N to 256
])
def test_flash_forward_matches_jax_kernel(n, dtype, tol):
    """The port's flash_attention against the JAX flash_attention (its own
    Pallas kernel, interpreted, with N padded and the padded keys masked)
    and the JAX plain version: the port's result at the logical N needs no
    padding, so the masked keys must have dropped out of JAX's."""
    xs = _bnhd(n=n)
    jx = [jnp.asarray(x).astype(dtype) for x in xs]
    got = port.flash_attention(
        *(torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs))
    assert got.shape == (2, n, 4, 16)
    for want in (flash_attention(*jx), _reference_attention(*jx)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=tol, rtol=tol)


def test_flash_gradients_match_jax():
    """test_attention.py:43: gradients of sum(out^2) through the port's
    flash_attention against jax.grad through JAX's (forward kernel, plain
    recomputed backward), f32."""
    q, k, v = _bnhd(b=1, n=64, h=2, d=32, seed=31)
    want = jax.grad(lambda *a: jnp.sum(flash_attention(*a) ** 2),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (port.flash_attention(*leaves) ** 2).sum().backward()
    for leaf, g in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   atol=1e-4, rtol=1e-4)


def test_flash_bf16_backward_recomputes_bf16_scores():
    """JAX's flash_attention VJP differentiates ``_reference_attention``,
    which forms S in the input dtype (bf16 in training) before the f32
    softmax. The port's backward differentiates its cast-for-cast copy,
    ``reference_attention``: its bf16 gradients are that function's, bit
    for bit, and lie within JAX's own bf16-vs-f32 deviation of JAX's bf16
    gradients."""
    q, k, v, w = _three((2, 67, 4, 16), seed=32, count=4)
    jb = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]

    def jgrad(dtype):
        return [np.asarray(x.astype(jnp.float32)) for x in jax.grad(
            lambda *a: jnp.sum(flash_attention(*a).astype(jnp.float32) * w),
            argnums=(0, 1, 2))(*(x.astype(dtype) for x in jb))]

    want, want32 = jgrad(jnp.bfloat16), jgrad(jnp.float32)
    wt = torch.from_numpy(w)

    def tgrad(fn):
        leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
                  for x in (q, k, v)]
        (fn(*leaves).float() * wt).sum().backward()
        return [x.grad for x in leaves]

    got = tgrad(port.flash_attention)
    for ours, recomputed in zip(got, tgrad(port.reference_attention)):
        torch.testing.assert_close(ours, recomputed, atol=0, rtol=0)
    for ours, w_, w32 in zip(got, want, want32):
        assert ours.dtype == torch.bfloat16
        assert np.abs(ours.float().numpy() - w_).max() <= np.abs(w_ - w32).max()


def test_flash_takes_the_models_slab_views():
    """The model hands flash_attention the q, k, v views of its (B, N, 3C)
    QKV projection (row stride 3C): the result is the slab attention's."""
    slab = torch.from_numpy(_slab(2, 17, 64, seed=33))
    q, k, v = slab.view(2, 17, 3, 4, 16).unbind(2)
    assert q.stride() == (17 * 192, 192, 16, 1)
    before = port.flash_launches
    got = port.flash_attention(q, k, v).reshape(2, 17, 64)
    assert port.flash_launches == before
    torch.testing.assert_close(got, port.slab_attention_reference(slab, 4),
                               atol=0, rtol=0)


# --- the two device routes ----------------------------------------------------

H100_SMEM_OPTIN = 232448  # bytes one block may opt in to on an H100
# the bf16 shape sweep of chip_smoke.py: (B 1, two heads) at every N and D
SWEEP = [(n, d) for d in (32, 64, 128)
         for n in (1, 16, 67, 197, 256, 257, 577)]


@pytest.mark.parametrize("dtype,d,backward,route", [
    (torch.bfloat16, 32, False, "mma"), (torch.bfloat16, 64, False, "wgmma"),
    (torch.bfloat16, 128, False, "mma"), (torch.float32, 32, False, "simt"),
    (torch.float32, 64, False, "simt"), (torch.float32, 128, False, "simt"),
    (torch.bfloat16, 32, True, "mma"), (torch.bfloat16, 64, True, "wgmma"),
    (torch.bfloat16, 128, True, "mma"), (torch.float32, 64, True, "simt"),
])
def test_kernel_route_by_dtype(dtype, d, backward, route):
    """At the models' N 197: bf16 at head dim 64 takes the Hopper wgmma
    route in both directions; every other bf16 launch (head dims 32 and
    128) the mma.sync route; f32 the SIMT route, at every head dim the
    kernels take."""
    assert port.kernel_route(dtype, d, 197, backward) == route


def test_wgmma_route_takes_every_n_up_to_256():
    """bf16 at head dim 64 runs on wgmma for every N from one token to 256
    (the scores of a 64-row block stay in registers), forward and backward;
    N 257 and past go to mma in both directions."""
    for n in range(1, 257):
        assert port.kernel_route(torch.bfloat16, 64, n) == "wgmma", n
        assert port.kernel_route(torch.bfloat16, 64, n,
                                 backward=True) == "wgmma", n
    for n in (257, 577, 1025):
        assert port.kernel_route(torch.bfloat16, 64, n) == "mma", n
        assert port.kernel_route(torch.bfloat16, 64, n, backward=True) == "mma"
    assert port.WGMMA_MAX_N == 256


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("n", [1, 197, 256, 257])
def test_other_head_dims_stay_on_mma(n, d, backward):
    assert port.kernel_route(torch.bfloat16, d, n, backward) == "mma"


@pytest.mark.parametrize("dtype,d,error", [
    (torch.float16, 64, TypeError), (torch.float64, 64, TypeError),
    (torch.bfloat16, 16, ValueError), (torch.bfloat16, 80, ValueError),
    (torch.float32, 256, ValueError),
])
def test_kernel_route_raises_outside_the_kernels(dtype, d, error):
    with pytest.raises(error):
        port.kernel_route(dtype, d, 197)


@pytest.mark.parametrize("n,d", SWEEP)
@pytest.mark.parametrize("backward", [False, True])
def test_mma_route_fits_shared_memory(n, d, backward):
    """The mma route stages its two head operands of all N rows (N rounded
    up to 16, at least 64) at a pitch of D + 8 bf16, plus three f32
    statistics a row in the backward's pass 2: every sweep shape fits an
    H100 block's 227 KB except N 577 at D 128, which the wrappers refuse."""
    rows = max(-(-n // 16) * 16, 64)
    need = port.kernel_smem_bytes("mma", backward, n, d)
    assert need == 2 * rows * (d + 8) * 2 + (12 * rows if backward else 0)
    assert (need > H100_SMEM_OPTIN) == ((n, d) == (577, 128))


def test_smem_at_vit_l_shapes():
    """N 197, D 64: the mma route needs 59,904 bytes forward and 62,400
    backward (the C functions' values on an H100); the f32 SIMT route keeps
    its D + 2 pitch and per-warp score rows."""
    assert port.kernel_smem_bytes("mma", False, 197, 64) == 59904
    assert port.kernel_smem_bytes("mma", True, 197, 64) == 62400
    assert port.kernel_smem_bytes("simt", False, 197, 64) == (
        2 * 197 * 66 * 4 + 4 * 197 * 4)
    assert port.kernel_smem_bytes("simt", True, 197, 64) == (
        2 * 197 * 66 * 4 + 3 * 197 * 4 + 8 * 197 * 4)


@pytest.mark.parametrize("n", [1, 197, 256])
def test_wgmma_route_fits_shared_memory(n):
    """The wgmma route's block holds two ring stages of four 64-row tiles of
    Q, K and V, two output stagings and four mbarriers, aligned to 1 KB:
    214,048 bytes at any N it takes (the C function's value), under an
    H100 block's opt-in."""
    need = port.kernel_smem_bytes("wgmma", False, n, 64)
    assert need == 1024 + 2 * 3 * 4 * 8192 + 2 * 8192 + 32 == 214048
    assert need <= H100_SMEM_OPTIN


def _c_smem_sum(source: str) -> int:
    """The shared-memory sum a kernel source states in its static_assert."""
    import pathlib
    import re

    text = (pathlib.Path(port.__file__).parents[1] / "csrc" / source).read_text()
    return int(re.search(r"static_assert\(kSmemBytes == (\d+),", text).group(1))


@pytest.mark.parametrize("n", [1, 64, 197, 208, 256])
def test_wgmma_backward_fits_shared_memory(n):
    """The wgmma backward's block holds one stage of four 64-row tiles each
    of Q, K, V and g, two 8 KB gradient stagings, the statistics of 256
    query rows (three f32 each), two mbarriers, aligned to 1 KB: 151,568
    bytes at any N it takes, the sum csrc/slab_attention_bwd_sm90.cu states,
    under an H100 block's opt-in (what is left cannot hold a second stage of
    128 KB)."""
    need = port.kernel_smem_bytes("wgmma", True, n, 64)
    assert need == 1024 + 16 * 8192 + 2 * 8192 + 3 * 256 * 4 + 2 * 8 == 151568
    assert need == _c_smem_sum("slab_attention_bwd_sm90.cu")
    assert need <= H100_SMEM_OPTIN < need + 4 * 4 * 8192
    assert port.kernel_smem_bytes("wgmma", False, n, 64) == _c_smem_sum(
        "slab_attention_fwd_sm90.cu")


def test_route_launches_counts_every_route():
    assert set(port.route_launches) == {"wgmma", "mma", "simt"}
    assert set(port._ALIGN) == set(port.route_launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_count_no_route(dtype):
    """The plain versions on the CPU launch nothing: no route counts."""
    x = torch.from_numpy(_slab(1, 9, 64, seed=35)).to(dtype)
    g = torch.from_numpy(_slab(1, 9, 64, seed=36)[..., :64]).to(dtype)
    before = dict(port.route_launches)
    port.slab_attention_forward(x, 4)
    port.slab_attention_backward(x, g, 4)
    port.packed_attention_forward(*x.split(64, -1), 4)
    port.flash_attention_forward(*x.view(1, 9, 3, 4, 16).unbind(2))
    assert port.route_launches == before


def test_wgmma_route_has_no_cpu_mode():
    """On the CPU the forward is the plain version whatever the route would
    be: a bf16 D 64 slab counts nothing on 'wgmma' and equals the
    reference bit for bit."""
    x = torch.from_numpy(_slab(2, 17, 128, seed=37)).to(torch.bfloat16)
    assert port.kernel_route(x.dtype, 64, 17) == "wgmma"
    before = (port.launches, dict(port.route_launches))
    out = port.slab_attention_forward(x, 2)
    assert (port.launches, port.route_launches) == before
    assert torch.equal(out, port.slab_attention_reference(x, 2))


@pytest.mark.parametrize("n", [1, 17, 197])
def test_wgmma_backward_has_no_cpu_mode(n):
    """On the CPU the backward is the plain version whatever the route would
    be: at bf16 and head dim 64 (the wgmma route) K2 and K3's backward
    count no launch and equal their references bit for bit."""
    x = torch.from_numpy(_slab(2, n, 128, seed=38)).to(torch.bfloat16)
    g = torch.from_numpy(_slab(2, n, 128, seed=39)[..., :128]).to(
        torch.bfloat16)
    assert port.kernel_route(x.dtype, 64, n, backward=True) == "wgmma"
    before = (port.bwd_launches, port.packed_bwd_launches,
              dict(port.route_launches))
    got = port.slab_attention_backward(x, g, 2)
    packed = port.packed_attention_backward(*x.split(128, -1), g, 2)
    assert (port.bwd_launches, port.packed_bwd_launches,
            port.route_launches) == before
    assert torch.equal(got, port.slab_attention_backward_reference(x, g, 2))
    for ours, want in zip(packed, port.packed_attention_backward_reference(
            *x.split(128, -1), g, 2)):
        assert torch.equal(ours, want)


def _on_route(want, launches, run):
    """run() on the card; its launches must all take the route ``want``."""
    before = dict(port.route_launches)
    out = run()
    torch.cuda.synchronize()
    assert {r: port.route_launches[r] - before[r] for r in before} == {
        r: launches if r == want else 0 for r in before}
    return out


_GPU_CASES = [
    (64, 197, 1024, 16, torch.bfloat16),
    (2, 67, 160, 5, torch.float32),
    *((1, n, 2 * d, 2, torch.bfloat16) for n, d in SWEEP),
]


def _route(n, c, heads, dtype, backward=False):
    return port.kernel_route(dtype, c // heads, n, backward)


def _fits(n, c, heads, dtype, backward):
    route = _route(n, c, heads, dtype, backward)
    return port.kernel_smem_bytes(route, backward, n, c // heads) <= (
        H100_SMEM_OPTIN)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,heads,dtype", _GPU_CASES)
def test_three_operand_kernels_match_plain_on_gpu(require_cuda, b, n, c, heads,
                                                 dtype):
    """K3 forward and backward, and K4 on the views of a QKV slab, against
    their plain versions on the card (bounds as for K1 and K2), each launch
    on its dtype's route; a shape past shared memory raises."""
    tol = (dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16
           else dict(atol=1e-4, rtol=1e-4))
    q, k, v, g = (torch.from_numpy(x).to("cuda", dtype)
                  for x in _three((b, n, c), seed=34, count=4))
    slab = torch.cat([q, k, v], -1)
    views = slab.view(b, n, 3, heads, c // heads).unbind(2)
    if not _fits(n, c, heads, dtype, backward=False):
        with pytest.raises(ValueError, match="shared memory"):
            port.flash_attention_forward(*views)
        return
    before = (port.packed_launches, port.packed_bwd_launches,
              port.flash_launches)
    fwd = _route(n, c, heads, dtype)
    out = _on_route(fwd, 1, lambda: port.packed_attention_forward(
        q, k, v, heads))
    grads = _on_route(_route(n, c, heads, dtype, True), 1,
                      lambda: port.packed_attention_backward(q, k, v, g, heads))
    flash = _on_route(fwd, 1, lambda: port.flash_attention_forward(*views))
    assert (port.packed_launches, port.packed_bwd_launches,
            port.flash_launches) == tuple(x + 1 for x in before)
    torch.testing.assert_close(
        out.float(), port.packed_attention_reference(q, k, v, heads).float(),
        **tol)
    for got, want in zip(grads, port.packed_attention_backward_reference(
            q, k, v, g, heads)):
        torch.testing.assert_close(got.float(), want.float(), **tol)
    torch.testing.assert_close(
        flash.float(), port.flash_attention_reference(*views).float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,heads,dtype", [
    (64, 197, 1024, 16, torch.bfloat16),
    (64, 197, 1024, 16, torch.float32),
    (8, 197, 768, 12, torch.bfloat16),
    (2, 67, 160, 5, torch.float32),
    *((1, n, 2 * d, 2, torch.bfloat16) for n, d in SWEEP),
])
def test_backward_kernel_matches_plain_on_gpu(require_cuda, b, n, c, heads,
                                             dtype):
    """K2 against the plain backward on the card: bf16 rounds P, dS and the
    output (2^-8 steps), f32 differs by summation order only; each launch
    on the route kernel_route names (bf16 at D 64 and N <= 256 wgmma, other
    bf16 mma, f32 SIMT); a shape past shared memory raises."""
    tol = (dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16
           else dict(atol=1e-4, rtol=1e-4))
    x = torch.from_numpy(_slab(b, n, c, seed=11)).to("cuda", dtype)
    g = torch.from_numpy(_slab(b, n, c, seed=12)[..., :c]).to("cuda", dtype)
    if not _fits(n, c, heads, dtype, backward=True):
        with pytest.raises(ValueError, match="shared memory"):
            port.slab_attention_backward(x, g, heads)
        return
    before = port.bwd_launches
    out = _on_route(_route(n, c, heads, dtype, True), 1,
                    lambda: port.slab_attention_backward(x, g, heads))
    assert port.bwd_launches == before + 1
    torch.testing.assert_close(
        out.float(), port.slab_attention_backward_reference(x, g, heads).float(),
        **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,heads,dtype", [
    (64, 197, 1024, 16, torch.bfloat16),
    (64, 197, 1024, 16, torch.float32),
    (8, 197, 768, 12, torch.bfloat16),
    (2, 67, 160, 5, torch.float32),
    *((1, n, 2 * d, 2, torch.bfloat16) for n, d in SWEEP),
])
def test_kernel_matches_plain_on_gpu(require_cuda, b, n, c, heads, dtype):
    tol = (dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16
           else dict(atol=1e-4, rtol=1e-4))
    x = torch.from_numpy(_slab(b, n, c, seed=3)).to("cuda", dtype)
    if not _fits(n, c, heads, dtype, backward=False):
        with pytest.raises(ValueError, match="shared memory"):
            port.slab_attention(x, heads)
        return
    before = port.launches
    out = _on_route(_route(n, c, heads, dtype), 1,
                    lambda: port.slab_attention(x, heads))
    assert port.launches == before + 1
    torch.testing.assert_close(out.float(),
                               port.slab_attention_reference(x, heads).float(),
                               **tol)


# The wgmma route's shapes on the card: ViT-L's and ViT-B's widths at the
# serve buckets and the train batch, and ragged N from one token to 256.
_WGMMA_CASES = [
    (64, 197, 1024, 16), (1, 197, 1024, 16), (64, 197, 768, 12),
    (2, 197, 768, 12), (4, 197, 768, 12),
    *((3, n, 256, 4) for n in (1, 16, 67, 197, 256)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,heads", _WGMMA_CASES)
def test_wgmma_route_matches_plain_on_gpu(require_cuda, b, n, c, heads):
    """K1 on the wgmma route (bf16, D 64, N <= 256) against the plain
    version within the bf16 bounds of the other kernels (P and O rounded to
    bf16, 2^-8 steps), and in norm within 1e-3; two launches bit-equal (no
    atomics, a fixed order)."""
    x = torch.from_numpy(_slab(b, n, c, seed=41)).to("cuda", torch.bfloat16)
    out = _on_route("wgmma", 1, lambda: port.slab_attention_forward(x, heads))
    ref = port.slab_attention_reference(x, heads).float()
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)
    assert ((out.float() - ref).norm() / ref.norm()).item() < 1e-3
    again = port.slab_attention_forward(x, heads)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,heads", _WGMMA_CASES)
def test_wgmma_route_on_strided_views_on_gpu(require_cuda, b, n, c, heads):
    """K4 on the q, k, v views of a QKV slab (row stride 3C, one tensor map
    an operand) and K3 on three dense operands, both on the wgmma route,
    equal K1 on the slab bit for bit (the same device code on the same
    values) and stay within the bf16 bounds of the plain version."""
    x = torch.from_numpy(_slab(b, n, c, seed=42)).to("cuda", torch.bfloat16)
    views = x.view(b, n, 3, heads, c // heads).unbind(2)
    assert views[1].stride(1) == 3 * c
    flash = _on_route("wgmma", 1, lambda: port.flash_attention_forward(*views))
    packed = _on_route("wgmma", 1, lambda: port.packed_attention_forward(
        *(y.contiguous() for y in x.split(c, -1)), heads))
    k1 = port.slab_attention_forward(x, heads)
    torch.cuda.synchronize()
    assert torch.equal(flash.reshape(b, n, c), k1)
    assert torch.equal(packed, k1)
    torch.testing.assert_close(
        flash.float(), port.flash_attention_reference(*views).float(),
        atol=2e-2, rtol=2e-2)


@pytest.fixture
def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,heads", _WGMMA_CASES)
def test_wgmma_backward_matches_plain_on_gpu(require_cuda, b, n, c, heads):
    """K2 on the wgmma route against the plain backward within the bf16
    bounds of the other kernels (P, dS and the gradients rounded to bf16,
    2^-8 steps) and in norm within 1e-3; two launches bit-equal (no atomics,
    a fixed order); K3's backward on the same values equals K2 bit for bit
    (the same device code); and the mma.sync kernel (S5's full peel) lies
    within the same bounds of it."""
    from touhouimageclassification_tpu_torch.ops import attention_study

    x = torch.from_numpy(_slab(b, n, c, seed=43)).to("cuda", torch.bfloat16)
    g = torch.from_numpy(_slab(b, n, c, seed=44)[..., :c]).to(
        "cuda", torch.bfloat16)
    out = _on_route("wgmma", 1, lambda: port.slab_attention_backward(
        x, g, heads))
    ref = port.slab_attention_backward_reference(x, g, heads).float()
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)
    assert ((out.float() - ref).norm() / ref.norm()).item() < 1e-3
    assert torch.equal(out, port.slab_attention_backward(x, g, heads))
    packed = _on_route("wgmma", 1, lambda: port.packed_attention_backward(
        *(y.contiguous() for y in x.split(c, -1)), g, heads))
    assert torch.equal(torch.cat(packed, -1), out)
    mma = attention_study.slab_attention_peel_backward(x, g, heads, "full")
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), mma.float(), atol=2e-2, rtol=2e-2)
    assert ((out.float() - mma.float()).norm() / mma.float().norm()).item() < 1e-3


@pytest.mark.cuda
def test_wgmma_routes_from_a_fresh_thread_on_gpu(require_cuda):
    """K1 and K2 on wgmma launched from a thread whose first CUDA call they
    are (as autograd's worker thread launches K2 when the attention
    backward is its first operation) equal the main thread's launches: the
    tensor-map encoder binds the thread to its device's context first."""
    import threading

    x = torch.from_numpy(_slab(2, 197, 768, seed=45)).to("cuda", torch.bfloat16)
    g = torch.from_numpy(_slab(2, 197, 768, seed=46)[..., :768]).to(
        "cuda", torch.bfloat16)
    got = {}
    thread = threading.Thread(target=lambda: got.update(
        fwd=port.slab_attention_forward(x, 12),
        bwd=port.slab_attention_backward(x, g, 12)))
    thread.start()
    thread.join()
    torch.cuda.synchronize()
    assert torch.equal(got["fwd"], port.slab_attention_forward(x, 12))
    assert torch.equal(got["bwd"], port.slab_attention_backward(x, g, 12))
