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
SWEEP = [(n, d) for d in (32, 64, 128) for n in (1, 16, 67, 197, 257, 577)]


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 32, "mma"), (torch.bfloat16, 64, "mma"),
    (torch.bfloat16, 128, "mma"), (torch.float32, 32, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
])
def test_kernel_route_by_dtype(dtype, d, route):
    """bf16 takes the tensor-core route, f32 the SIMT route, at every head
    dim the kernels take."""
    assert port.kernel_route(dtype, d) == route


@pytest.mark.parametrize("dtype,d,error", [
    (torch.float16, 64, TypeError), (torch.float64, 64, TypeError),
    (torch.bfloat16, 16, ValueError), (torch.bfloat16, 80, ValueError),
    (torch.float32, 256, ValueError),
])
def test_kernel_route_raises_outside_the_kernels(dtype, d, error):
    with pytest.raises(error):
        port.kernel_route(dtype, d)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_count_no_route(dtype):
    """The plain versions on the CPU launch nothing: no route counts."""
    x = torch.from_numpy(_slab(1, 9, 64, seed=35)).to(dtype)
    g = torch.from_numpy(_slab(1, 9, 64, seed=36)[..., :64]).to(dtype)
    before = dict(port.route_launches)
    port.slab_attention_forward(x, 4)
    port.slab_attention_backward(x, g, 4)
    port.packed_attention_forward(*x.split(64, -1), 4)
    assert port.route_launches == before


def _on_route(dtype, launches, run):
    """run() on the card; its launches must all take the dtype's route."""
    want = port.kernel_route(dtype, 64)
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


def _fits(n, c, heads, dtype, backward):
    route = port.kernel_route(dtype, c // heads)
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
    out = _on_route(dtype, 1, lambda: port.packed_attention_forward(
        q, k, v, heads))
    grads = _on_route(dtype, 1, lambda: port.packed_attention_backward(
        q, k, v, g, heads))
    flash = _on_route(dtype, 1, lambda: port.flash_attention_forward(*views))
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
    output (2^-8 steps), f32 differs by summation order only; bf16 on the
    mma route, f32 on the SIMT route; a shape past shared memory raises."""
    tol = (dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16
           else dict(atol=1e-4, rtol=1e-4))
    x = torch.from_numpy(_slab(b, n, c, seed=11)).to("cuda", dtype)
    g = torch.from_numpy(_slab(b, n, c, seed=12)[..., :c]).to("cuda", dtype)
    if not _fits(n, c, heads, dtype, backward=True):
        with pytest.raises(ValueError, match="shared memory"):
            port.slab_attention_backward(x, g, heads)
        return
    before = port.bwd_launches
    out = _on_route(dtype, 1, lambda: port.slab_attention_backward(x, g, heads))
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
    out = _on_route(dtype, 1, lambda: port.slab_attention(x, heads))
    assert port.launches == before + 1
    torch.testing.assert_close(out.float(),
                               port.slab_attention_reference(x, heads).float(),
                               **tol)


@pytest.fixture
def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
