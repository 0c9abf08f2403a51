"""Slab attention of the PyTorch port against the JAX package's slab attention.

The same numpy inputs go through the JAX ``packed_attention_slab`` (the Pallas
kernels, interpreted on the CPU, forward and VJP), the JAX
``packed_reference_attention`` (and ``jax.grad`` through it) and the port's
plain versions. f32 unless stated, so the bounds cover summation order only.
The CUDA kernels themselves run only on a GPU (``cuda`` marker).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touhouimageclassification_tpu.ops.attention import (
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,heads,dtype", [
    (64, 197, 1024, 16, torch.bfloat16),
    (64, 197, 1024, 16, torch.float32),
    (8, 197, 768, 12, torch.bfloat16),
    (2, 67, 160, 5, torch.float32),
])
def test_backward_kernel_matches_plain_on_gpu(require_cuda, b, n, c, heads,
                                             dtype):
    """K2 against the plain backward on the card: bf16 rounds P, dS and the
    output (2^-8 steps), f32 differs by summation order only."""
    tol = (dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16
           else dict(atol=1e-4, rtol=1e-4))
    x = torch.from_numpy(_slab(b, n, c, seed=11)).to("cuda", dtype)
    g = torch.from_numpy(_slab(b, n, c, seed=12)[..., :c]).to("cuda", dtype)
    before = port.bwd_launches
    out = port.slab_attention_backward(x, g, heads)
    torch.cuda.synchronize()
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
])
def test_kernel_matches_plain_on_gpu(require_cuda, b, n, c, heads, dtype):
    tol = (dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16
           else dict(atol=1e-4, rtol=1e-4))
    x = torch.from_numpy(_slab(b, n, c, seed=3)).to("cuda", dtype)
    before = port.launches
    out = port.slab_attention(x, heads)
    torch.cuda.synchronize()
    assert port.launches == before + 1
    torch.testing.assert_close(out.float(),
                               port.slab_attention_reference(x, heads).float(),
                               **tol)


@pytest.fixture
def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
