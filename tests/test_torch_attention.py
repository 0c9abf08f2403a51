"""Slab attention of the PyTorch port against the JAX package's slab attention.

The same numpy inputs go through the JAX ``packed_attention_slab`` (the Pallas
kernel, interpreted on the CPU), the JAX ``packed_reference_attention`` and the
port's plain version. f32 throughout, so the bound covers summation order
only. The CUDA kernel itself runs only on a GPU (``cuda`` marker).
"""
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
