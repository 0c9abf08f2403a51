"""Patch embedding of the PyTorch port (K5's op) against the JAX package's
``pallas_patch_embed``, whose Pallas kernel runs interpreted on the CPU.

The same numpy images, kernel and bias go through both; the port takes the
kernel in its ``nn.Linear`` layout, (D, P*P*C), the transpose of JAX's
(P*P*C, D). f32 bounds cover summation order only. The CUDA kernel itself
runs only on a GPU (``cuda`` marker); which of its two device routes a
launch takes (bf16 on the tensor cores, ``'wgmma'``; f32 on ``'simt'``) is
decided in Python and tested here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touhouimageclassification_tpu.ops.patch_embed import pallas_patch_embed
from touhouimageclassification_tpu_torch.ops import patch_embed as port

torch.set_num_threads(1)


def _operands(b, h, w, patch, d, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    kernel = (0.02 * rng.standard_normal((patch * patch * 3, d))).astype(
        np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return images, kernel, bias


def _port(images, kernel, bias, dtype=torch.float32):
    return (torch.from_numpy(images).to(dtype),
            torch.from_numpy(kernel.T.copy()).to(dtype),
            torch.from_numpy(bias).to(dtype))


# test_patch_embed.py:16's shape, and a smaller patch on a non-square image
@pytest.mark.parametrize("b,h,w,patch,d", [(3, 32, 32, 16, 64),
                                           (2, 16, 24, 8, 32)])
def test_forward_matches_jax_pallas_kernel(b, h, w, patch, d):
    images, kernel, bias = _operands(b, h, w, patch, d)
    want = np.asarray(pallas_patch_embed(jnp.asarray(images),
                                         jnp.asarray(kernel),
                                         jnp.asarray(bias), patch))
    got = port.patch_embed(*_port(images, kernel, bias), patch).numpy()
    assert got.shape == want.shape == (b, (h // patch) * (w // patch), d)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_gradients_match_jax():
    """test_patch_embed.py:39: gradients of sum(out^2) w.r.t. the images,
    the kernel and the bias, against jax.grad through the Pallas op."""
    images, kernel, bias = _operands(2, 32, 32, 16, 32, seed=1)

    def loss(i, k, b):
        return jnp.sum(pallas_patch_embed(i, k, b, 16) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(images), jnp.asarray(kernel), jnp.asarray(bias))
    leaves = [x.requires_grad_() for x in _port(images, kernel, bias)]
    (port.patch_embed(*leaves, 16) ** 2).sum().backward()
    got = [leaves[0].grad, leaves[1].grad.T, leaves[2].grad]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


def test_bf16_rounds_once_as_jax():
    """bf16 operands: both sum in f32, add the bias in f32 and round once to
    bf16, so the outputs differ at most where summation order moves a value
    across a bf16 rounding boundary (one step, at most 2^-7 relative); the
    gradients come back in the operands' dtype, as JAX's ``_bwd`` casts
    them."""
    images, kernel, bias = _operands(2, 32, 32, 16, 64, seed=2)
    jb = [jnp.asarray(x).astype(jnp.bfloat16) for x in (images, kernel, bias)]
    want = np.asarray(pallas_patch_embed(*jb, 16).astype(jnp.float32))
    leaves = [x.requires_grad_() for x in _port(images, kernel, bias,
                                                torch.bfloat16)]
    out = port.patch_embed(*leaves, 16)
    assert out.dtype == torch.bfloat16
    got = out.float().detach().numpy()
    np.testing.assert_allclose(got, want, atol=0, rtol=2 ** -7)
    out.float().sum().backward()
    assert {x.grad.dtype for x in leaves} == {torch.bfloat16}


def test_reference_is_the_unfold_product():
    """The plain version is the unfold in (ph, pw, c) order times the
    weight, plus the bias (``_xla_forward``); fold inverts the unfold."""
    images, kernel, bias = _operands(2, 16, 16, 8, 16, seed=3)
    x = torch.from_numpy(images)
    unfolded = port.unfold(x, 8)
    manual = x.reshape(2, 2, 8, 2, 8, 3).permute(0, 1, 3, 2, 4, 5).reshape(
        2, 4, 192)
    torch.testing.assert_close(unfolded, manual, atol=0, rtol=0)
    torch.testing.assert_close(port.fold(unfolded, 8, 16, 16, 3), x, atol=0,
                               rtol=0)
    _, w, b = _port(images, kernel, bias)
    torch.testing.assert_close(port.patch_embed_reference(x, w, b, 8),
                               unfolded @ w.T + b, atol=1e-6, rtol=1e-6)


def test_cpu_tensor_takes_plain_version():
    args = _port(*_operands(2, 16, 16, 8, 16, seed=4))
    before = port.launches
    out = port.patch_embed(*args, 8)
    assert port.launches == before
    torch.testing.assert_close(out, port.patch_embed_reference(*args, 8),
                               atol=0, rtol=0)


def test_image_gradient_only_when_asked():
    """In the model the images need no gradient: the backward then forms
    only the weight's and the bias's (``needs_input_grad``)."""
    images, weight, bias = _port(*_operands(2, 16, 16, 8, 16, seed=5))
    weight.requires_grad_()
    bias.requires_grad_()
    port.patch_embed(images, weight, bias, 8).sum().backward()
    assert images.grad is None
    assert weight.grad.shape == weight.shape and bias.grad.shape == bias.shape
    torch.testing.assert_close(bias.grad, torch.full_like(bias, 8.0))


@pytest.mark.parametrize("dtype,patch,c,w,route", [
    (torch.bfloat16, 16, 3, 224, "wgmma"),   # ViT-*/16
    (torch.bfloat16, 8, 3, 224, "wgmma"),
    (torch.bfloat16, 16, 3, 160, "wgmma"),
    (torch.float32, 16, 3, 224, "simt"),
    (torch.float32, 14, 3, 224, "simt"),     # f32 takes any shape
])
def test_kernel_route(dtype, patch, c, w, route):
    assert port.kernel_route(dtype, patch, c, w) == route


@pytest.mark.parametrize("patch,c,w", [(14, 3, 224),   # P*C = 42
                                       (3, 8, 24)])    # K = 72
def test_bf16_shape_off_the_tensor_core_route_raises(patch, c, w):
    """The wgmma route copies 16-byte chunks of one (pw, c) run and steps K
    by 16: a bf16 shape outside that raises, and no other route takes it."""
    with pytest.raises(ValueError, match="wgmma"):
        port.kernel_route(torch.bfloat16, patch, c, w)


def test_kernel_route_rejects_other_dtypes():
    with pytest.raises(TypeError):
        port.kernel_route(torch.float16, 16, 3, 224)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_call_counts_no_launch_on_either_route(dtype):
    args = _port(*_operands(2, 16, 16, 8, 16, seed=7), dtype)
    before = (port.launches, dict(port.route_launches))
    port.patch_embed_forward(*args, 8)
    port.patch_embed(*args, 8)
    assert (port.launches, port.route_launches) == before


# ViT-L's shapes, then the bf16 sweep of chip_smoke.py: batches around the
# serve buckets with ragged last tiles, 224x224 at P 16 and 8, a non-square
# image, and D from one tile to ViT-L's with a ragged edge (1000)
_GPU_CASES = [(64, 224, 224, 16, 1024, torch.bfloat16),
              (2, 224, 224, 16, 1024, torch.float32)] + [
    (b, h, w, patch, d, torch.bfloat16) for b in (1, 3, 63)
    for h, w, patch in ((224, 224, 16), (224, 224, 8), (224, 160, 16))
    for d in (64, 768, 1000, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,patch,d,dtype", _GPU_CASES)
def test_kernel_matches_plain_on_gpu(require_cuda, b, h, w, patch, d, dtype):
    """K5 against its plain version, on its dtype's route: both sum in f32
    and round once, so bf16 differs by at most one step where summation
    order crosses a rounding boundary; f32 by summation order only. The
    relative difference in norm resolves faults far below the elementwise
    bound (chip_smoke.py's REL_TOL)."""
    images, kernel, bias = _operands(b, h, w, patch, d, seed=6)
    args = [x.to("cuda") for x in _port(images, kernel, bias, dtype)]
    route = port.kernel_route(dtype, patch, 3, w)
    before = (port.launches, port.route_launches[route])
    out = port.patch_embed_forward(*args, patch)
    torch.cuda.synchronize()
    assert (port.launches, port.route_launches[route]) == (before[0] + 1,
                                                           before[1] + 1)
    bf16 = dtype == torch.bfloat16
    tol = dict(atol=2e-2, rtol=2e-2) if bf16 else dict(atol=1e-4, rtol=1e-4)
    ref = port.patch_embed_reference(*args, patch).float()
    torch.testing.assert_close(out.float(), ref, **tol)
    assert (out.float() - ref).norm() / ref.norm() < (1e-3 if bf16 else 1e-5)


@pytest.fixture
def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
