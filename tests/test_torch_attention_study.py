"""The kernel studies of the PyTorch port (``ops/attention_study.py``)
against the JAX package and the TPU studies they port: the roofline peels of
the slab attention (S5, ``tools/roofline_attn.py``) and the slab null copy
(S6, ``tools/bench_dma.py``).

The same numpy inputs (B 2, N 67 and 197, two heads of D 32 and 64) go
through the port's plain versions, which its wrappers take on the CPU, and
through JAX:

- the ``full`` peels, which are K1 and K2, against ``packed_attention_slab``
  and its VJP (the Pallas kernels interpreted on the CPU);
- the ``dma``, ``layout`` and ``matmul`` peels against the TPU study's own
  arithmetic, transcribed below in ``jnp`` with its lines cited (its kernel
  bodies are closures inside its ``main()`` and cannot be imported);
- the null-copy variants against ``jnp`` slicing of the same padded slab.

f32 differs by summation order only; bf16 rounds P, dS and the outputs to
bf16 on both sides. The CUDA kernels run only on a GPU (``cuda`` marker).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touhouimageclassification_tpu.ops.attention import (
    BWD_HEAD_GROUP,
    _stack_heads,
    _unstack_heads,
    packed_attention_slab,
)
from touhouimageclassification_tpu_torch.ops import attention_study as study
from touhouimageclassification_tpu_torch.tools import bench_dma, roofline_attn

torch.set_num_threads(1)

HEADS = 2
SHAPES = [(n, d) for n in (67, 197) for d in (32, 64)]
DTYPES = ["float32", "bfloat16"]


def _slab(n, d, seed, dtype="float32"):
    """(2, N, 3C) numpy f32, rounded to ``dtype``'s values."""
    x = np.random.default_rng(seed).standard_normal(
        (2, n, 3 * HEADS * d)).astype(np.float32)
    return np.array(jnp.asarray(x).astype(dtype).astype(jnp.float32))


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _pad_rows(x, n):
    """The (B, N, 3C) slab with zero rows appended up to ``n`` rows: the
    input of the padded null-copy variants."""
    return torch.nn.functional.pad(x, (0, 0, 0, n - x.shape[1]))


def _close(got, want, dtype):
    """f32: 1e-5 relative (and of the largest value); bf16: one rounding of
    P and of the output apart, 2e-2 relative, and 1e-2 in norm."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())
    if dtype == "bfloat16":
        assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


# --- the TPU study's arithmetic, transcribed --------------------------------

def _study_forward(x, num_heads, level):
    """``fwd_body`` of tools/roofline_attn.py:64-88 on each image of a
    (B, N, 3C) slab, returning what it writes to ``o_ref[0]``."""
    n = x.shape[1]

    def body(qkv):
        c = qkv.shape[-1] // 3
        scale = (c // num_heads) ** -0.5          # :60, D ** -0.5
        q, k, v = qkv[:, :c], qkv[:, c:2 * c], qkv[:, 2 * c:]   # :66
        if level == "dma":                        # :67-69
            return q
        qh = _stack_heads(q, num_heads)           # :70-72
        kh = _stack_heads(k, num_heads)
        vh = _stack_heads(v, num_heads)
        if level == "layout":                     # :73-75
            return _unstack_heads(qh).astype(qkv.dtype)
        s = jax.lax.dot_general(                  # :76-78
            qh, kh, (((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.float32) * scale
        assert level == "matmul"
        p = s * (1.0 / n)                         # :79-80
        o = jax.lax.dot_general(                  # :85-87
            p.astype(v.dtype), vh, (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32)
        return _unstack_heads(o).astype(qkv.dtype)   # :88

    return jax.vmap(body)(x)


def _study_backward(x, g, num_heads, level):
    """``bwd_body`` of tools/roofline_attn.py:106-147 on each image of a
    (B, N, 3C) slab and its upstream (B, N, C) gradient, returning what it
    writes to ``dqkv_ref[0]``."""
    n = x.shape[1]

    def body(qkv, g):
        c = qkv.shape[-1] // 3
        if level == "dma":                        # :108-110
            return qkv
        q, k, v = qkv[:, :c], qkv[:, c:2 * c], qkv[:, 2 * c:]   # :111
        hd = c // num_heads                       # :112
        scale = hd ** -0.5
        dqs, dks, dvs = [], [], []
        for h0 in range(0, num_heads, BWD_HEAD_GROUP):          # :114-119
            heads = list(range(h0, min(h0 + BWD_HEAD_GROUP, num_heads)))
            st = lambda x: jnp.stack(  # noqa: E731
                [x[:, h * hd:(h + 1) * hd] for h in heads], axis=0)
            qh, kh, vh, gh = st(q), st(k), st(v), st(g)
            s = jax.lax.dot_general(                            # :120-122
                qh, kh, (((2,), (2,)), ((0,), (0,))),
                preferred_element_type=jnp.float32) * scale
            dp = jax.lax.dot_general(                           # :123-124
                gh, vh, (((2,), (2,)), ((0,), (0,))),
                preferred_element_type=jnp.float32)
            assert level == "matmul"
            p = s * (1.0 / n)                                   # :125-127
            ds = dp * (1.0 / n)
            ds_c = ds.astype(k.dtype)                           # :133-134
            p_c = p.astype(g.dtype)
            dqs.append(jax.lax.dot_general(                     # :135-143
                ds_c, kh, (((2,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32) * scale)
            dks.append(jax.lax.dot_general(
                ds_c, qh, (((1,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32) * scale)
            dvs.append(jax.lax.dot_general(
                p_c, gh, (((1,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32))
        cat = lambda xs: jnp.concatenate(  # noqa: E731       :144-145
            [x[i] for x in xs for i in range(x.shape[0])], axis=-1)
        return jnp.concatenate(                                 # :146-147
            [cat(dqs), cat(dks), cat(dvs)], axis=-1).astype(qkv.dtype)

    return jax.vmap(body)(x, g)


def _np(x):
    return np.asarray(x.astype(jnp.float32))


# --- S5: the forward and backward peels --------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,d", SHAPES)
def test_full_forward_peel_matches_jax_kernel(n, d, dtype):
    """The ``full`` forward peel is the slab attention: against the JAX
    Pallas slab kernel (interpreted) in f32 at 1e-5 relative (the attention
    tests' 2e-5 absolute), in bf16 at test_torch_attention.py's 2e-2."""
    x = _slab(n, d, seed=n + d, dtype=dtype)
    got = study.slab_attention_peel_forward(_torch(x, dtype), HEADS, "full")
    assert got.dtype == getattr(torch, dtype)
    want = _np(packed_attention_slab(jnp.asarray(x).astype(dtype), HEADS))
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=2e-2 if dtype == "bfloat16" else 2e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,d", SHAPES)
def test_full_backward_peel_matches_jax_vjp(n, d, dtype):
    """The ``full`` backward peel is the slab gradient: against the VJP of
    JAX's ``packed_attention_slab`` (its Pallas backward, interpreted). f32
    at 1e-5 relative (2e-5 absolute, as the forward); bf16 no farther from
    JAX's bf16 gradient than that is from JAX's own f32 gradient (both round
    P, dS and the output to bf16), as test_torch_attention.py holds K2's
    plain version."""
    x = _slab(n, d, seed=2 * n + d, dtype=dtype)
    g = _slab(n, d, seed=3 * n + d, dtype=dtype)[..., :HEADS * d]
    got = study.slab_attention_peel_backward(
        _torch(x, dtype), _torch(g, dtype), HEADS, "full")
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape

    def vjp(dt):
        _, f = jax.vjp(lambda s: packed_attention_slab(s, HEADS),
                       jnp.asarray(x).astype(dt))
        return _np(f(jnp.asarray(g).astype(dt))[0])

    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), vjp("float32"), atol=2e-5,
                                   rtol=1e-5)
    else:
        want, want32 = vjp("bfloat16"), vjp("float32")
        assert np.abs(got.float().numpy() - want).max() <= np.abs(
            want - want32).max()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("level", ["dma", "layout", "matmul"])
def test_forward_peel_matches_the_study(level, n, d, dtype):
    """``dma`` and ``layout`` write q bit for bit, as the study's copy and
    its stack/unstack relayout do; ``matmul`` is the study's two products
    with P = S * D^-1/2 / N."""
    x = _slab(n, d, seed=5 * n + d, dtype=dtype)
    got = study.slab_attention_peel_forward(_torch(x, dtype), HEADS, level)
    want = _np(_study_forward(jnp.asarray(x).astype(dtype), HEADS, level))
    if level == "matmul":
        _close(got, want, dtype)
    else:
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("level", ["dma", "matmul"])
def test_backward_peel_matches_the_study(level, n, d, dtype):
    """``dma`` writes the slab back ([q | k | v]) bit for bit; ``matmul`` is
    the study's five products with P = S * D^-1/2 / N and dS = dP / N."""
    x = _slab(n, d, seed=7 * n + d, dtype=dtype)
    g = _slab(n, d, seed=11 * n + d, dtype=dtype)[..., :HEADS * d]
    got = study.slab_attention_peel_backward(
        _torch(x, dtype), _torch(g, dtype), HEADS, level)
    want = _np(_study_backward(jnp.asarray(x).astype(dtype),
                               jnp.asarray(g).astype(dtype), HEADS, level))
    if level == "matmul":
        _close(got, want, dtype)
    else:
        np.testing.assert_array_equal(got.float().numpy(), want)


# --- S6: the null copy --------------------------------------------------------

@pytest.mark.parametrize("n", [67, 197])
@pytest.mark.parametrize("variant", list(study.NULL_COPY_VARIANTS))
def test_null_copy_matches_jnp_slicing(variant, n):
    """Every variant writes what the TPU study's kernels leave: the padded
    slab's first third (``null_copy``, bench_dma.py:45-46), or for ``lanes``
    the last of the thirds its sequential grid writes to one block
    (:61-62, grid (B, 3), out block (i, 0, 0))."""
    c = HEADS * 64
    x = _torch(_slab(n, 64, seed=n, dtype="bfloat16"), "bfloat16")
    rows = study.NULL_COPY_VARIANTS[variant][2]
    padded = _pad_rows(x, rows) if rows else x
    assert torch.equal(padded[:, :n], x) and not padded[:, n:].any()
    got = study.null_copy(padded, c, variant)
    jx = jnp.asarray(padded.float().numpy()).astype(jnp.bfloat16)
    if variant == "lanes":
        for j in range(3):
            want = jx[:, :, j * c:(j + 1) * c]
    else:
        want = jx[:, :, :c]
    assert got.shape == (2, padded.shape[1], c) and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


def test_padded_variant_needs_its_rows():
    x = torch.zeros(2, 67, 3 * 128, dtype=torch.bfloat16)
    for variant in ("n208", "n256", "img4n208"):
        with pytest.raises(ValueError, match="padded"):
            study.null_copy(x, 128, variant)


def test_null_copy_smem_fits_an_h100_block():
    """A ring of 3 stages of 4 rows: 72 KB at ViT-L's 3C (three blocks an
    SM, as K1), 24 KB for a third (``lanes``)."""
    assert study.null_copy_smem_bytes(1024, "n197") == 73728
    assert study.null_copy_smem_bytes(1024, "img4") == 73728
    assert study.null_copy_smem_bytes(1024, "lanes") == 24576
    assert 3 * 73728 <= 232448


# --- the wrappers' contract ---------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda x, g: study.slab_attention_peel_forward(x, 2, "softmax"),
    lambda x, g: study.slab_attention_peel_backward(x, g, 2, "layout"),
    lambda x, g: study.null_copy(x, 128, "img8"),
    lambda x, g: study.peel_forward_reference(x, 2, "dmaa"),
    lambda x, g: study.peel_backward_reference(x, g, 2, "relayout"),
    lambda x, g: study.null_copy_reference(x, 128, "xla_copy"),
])
def test_unknown_level_or_variant_raises(call):
    """Unknown levels and variants raise, on every device (the backward has
    no ``layout`` level, and ``xla_copy`` is not a kernel)."""
    x = torch.zeros(1, 9, 3 * 128, dtype=torch.bfloat16)
    g = torch.zeros(1, 9, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unknown"):
        call(x, g)
    with pytest.raises(ValueError, match="unknown"):
        call(x.to("meta"), g.to("meta"))


@pytest.mark.parametrize("call", [
    lambda x, g: study.slab_attention_peel_forward(x, 2, "dma"),
    lambda x, g: study.slab_attention_peel_backward(x, g, 2, "full"),
    lambda x, g: study.null_copy(x, 128, "n197"),
])
def test_f32_off_the_cpu_raises(call):
    """A float32 tensor that is not on the CPU raises before any launch (the
    studies are bf16; the SIMT routes are not peeled). Shown on the meta
    device here; ``test_f32_on_gpu_raises`` shows it on a card."""
    x = torch.empty(1, 9, 3 * 128, device="meta")
    g = torch.empty(1, 9, 128, device="meta")
    with pytest.raises(TypeError, match="bf16"):
        call(x, g)


def test_peels_take_head_dim_64_only():
    x = torch.empty(1, 9, 3 * 64, dtype=torch.bfloat16, device="meta")
    g = torch.empty(1, 9, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="head dim 64"):
        study.slab_attention_peel_forward(x, 2, "full")
    with pytest.raises(ValueError, match="head dim 64"):
        study.slab_attention_peel_backward(x, g, 2, "full")


def test_cpu_calls_count_no_launch():
    x = torch.from_numpy(_slab(17, 64, seed=1)).to(torch.bfloat16)
    g = x[..., :128].contiguous()
    study.reset_launches()
    for level in study.PEEL_LEVELS:
        study.slab_attention_peel_forward(x, 2, level)
    for level in study.BWD_PEEL_LEVELS:
        study.slab_attention_peel_backward(x, g, 2, level)
    for variant, (_, _, rows) in study.NULL_COPY_VARIANTS.items():
        study.null_copy(_pad_rows(x, rows) if rows else x, 128, variant)
    counts = (study.peel_launches, study.peel_bwd_launches,
              study.null_copy_launches)
    assert all(v == 0 for count in counts for v in count.values())


def test_study_module_has_no_fallback():
    """No try/except to fall back with and no environment switch in the
    wrappers, as for K1-K5 (test_torch_isolation.py)."""
    src = open(study.__file__).read()
    assert "try:" not in src and "except" not in src and "environ" not in src


# --- the tools, without a card ---------------------------------------------

@pytest.mark.parametrize("tool", [roofline_attn, bench_dma])
def test_tool_without_gpu_exits_1(tool, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tool would measure")
    assert tool.main(["--batch", "2", "--reps", "1"]) == 1
    assert "needs an NVIDIA GPU" in capsys.readouterr().err


def test_floors_at_vit_l_widths():
    """Bytes over 3.35 TB/s at ViT-L: forward 206.6 MB (0.0617 ms at B 128,
    0.0308 at B 64), backward 361.5 MB (0.1079 / 0.0540); the products
    (two forward, five backward) come in under them; the null copy 0.0617,
    0.0651, 0.0801 ms at n 197, 208, 256."""
    f128, f64 = roofline_attn.floors(128), roofline_attn.floors(64)
    assert round(f128["fwd_bound_ms"], 4) == 0.0617
    assert round(f128["bwd_bound_ms"], 4) == 0.1079
    assert round(f64["fwd_bound_ms"], 4) == 0.0308
    assert round(f64["bwd_bound_ms"], 4) == 0.0540
    assert round(f128["fwd_products_ms"], 4) == 0.0206
    assert round(f128["bwd_products_ms"], 4) == 0.0514
    for n, ms in ((197, 0.0617), (208, 0.0651), (256, 0.0801)):
        assert round(1e3 * bench_dma.copy_bytes(128, n) / 3.35e12, 4) == ms


def test_decomposition_adds_up():
    t = {"fwd_dma": 0.04, "fwd_layout": 0.05, "fwd_matmul": 0.08,
         "fwd_full": 0.12, "bwd_dma": 0.09, "bwd_matmul": 0.2,
         "bwd_full": 0.26}
    dec = roofline_attn.decompose(t)
    fwd = ("fwd_grid_dma", "fwd_relayout", "fwd_matmuls", "fwd_softmax")
    bwd = ("bwd_grid_dma", "bwd_matmuls_layout", "bwd_softmax")
    assert sum(dec[k] for k in fwd) == pytest.approx(dec["fwd_kernel"])
    assert sum(dec[k] for k in bwd) == pytest.approx(dec["bwd_kernel"])
    assert sum(dec[f"{k}_share"] for k in fwd + bwd) == pytest.approx(2)


_CUOBJDUMP = """
\t\tFunction : _ZN5firstE
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED"
        /*0000*/             LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                      /* 0x000fe20000000800 */
.L_x_0:
        /*10010*/                  BRA `(.L_x_0) ;          /* 0x0 */
        /*10020*/                  NOP;                     /* 0x0 */
        ..........

\tcode version = [1,7]
\thost = linux
Fatbin elf code:
================
\t\tFunction : _ZN6secondE
        /*0000*/                   EXIT ;                   /* 0x0 */
"""


def test_sass_comparison_keeps_instructions_only(monkeypatch):
    """``ab_slab_kernels.sass`` reads ``cuobjdump -sass``: each kernel keeps
    its instruction lines without addresses (of any width) or encodings,
    and drops its trailing NOP padding, the next cubin's header lines and
    labels, so that one kernel placed elsewhere in a library compares
    equal."""
    import subprocess
    import types

    from touhouimageclassification_tpu_torch.ops import _build
    from touhouimageclassification_tpu_torch.tools import ab_slab_kernels

    monkeypatch.setattr(_build, "find_nvcc", lambda: "/cuda/bin/nvcc")
    calls = []
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: calls.append(
        cmd) or types.SimpleNamespace(stdout=_CUOBJDUMP))
    assert ab_slab_kernels.sass("lib.so") == {
        "_ZN5firstE": ("LDC R1, c[0x0][0x28] ;", "BRA `(.L_x_0) ;"),
        "_ZN6secondE": ("EXIT ;",)}
    assert calls == [["/cuda/bin/cuobjdump", "-sass", "lib.so"]]


# --- the kernels, on a card -------------------------------------------------

@pytest.fixture
def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


def _gpu_slab(n=197, c=1024, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(4, n, 3 * c, generator=gen, device="cuda").to(
        torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("level", study.PEEL_LEVELS)
def test_forward_peel_kernel_matches_plain_on_gpu(require_cuda, level):
    """``dma`` and ``layout`` bit for bit, ``matmul`` and ``full`` within
    the bf16 bound of the K1 checks; ``full`` is K1's mma.sync kernel bit
    for bit."""
    qkv = _gpu_slab()
    before = study.peel_launches[level]
    got = study.slab_attention_peel_forward(qkv, 16, level)
    assert study.peel_launches[level] == before + 1
    want = study.peel_forward_reference(qkv, 16, level)
    if level in ("dma", "layout"):
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
    if level == "full":  # K1's mma.sync kernel, the route before wgmma
        assert torch.equal(got, study.softmax_variant_forward(qkv, 16, True,
                                                              False))


@pytest.mark.cuda
@pytest.mark.parametrize("level", study.BWD_PEEL_LEVELS)
def test_backward_peel_kernel_matches_plain_on_gpu(require_cuda, level):
    from touhouimageclassification_tpu_torch.ops import attention

    qkv = _gpu_slab()
    g = _gpu_slab(seed=1)[..., :1024].contiguous()
    got = study.slab_attention_peel_backward(qkv, g, 16, level)
    want = study.peel_backward_reference(qkv, g, 16, level)
    if level == "dma":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
    if level == "full":  # K2's mma.sync kernel, the route before wgmma
        lib = attention.load_library()
        mma = torch.empty_like(qkv)
        stats = torch.empty(3, 4, 16, 197, device="cuda")
        assert lib.tic_slab_attention_bwd(
            qkv.data_ptr(), g.data_ptr(), mma.data_ptr(), stats.data_ptr(), 4,
            197, 16, 64, 1, 0.125, torch.cuda.current_stream().cuda_stream) == 0
        assert torch.equal(got, mma)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(study.NULL_COPY_VARIANTS))
def test_null_copy_kernel_matches_plain_on_gpu(require_cuda, variant):
    rows = study.NULL_COPY_VARIANTS[variant][2]
    qkv = _gpu_slab(n=rows or 197)
    got = study.null_copy(qkv, 1024, variant)
    assert torch.equal(got, study.null_copy_reference(qkv, 1024, variant))


@pytest.mark.cuda
def test_f32_on_gpu_raises(require_cuda):
    qkv = _gpu_slab().float()
    with pytest.raises(TypeError, match="bf16"):
        study.slab_attention_peel_forward(qkv, 16, "full")
    with pytest.raises(TypeError, match="bf16"):
        study.null_copy(qkv, 1024, "n197")
