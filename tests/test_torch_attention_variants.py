"""The tile studies of the PyTorch port (``ops/attention_study.py``: S1-S4)
against the JAX package and the TPU studies they port: whole images a grid
step (S1, ``tools/bench_attn4.py``), the softmax variants (S2,
``tools/bench_attn6.py``), head batching (S3, ``tools/bench_attn7.py``) and
H / S heads a step (S4, ``tools/bench_attn8.py``).

The same numpy inputs (B 2 and 3, N 67 and 197, four heads of D 32 and 64)
go through the port's plain versions, which its wrappers take on the CPU,
and through JAX:

- every tile's forward and backward against ``packed_attention_slab`` and
  its VJP (the Pallas kernels, interpreted on the CPU): a tile changes who
  computes, not what;
- S4's ``fwd_split`` and ``bwd_split`` rebuilt as the study builds them: a
  ``pallas_call`` (interpreted) over the grid (B, S) with three lane-offset
  ``BlockSpec`` views of one slab, around the importable
  ``_packed_fwd_kernel_body`` and the study's backward body;
- S1's ``fwd_blocked``, S2's four ``make_fwd`` bodies and S3's
  ``fwd_batched``, ``bwd_batched`` and ``fwd_pairs``, transcribed below in
  ``jnp`` with their lines cited (they are closures inside each study's
  ``main()`` and cannot be imported).

f32 differs by summation order only; bf16 rounds P (or e), dS and the
outputs to bf16 on both sides. The CUDA kernels run only on a GPU (``cuda``
marker).
"""
import functools
import itertools
import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from touhouimageclassification_tpu.ops import _pallas_compat as pc
from touhouimageclassification_tpu.ops.attention import (
    BWD_HEAD_GROUP,
    _packed_fwd_kernel_body,
    packed_attention_slab,
)
from touhouimageclassification_tpu_torch.ops import attention_study as study
from touhouimageclassification_tpu_torch.tools import (
    attn_tiles,
    bench_attn4,
    bench_attn6,
    bench_attn7,
    bench_attn8,
)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
HEADS = 4
SHAPES = [(b, n, d) for b in (2, 3) for n in (67, 197) for d in (32, 64)]
DTYPES = ["float32", "bfloat16"]
LOG2E = 1.4426950408889634
H100_SMEM = 232448  # the most dynamic shared memory one H100 block may use


def _slab(b, n, d, seed, dtype, width=3):
    """(B, N, width * H * D) numpy f32, rounded to ``dtype``'s values."""
    x = np.random.default_rng(seed).standard_normal(
        (b, n, width * HEADS * d)).astype(np.float32)
    return np.array(jnp.asarray(x).astype(dtype).astype(jnp.float32))


@functools.cache
def _inputs(b, n, d, dtype):
    return (_slab(b, n, d, 100 * b + n + d, dtype),
            _slab(b, n, d, 200 * b + n + d, dtype, width=1))


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype):
    """f32: 1e-5 relative (and of the largest value); bf16: one rounding of
    P and of the output apart, 2e-2 relative, and 1e-2 in norm."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())
    if dtype == "bfloat16":
        assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


@functools.cache
def _jax_forward(b, n, d, dtype):
    x, _ = _inputs(b, n, d, dtype)
    return _np(packed_attention_slab(jnp.asarray(x).astype(dtype), HEADS))


@functools.cache
def _jax_backward(b, n, d, dtype):
    x, g = _inputs(b, n, d, dtype)
    _, f = jax.vjp(lambda s: packed_attention_slab(s, HEADS),
                   jnp.asarray(x).astype(dtype))
    return _np(f(jnp.asarray(g).astype(dtype))[0])


def _key(tile):
    return "shipped" if tile == study.SHIPPED_TILE else "-".join(
        f"{k}{v}" for k, v in tile._asdict().items())


# --- every tile against the JAX Pallas kernels ----------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,d", SHAPES)
@pytest.mark.parametrize("tile", [*study.FWD_TILES, study.SHIPPED_TILE],
                         ids=_key)
def test_tile_forward_matches_jax_kernel(tile, b, n, d, dtype):
    """Every forward tile (B 3 is ragged for 2 and 4 images a block) is the
    slab attention: against JAX's slab kernel, interpreted."""
    x, _ = _inputs(b, n, d, dtype)
    got = study.slab_attention_tile_forward(_torch(x, dtype), HEADS, tile)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, n,
                                                                HEADS * d)
    _close(got, _jax_forward(b, n, d, dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,d", SHAPES)
@pytest.mark.parametrize("tile", [*study.BWD_TILES, study.SHIPPED_TILE],
                         ids=_key)
def test_tile_backward_matches_jax_vjp(tile, b, n, d, dtype):
    """Every backward tile is the slab gradient: against the VJP of JAX's
    ``packed_attention_slab`` (its Pallas backward, interpreted)."""
    x, g = _inputs(b, n, d, dtype)
    got = study.slab_attention_tile_backward(_torch(x, dtype),
                                             _torch(g, dtype), HEADS, tile)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    _close(got, _jax_backward(b, n, d, dtype), dtype)


# --- S4: the study's pallas_calls, interpreted ---------------------------------

def _fwd_split(qkv, splits):
    """``fwd_split`` of tools/bench_attn8.py:32-52 at this test's shapes."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    cs, hs = c // splits, HEADS // splits                 # :33-34
    scale = (c // HEADS) ** -0.5                          # :30

    def kernel(q_ref, k_ref, v_ref, o_ref):               # :36-38
        _packed_fwd_kernel_body(q_ref[0], k_ref[0], v_ref[0], o_ref,
                                num_heads=hs, scale=scale)

    blk = lambda off: pl.BlockSpec(  # noqa: E731          :40-42
        (1, n, cs), lambda i, j, off=off: (i, 0, off + j),
        memory_space=pc.VMEM)
    out_spec = pl.BlockSpec((1, n, cs), lambda i, j: (i, 0, j),  # :43-44
                            memory_space=pc.VMEM)
    return pl.pallas_call(                                # :45-52
        kernel, grid=(b, splits),
        in_specs=[blk(0), blk(splits), blk(2 * splits)],
        out_specs=out_spec,
        out_shape=jax.ShapeDtypeStruct((b, n, c), qkv.dtype),
        interpret=True)(qkv, qkv, qkv)


def _bwd_split(qkv, g, splits):
    """``bwd_split`` of tools/bench_attn8.py:54-107 at this test's shapes."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    cs, hs = c // splits, HEADS // splits                 # :55-56
    hd = c // HEADS
    scale = hd ** -0.5

    def kernel(q_ref, k_ref, v_ref, g_ref, dq_ref, dk_ref, dv_ref):
        q, k, v, gg = q_ref[0], k_ref[0], v_ref[0], g_ref[0]      # :59
        dqs, dks, dvs = [], [], []
        for h0 in range(0, hs, BWD_HEAD_GROUP):                   # :62-66
            heads = list(range(h0, min(h0 + BWD_HEAD_GROUP, hs)))
            st = lambda x: jnp.stack(  # noqa: E731
                [x[:, h * hd:(h + 1) * hd] for h in heads], axis=0)
            qh, kh, vh, gh = st(q), st(k), st(v), st(gg)
            s = jax.lax.dot_general(                              # :67-69
                qh, kh, (((2,), (2,)), ((0,), (0,))),
                preferred_element_type=jnp.float32) * scale
            m = jnp.max(s, axis=-1, keepdims=True)                # :70-72
            e = jnp.exp(s - m)
            p = e / jnp.sum(e, axis=-1, keepdims=True)
            dp = jax.lax.dot_general(                             # :73-75
                gh, vh, (((2,), (2,)), ((0,), (0,))),
                preferred_element_type=jnp.float32)
            ds = p * (dp - jnp.sum(dp * p, axis=-1, keepdims=True))
            ds_c = ds.astype(k.dtype)                             # :77-78
            p_c = p.astype(gg.dtype)
            dqs.append(jax.lax.dot_general(                       # :79-87
                ds_c, kh, (((2,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32) * scale)
            dks.append(jax.lax.dot_general(
                ds_c, qh, (((1,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32) * scale)
            dvs.append(jax.lax.dot_general(
                p_c, gh, (((1,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32))
        cat = lambda xs: jnp.concatenate(  # noqa: E731          :88-89
            [x[i] for x in xs for i in range(x.shape[0])], axis=-1)
        dq_ref[0] = cat(dqs).astype(dq_ref.dtype)                 # :90-92
        dk_ref[0] = cat(dks).astype(dk_ref.dtype)
        dv_ref[0] = cat(dvs).astype(dv_ref.dtype)

    blk = lambda off: pl.BlockSpec(  # noqa: E731                :94-96
        (1, n, cs), lambda i, j, off=off: (i, 0, off + j),
        memory_space=pc.VMEM)
    gspec = pl.BlockSpec((1, n, cs), lambda i, j: (i, 0, j),      # :97-98
                         memory_space=pc.VMEM)
    shape = jax.ShapeDtypeStruct((b, n, c), qkv.dtype)
    return pl.pallas_call(                                        # :100-107
        kernel, grid=(b, splits),
        in_specs=[blk(0), blk(splits), blk(2 * splits), gspec],
        out_specs=(gspec, gspec, gspec), out_shape=(shape, shape, shape),
        interpret=True)(qkv, qkv, qkv, g)


SPLIT_SHAPES = [(2, 67, 32), (3, 197, 64)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,d", SPLIT_SHAPES)
@pytest.mark.parametrize("splits", [1, 2, 4])
def test_s4_forward_matches_the_study_split(splits, b, n, d, dtype):
    """S4's tile at ``splits`` against the study's own grid (B, S) of
    lane-offset views, each step the shipped body on H / S heads."""
    x, _ = _inputs(b, n, d, dtype)
    tile = study.STUDY_TILES["S4"][splits]
    got = study.slab_attention_tile_forward(_torch(x, dtype), HEADS, tile)
    _close(got, _np(_fwd_split(jnp.asarray(x).astype(dtype), splits)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,d", SPLIT_SHAPES)
@pytest.mark.parametrize("splits", [1, 2, 4])
def test_s4_backward_matches_the_study_split(splits, b, n, d, dtype):
    """S4's backward tile against the study's ``bwd_split``: its heads in
    groups of ``BWD_HEAD_GROUP``, three gradients, concatenated here as the
    slab gradient [dq | dk | dv]."""
    x, g = _inputs(b, n, d, dtype)
    tile = study.STUDY_TILES["S4"][splits]
    got = study.slab_attention_tile_backward(_torch(x, dtype),
                                             _torch(g, dtype), HEADS, tile)
    dq, dk, dv = _bwd_split(jnp.asarray(x).astype(dtype),
                            jnp.asarray(g).astype(dtype), splits)
    _close(got, _np(jnp.concatenate([dq, dk, dv], axis=-1)), dtype)


# --- S1, S2, S3: the studies' kernel bodies, transcribed ------------------------

def _per_image(body, *xs):
    """``body`` on the (N, C) q, k, v (and g) of each image of the slab."""
    def one(qkv, *rest):
        c = qkv.shape[-1] // 3
        return body(qkv[:, :c], qkv[:, c:2 * c], qkv[:, 2 * c:], *rest)
    return jax.vmap(one)(*xs)


def _blocked(x, block_b):
    """``fwd_blocked``'s kernel (tools/bench_attn4.py:29-47) on blocks of
    ``block_b`` images; the batch is padded with zero images up to whole
    blocks (the study's grid B // block_b has none to pad) and cut back."""
    b, n, c3 = x.shape
    c = c3 // 3
    hd = c // HEADS
    scale = hd ** -0.5                                       # :27
    pad = -b % block_b
    x = jnp.concatenate([x, jnp.zeros((pad, n, c3), x.dtype)])
    q, k, v = x[..., :c], x[..., c:2 * c], x[..., 2 * c:]

    def kernel(q_ref, k_ref, v_ref):                         # :29
        out = []
        for bb in range(block_b):                            # :30
            outs = []
            for h in range(HEADS):                           # :32-45
                sl = slice(h * hd, (h + 1) * hd)
                s = jax.lax.dot_general(
                    q_ref[bb][:, sl], k_ref[bb][:, sl],
                    (((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.float32) * scale
                m = jnp.max(s, axis=-1, keepdims=True)
                e = jnp.exp(s - m)
                p = e / jnp.sum(e, axis=-1, keepdims=True)
                outs.append(jax.lax.dot_general(
                    p.astype(v_ref.dtype), v_ref[bb][:, sl],
                    (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32))
            out.append(jnp.concatenate(outs, axis=-1).astype(q.dtype))  # :46
        return jnp.stack(out)

    blocks = lambda y: y.reshape(-1, block_b, n, c)  # noqa: E731
    return jax.vmap(kernel)(blocks(q), blocks(k), blocks(v)).reshape(
        -1, n, c)[:b]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,d", SHAPES)
@pytest.mark.parametrize("block_b", [1, 2, 4])
def test_s1_tile_matches_fwd_blocked(block_b, b, n, d, dtype):
    """S1's tile at ``block_b`` against ``fwd_blocked``'s arithmetic."""
    x, _ = _inputs(b, n, d, dtype)
    got = study.slab_attention_tile_forward(
        _torch(x, dtype), HEADS, study.STUDY_TILES["S1"][block_b])
    _close(got, _np(_blocked(jnp.asarray(x).astype(dtype), block_b)), dtype)


def _make_fwd_body(use_exp2, post_mul, d):
    """``kernel`` of ``make_fwd`` (tools/bench_attn6.py:25-52) on one
    image's (N, C) q, k, v."""
    scale = d ** -0.5                                        # :26

    def body(q, k, v):
        outs = []
        for h in range(HEADS):                               # :30-51
            sl = slice(h * d, (h + 1) * d)
            s = jax.lax.dot_general(
                q[:, sl], k[:, sl], (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32)
            s = s * (scale * LOG2E if use_exp2 else scale)
            m = jnp.max(s, axis=-1, keepdims=True)
            e = (jnp.exp2 if use_exp2 else jnp.exp)(s - m)
            if post_mul:
                r = 1.0 / jnp.sum(e, axis=-1, keepdims=True)
                o = jax.lax.dot_general(
                    e.astype(v.dtype), v[:, sl], (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32) * r
            else:
                p = e / jnp.sum(e, axis=-1, keepdims=True)
                o = jax.lax.dot_general(
                    p.astype(v.dtype), v[:, sl], (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32)
            outs.append(o)
        return jnp.concatenate(outs, axis=-1).astype(q.dtype)   # :52

    return body


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,d", SHAPES)
@pytest.mark.parametrize("variant", study.SOFTMAX_VARIANTS,
                         ids=lambda v: f"exp2{v[0]}-postmul{v[1]}")
def test_s2_plain_version_matches_make_fwd(variant, b, n, d, dtype):
    """Each S2 variant's plain version (the CPU path of
    ``softmax_variant_forward``) against the study's kernel body."""
    x, _ = _inputs(b, n, d, dtype)
    got = study.softmax_variant_forward(_torch(x, dtype), HEADS, *variant)
    want = _per_image(_make_fwd_body(*variant, d),
                      jnp.asarray(x).astype(dtype))
    _close(got, _np(want), dtype)
    assert torch.equal(got, study.softmax_variant_reference(
        _torch(x, dtype), HEADS, *variant))


def test_s2_post_mul_differs_from_k1_by_one_rounding():
    """``post_mul`` rounds e, not P, to bf16: not K1's bits, but within one
    bf16 rounding of them; exp2 without it rounds P as K1 does."""
    x = _torch(_inputs(2, 197, 64, "bfloat16")[0], "bfloat16")
    k1 = study.slab_attention_reference(x, HEADS).float()
    for exp2, post_mul in study.SOFTMAX_VARIANTS:
        got = study.softmax_variant_reference(x, HEADS, exp2, post_mul)
        rel = ((got.float() - k1).norm() / k1.norm()).item()
        assert rel < 1e-2
        if post_mul:
            assert not torch.equal(got.float(), k1)


def _fwd_batched(q, k, v, d):
    """``fwd_batched`` of tools/bench_attn7.py:43-60 on one image."""
    scale = d ** -0.5                                        # :39
    r = lambda x: jnp.stack(  # noqa: E731                   :47-48
        [x[:, h * d:(h + 1) * d] for h in range(HEADS)], axis=0)
    qh, kh, vh = r(q), r(k), r(v)
    s = jax.lax.dot_general(                                 # :50-52
        qh, kh, (((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.float32) * scale
    m = jnp.max(s, axis=-1, keepdims=True)                   # :53-55
    e = jnp.exp(s - m)
    p = e / jnp.sum(e, axis=-1, keepdims=True)
    o = jax.lax.dot_general(                                 # :56-58
        p.astype(v.dtype), vh, (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32)
    return jnp.concatenate([o[h] for h in range(HEADS)],     # :59-60
                           axis=-1).astype(q.dtype)


def _bwd_batched(q, k, v, g, d):
    """``bwd_batched`` of tools/bench_attn7.py:62-93 on one image: the slab
    gradient [dq | dk | dv]."""
    scale = d ** -0.5
    r = lambda x: jnp.stack(  # noqa: E731                   :64-65
        [x[:, h * d:(h + 1) * d] for h in range(HEADS)], axis=0)
    un = lambda x: jnp.concatenate(  # noqa: E731            :66-67
        [x[h] for h in range(HEADS)], axis=-1)
    qh, kh, vh, gh = r(q), r(k), r(v), r(g)
    s = jax.lax.dot_general(                                 # :69-71
        qh, kh, (((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.float32) * scale
    m = jnp.max(s, axis=-1, keepdims=True)                   # :72-74
    e = jnp.exp(s - m)
    p = e / jnp.sum(e, axis=-1, keepdims=True)
    dp = jax.lax.dot_general(                                # :75-77
        gh, vh, (((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.float32)
    ds = p * (dp - jnp.sum(dp * p, axis=-1, keepdims=True))  # :78
    ds_c = ds.astype(k.dtype)                                # :79-80
    p_c = p.astype(g.dtype)
    dq = jax.lax.dot_general(                                # :81-89
        ds_c, kh, (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32) * scale
    dk = jax.lax.dot_general(
        ds_c, qh, (((1,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32) * scale
    dv = jax.lax.dot_general(
        p_c, gh, (((1,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32)
    return jnp.concatenate([un(dq), un(dk), un(dv)],         # :90-93
                           axis=-1).astype(q.dtype)


def _fwd_pairs(q, k, v, d):
    """``fwd_pairs`` of tools/bench_attn7.py:95-113 on one image."""
    scale = d ** -0.5
    outs = []
    for hp in range(HEADS // 2):                             # :98-112
        s0 = slice(hp * 2 * d, hp * 2 * d + d)
        s1 = slice(hp * 2 * d + d, (hp + 1) * 2 * d)
        r = lambda x: jnp.stack([x[:, s0], x[:, s1]], axis=0)  # noqa: E731
        qh, kh, vh = r(q), r(k), r(v)
        s = jax.lax.dot_general(
            qh, kh, (((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.float32) * scale
        m = jnp.max(s, axis=-1, keepdims=True)
        e = jnp.exp(s - m)
        p = e / jnp.sum(e, axis=-1, keepdims=True)
        o = jax.lax.dot_general(
            p.astype(v.dtype), vh, (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32)
        outs.append(jnp.concatenate([o[0], o[1]], axis=-1))
    return jnp.concatenate(outs, axis=-1).astype(q.dtype)   # :113


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,d", SHAPES)
@pytest.mark.parametrize("variant", ["batched", "pairs"])
def test_s3_forward_matches_the_study(variant, b, n, d, dtype):
    """S3's ``batched`` (the ``loop`` tile) and ``pairs`` (two heads staged
    together) against the study's batched and 128-lane-pair bodies."""
    x, _ = _inputs(b, n, d, dtype)
    got = study.slab_attention_tile_forward(
        _torch(x, dtype), HEADS, study.STUDY_TILES["S3"][variant])
    body = _fwd_batched if variant == "batched" else _fwd_pairs
    want = _per_image(lambda q, k, v: body(q, k, v, d),
                      jnp.asarray(x).astype(dtype))
    _close(got, _np(want), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,d", SHAPES)
@pytest.mark.parametrize("variant", ["batched", "loop-i2"])
def test_s3_backward_matches_bwd_batched(variant, b, n, d, dtype):
    """S3's backward tiles (``batched`` = ``loop``; ``loop-i2``, two images
    a block) against the study's ``bwd_batched`` body."""
    x, g = _inputs(b, n, d, dtype)
    got = study.slab_attention_tile_backward(
        _torch(x, dtype), _torch(g, dtype), HEADS,
        study.STUDY_TILES["S3"][variant])
    want = _per_image(lambda q, k, v, gg: _bwd_batched(q, k, v, gg, d),
                      jnp.asarray(x).astype(dtype),
                      jnp.asarray(g).astype(dtype))
    _close(got, _np(want), dtype)


# --- the tiles as data ------------------------------------------------------

def _tpu_tool(name):
    return (ROOT / "tools" / name).read_text()


def test_study_tiles_cover_every_key_of_the_tpu_tools():
    """The keys each TPU tool sweeps, read from its source, are the keys of
    ``STUDY_TILES``; the keys it times a backward for, those of
    ``STUDY_BACKWARD``."""
    s1 = re.search(r"for block_b in \(([\d, ]+)\)", _tpu_tool("bench_attn4.py"))
    assert set(study.STUDY_TILES["S1"]) == {int(v) for v in
                                            s1.group(1).split(",")}
    assert "itertools.product((False, True), repeat=2)" in _tpu_tool(
        "bench_attn6.py")
    assert set(study.STUDY_TILES["S2"]) == set(
        itertools.product((False, True), repeat=2))
    s3 = _tpu_tool("bench_attn7.py")
    block = s3[s3.index("variants = {"):s3.index("}", s3.index("variants = {"))]
    keys = re.findall(r'^\s*"([\w-]+)":\s*\((.*)$', block, re.M)
    assert set(study.STUDY_TILES["S3"]) == {k for k, _ in keys}
    # pairs is the one variant whose backward is None (:195)
    assert "pairs" not in study.STUDY_BACKWARD["S3"]
    assert set(study.STUDY_BACKWARD["S3"]) == {k for k, _ in keys} - {"pairs"}
    s4 = re.search(r'sys\.argv\[1:\] or \[([^\]]+)\]', _tpu_tool(
        "bench_attn8.py"))
    splits = {int(v.strip(' "')) for v in s4.group(1).split(",")}
    assert set(study.STUDY_TILES["S4"]) == splits == set(
        study.STUDY_BACKWARD["S4"])


def test_shared_configurations_are_one_tile():
    t = study.STUDY_TILES
    assert t["S1"][1] == t["S3"]["loop"] == t["S3"]["batched"] == t["S4"][1]
    assert t["S1"][2] == t["S3"]["loop-i2"]
    assert set(t["S2"].values()) == {study.SHIPPED_TILE}
    assert len(study.FWD_TILES) == 6 and len(study.BWD_TILES) == 4


@pytest.mark.parametrize("tile", study.FWD_TILES, ids=_key)
def test_tile_smem_fits_an_h100_block_at_vit_l(tile):
    """At N 197, D 64 (208 staged rows at a pitch of 72 bf16) a stage of K
    and V of one head is 59,904 bytes, the backward's pass-2 stage 62,400;
    each tile adds its 9,216-byte output area and fits 232,448 bytes."""
    fwd = study.tile_smem_bytes(tile, 197, 64, False)
    assert fwd == tile.stages * tile.staged * 59904 + 9216 <= H100_SMEM
    if tile in study.BWD_TILES:
        bwd = study.tile_smem_bytes(tile, 197, 64, True)
        assert bwd == tile.stages * 62400 + 9216 <= H100_SMEM


def test_tile_past_shared_memory_raises():
    """Two stages of K_h and V_h fit at N 257 and not at N 577: the check the
    wrappers make before a launch raises there (the limit read from a card
    here stands in for a real one)."""
    lib = types.SimpleNamespace(tic_max_smem_optin=lambda device: H100_SMEM)
    study._check_tile_smem("t", lib, study.LOOP_TILE, 257, 64, True, 0)
    with pytest.raises(ValueError, match="shared memory"):
        study._check_tile_smem("t", lib, study.LOOP_TILE, 577, 64, False, 0)
    with pytest.raises(ValueError, match="shared memory"):
        study._check_tile_smem("t", lib, study.STUDY_TILES["S3"]["pairs"],
                               577, 64, False, 0)


def test_tile_grids_at_vit_l():
    """Blocks a launch at B 64, N 197, H 16: one an image for ``loop``, 32
    and 16 for 2 and 4 images, S x B for the splits, K1's own grid for the
    shipped tile; B 3 leaves a ragged last block of 2 and 4 images."""
    grid = lambda tile, b=64: study.tile_grid(tile, b, 197, 16)  # noqa: E731
    t = study.STUDY_TILES
    assert grid(t["S1"][1]) == (1, 1, 64)
    assert grid(t["S1"][2]) == (1, 1, 32) and grid(t["S1"][4]) == (1, 1, 16)
    assert grid(t["S4"][2]) == (1, 2, 64) and grid(t["S4"][4]) == (1, 4, 64)
    assert grid(study.SHIPPED_TILE) == (4, 16, 64)
    assert grid(t["S1"][2], 3) == (1, 1, 2) and grid(t["S1"][4], 3) == (
        1, 1, 1)


# --- the wrappers' contract ---------------------------------------------------

@pytest.mark.parametrize("tile,heads,backward", [
    (study.Tile(splits=3), 4, False),
    (study.Tile(splits=8), 4, False),
    (study.Tile(splits=4, staged=2), 4, False),
    (study.Tile(staged=2, stages=1), 16, True),
    (study.Tile(images=0), 16, False),
    (study.Tile(stages=3), 16, False),
])
def test_tile_the_kernels_do_not_take_raises(tile, heads, backward):
    """Heads a block that do not divide H or do not form whole staged
    groups, a backward that stages two heads, and tiles outside the
    kernels' range raise, on every device."""
    x = torch.zeros(1, 9, 3 * heads * 64, dtype=torch.bfloat16)
    g = x[..., :heads * 64]
    with pytest.raises(ValueError):
        if backward:
            study.slab_attention_tile_backward(x, g, heads, tile)
        else:
            study.slab_attention_tile_forward(x, heads, tile)
    with pytest.raises(TypeError):
        study.tile_heads((1, 1, 1, True, 2), heads)


@pytest.mark.parametrize("call", [
    lambda x, g: study.slab_attention_tile_forward(x, 2, study.LOOP_TILE),
    lambda x, g: study.slab_attention_tile_backward(x, g, 2, study.LOOP_TILE),
    lambda x, g: study.softmax_variant_forward(x, 2, True, True),
])
def test_f32_off_the_cpu_raises(call):
    """A float32 tensor off the CPU raises before any launch (the study
    kernels are bf16), shown on the meta device."""
    x = torch.empty(1, 9, 3 * 128, device="meta")
    g = torch.empty(1, 9, 128, device="meta")
    with pytest.raises(TypeError, match="bf16"):
        call(x, g)


@pytest.mark.parametrize("call", [
    lambda x, g: study.slab_attention_tile_forward(x, 2, study.LOOP_TILE),
    lambda x, g: study.slab_attention_tile_backward(x, g, 2, study.LOOP_TILE),
    lambda x, g: study.softmax_variant_forward(x, 2, False, True),
])
def test_study_kernels_take_head_dim_64_only(call):
    x = torch.empty(1, 9, 3 * 64, dtype=torch.bfloat16, device="meta")
    g = torch.empty(1, 9, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="head dim 64"):
        call(x, g)


def test_cpu_calls_count_no_launch():
    x = torch.from_numpy(_slab(2, 17, 64, 1, "bfloat16")).to(torch.bfloat16)
    g = x[..., :HEADS * 64].contiguous()
    study.reset_launches()
    for tile in study.FWD_TILES:
        study.slab_attention_tile_forward(x, HEADS, tile)
    for tile in study.BWD_TILES:
        study.slab_attention_tile_backward(x, g, HEADS, tile)
    for variant in study.SOFTMAX_VARIANTS:
        study.softmax_variant_forward(x, HEADS, *variant)
    counts = (study.tile_launches, study.tile_bwd_launches,
              study.softmax_launches)
    assert all(v == 0 for count in counts for v in count.values())
    assert set(study.tile_launches) == set(study.FWD_TILES)


def test_tile_tools_have_no_fallback():
    """No try/except and no environment switch in the study tools either."""
    for tool in (attn_tiles, bench_attn4, bench_attn6, bench_attn7,
                 bench_attn8):
        src = open(tool.__file__).read()
        assert "try:" not in src and "except" not in src
        assert "environ" not in src


@pytest.mark.parametrize("tool", [bench_attn4, bench_attn6, bench_attn7,
                                  bench_attn8])
def test_tool_without_gpu_exits_1(tool, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tool would measure")
    assert tool.main(["--batch", "2", "--reps", "1"]) == 1
    assert "needs an NVIDIA GPU" in capsys.readouterr().err


def test_tool_keys_are_the_tpu_studies():
    assert attn_tiles.KEY_NAMES == {"S1": "block_b",
                                    "S2": ("exp2", "post_mul"),
                                    "S3": "variant", "S4": "splits"}
    for tool, name in ((bench_attn4, "S1"), (bench_attn6, "S2"),
                       (bench_attn7, "S3"), (bench_attn8, "S4")):
        assert tool.STUDY == name


# --- the kernels, on a card -------------------------------------------------

@pytest.fixture
def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


def _gpu_slab(b=3, n=197, c=1024, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(b, n, 3 * c, generator=gen, device="cuda").to(
        torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [*study.FWD_TILES, study.SHIPPED_TILE],
                         ids=_key)
def test_tile_forward_kernel_is_k1_on_gpu(require_cuda, tile):
    """Each forward tile is K1's mma.sync kernel (S2's exp2 variant, K1's
    route before wgmma) bit for bit and within the bf16 bound of the plain
    version; the launch counts once."""
    qkv = _gpu_slab()
    before = study.tile_launches.get(tile, 0)
    got = study.slab_attention_tile_forward(qkv, 16, tile)
    assert study.tile_launches[tile] == before + 1
    assert torch.equal(got, study.softmax_variant_forward(qkv, 16, True, False))
    torch.testing.assert_close(
        got.float(), study.slab_attention_reference(qkv, 16).float(),
        atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [*study.BWD_TILES, study.SHIPPED_TILE],
                         ids=_key)
def test_tile_backward_kernel_is_k2_on_gpu(require_cuda, tile):
    """Each backward tile is K2's mma.sync kernel (S5's full peel, K2's route
    before wgmma) bit for bit and within the bf16 bound of the plain
    version."""
    qkv = _gpu_slab()
    g = _gpu_slab(seed=1)[..., :1024].contiguous()
    got = study.slab_attention_tile_backward(qkv, g, 16, tile)
    assert torch.equal(got, study.slab_attention_peel_backward(qkv, g, 16,
                                                               "full"))
    torch.testing.assert_close(
        got.float(),
        study.slab_attention_backward_reference(qkv, g, 16).float(),
        atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", study.SOFTMAX_VARIANTS,
                         ids=lambda v: f"exp2{v[0]}-postmul{v[1]}")
def test_softmax_variant_kernel_matches_plain_on_gpu(require_cuda, variant):
    """Each S2 variant within the bf16 bound of its plain version; exp2
    without post_mul is K1 bit for bit."""
    from touhouimageclassification_tpu_torch.ops import attention

    qkv = _gpu_slab()
    got = study.softmax_variant_forward(qkv, 16, *variant)
    torch.testing.assert_close(
        got.float(),
        study.softmax_variant_reference(qkv, 16, *variant).float(),
        atol=2e-2, rtol=2e-2)
    if variant == (True, False):
        assert torch.equal(got, attention.slab_attention_forward(qkv, 16))
