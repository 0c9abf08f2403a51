"""The LayerNorm kernel pair (``ops/layernorm.py``, kernels
``csrc/layernorm.cu``) against its plain version.

On the CPU, where the op is its plain version: the output and the
gradients of x, the scale and the bias are bit-equal to
``F.layer_norm(x.float(), ...).to(out_dtype)`` for bf16 and f32 in and out;
a CPU call moves no launch counter; the train step's graph credits the two
counters; a tensor on neither the CPU nor CUDA raises.

On the card (marked ``cuda``; the module imports nothing of JAX, so
``python -m pytest --noconftest tests/test_torch_layernorm.py -m cuda``
runs them there), at ViT-L's b256 rows (50,432 x 1024), its b8 rows
(1,576 x 1024), ViT-B's bucket-64 rows (12,608 x 768) and ragged tiny
widths: y, dx and the scale's and bias's gradients against the plain
version computed in float64 from the same inputs, within one rounding of
the output dtype plus the f32 arithmetic's noise (bounds below), bit-stable
from call to call; the f32-output variant of V-MoE's router; what the
kernels refuse; a ViT-L train step's 49 forward and 49 backward launches,
eager and on the replayed graph, with the same result; remat ``'full'``
and ``'dots'`` giving remat off's gradients.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from touhouimageclassification_tpu_torch.config import PRESETS, ViTConfig
from touhouimageclassification_tpu_torch.models.vit import ViT
from touhouimageclassification_tpu_torch.ops import layernorm
from touhouimageclassification_tpu_torch.train import step_graph
from touhouimageclassification_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
PAIRS = [(a, b) for a in DTYPES for b in DTYPES]


def _inputs(rows: int, width: int, dtype, device="cpu", seed=0,
            dy_dtype=None):
    """x with a row offset and spread, a scale near 1, a bias near 0 (f32
    leaves), and a gradient of y: all drawn on the host from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, width, generator=gen) * 1.5
         + torch.randn(rows, 1, generator=gen) * 3.0)
    w = 1.0 + 0.2 * torch.randn(width, generator=gen)
    b = 0.1 * torch.randn(width, generator=gen)
    dy = torch.randn(rows, width, generator=gen)
    return (x.to(dtype).to(device), w.to(device), b.to(device),
            dy.to(dy_dtype or dtype).to(device))


def _leaves(*tensors):
    return [t.detach().clone().requires_grad_(True) for t in tensors]


# ---------------------------------------------------------------------------
# the CPU: the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("in_key, out_key", PAIRS)
def test_the_cpu_path_is_the_cast_layer_norm_cast(in_key, out_key):
    x, w, b, dy = _inputs(6, 40, DTYPES[in_key], dy_dtype=DTYPES[out_key])
    got = _leaves(x, w, b)
    want = _leaves(x, w, b)
    y = layernorm.layer_norm(*got, 1e-6, DTYPES[out_key])
    ref = F.layer_norm(want[0].float(), (40,), want[1], want[2],
                       1e-6).to(DTYPES[out_key])
    assert y.dtype == DTYPES[out_key] and torch.equal(y, ref)
    y.backward(dy)
    ref.backward(dy)
    for a, r in zip(got, want):
        assert a.grad.dtype == r.grad.dtype and torch.equal(a.grad, r.grad)


def test_the_vit_layer_norm_module_takes_the_op():
    """The model's LayerNorm keeps the input dtype, or returns ``out_dtype``
    (V-MoE's router input), as the op computes it."""
    from touhouimageclassification_tpu_torch.models.vit import LayerNorm
    ln = LayerNorm(24, eps=1e-12)
    with torch.no_grad():
        ln.weight.normal_(1.0, 0.1)
        ln.bias.normal_(0.0, 0.1)
    x = _inputs(5, 24, torch.bfloat16)[0]
    for out_dtype in (None, torch.float32):
        y = ln(x, out_dtype=out_dtype)
        ref = layernorm.layer_norm_reference(x, ln.weight, ln.bias, 1e-12,
                                             out_dtype)
        assert y.dtype == (out_dtype or torch.bfloat16) and torch.equal(y, ref)


def test_a_cpu_call_moves_no_counter():
    before = (layernorm.launches, layernorm.bwd_launches)
    x, w, b, dy = _inputs(4, 16, torch.bfloat16)
    leaves = _leaves(x, w, b)
    layernorm.layer_norm(*leaves, 1e-6).backward(dy)
    with torch.no_grad():
        layernorm.layer_norm(x, w, b, 1e-6, torch.float32)
    assert (layernorm.launches, layernorm.bwd_launches) == before


def test_the_step_graph_credits_the_layernorm_counters():
    keys = set(step_graph.launch_counts())
    name = layernorm.__name__
    assert {(name, "launches"), (name, "bwd_launches")} <= keys
    assert layernorm in step_graph._COUNTED


def test_a_tensor_on_another_device_raises():
    """No fallback: a tensor on neither the CPU nor CUDA is refused."""
    x, w, b, _ = _inputs(2, 8, torch.float32)
    with pytest.raises(ValueError, match="cpu or cuda"):
        layernorm.layer_norm(x.to("meta"), w.to("meta"), b.to("meta"), 1e-6)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


# (rows, width, eps): ViT-L b256 and b8, ViT-B bucket 64, ragged widths
# (odd: the one-element route; 40 and 200: vectors with masked lanes; past
# 1024 the block's four warps share a row)
SHAPES = {"vitl_b256": (256 * 197, 1024, 1e-12),
          "vitl_b8": (8 * 197, 1024, 1e-12),
          "vitb_b64": (64 * 197, 768, 1e-12),
          "ragged_40": (37, 40, 1e-6),
          "ragged_200": (5, 200, 1e-6),
          "odd_13": (19, 13, 1e-6),
          "odd_1001": (3, 1001, 1e-5),
          "wide_1280": (11, 1280, 1e-6),
          "wide_odd_2051": (7, 2051, 1e-6),
          "widest": (9, 4096, 1e-6)}


def _reference64(x, w, b, dy, eps):
    """y, dx, dw, db of the plain version in float64 from the same inputs,
    and the sums over the rows of |dy| (1 + |xh|) and of |dy|: the scales of
    the f32 sums' errors (each term carries xh's error, a few ulps of
    1 + |xh| from the f32 statistics, and each addition rounds)."""
    x64, w64, b64 = _leaves(x.double(), w.double(), b.double())
    y = F.layer_norm(x64, (x.shape[-1],), w64, b64, eps)
    y.backward(dy.double())
    with torch.no_grad():
        mean = x64.mean(-1, keepdim=True)
        xh = (x64 - mean) / torch.sqrt(x64.var(-1, unbiased=False,
                                               keepdim=True) + eps)
        scale_w = (dy.double().abs() * (1 + xh.abs())).sum(0)
        scale_b = dy.double().abs().sum(0)
    return (y.detach(), x64.grad, w64.grad, b64.grad, scale_w, scale_b)


def _within(got, want, dtype, what):
    """|got - want| within one rounding to ``dtype`` of the float64 value
    (2^-8 of it in bf16, 2^-24 in f32) plus 1e-5 of the tensor's largest
    magnitude: the kernels' f32 statistics differ from exact ones by the
    order of their sums (about 1e-6 of a row's scale)."""
    half_ulp = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -24
    err = (got.double() - want).abs()
    bound = half_ulp * want.abs() + 1e-5 * want.abs().max()
    worst = (err - bound).max().item()
    assert worst <= 0, (what, err.max().item(), worst)


def _run_kernels(x, w, b, dy, eps, out_dtype):
    leaves = _leaves(x, w, b)
    y = layernorm.layer_norm(*leaves, eps, out_dtype)
    y.backward(dy)
    return y.detach(), *(t.grad for t in leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("in_key, out_key", PAIRS)
def test_the_kernels_match_the_plain_version(shape, in_key, out_key):
    dev = _cuda()
    rows, width, eps = SHAPES[shape]
    x, w, b, dy = _inputs(rows, width, DTYPES[in_key], dev, seed=rows,
                          dy_dtype=DTYPES[out_key])
    fwd, bwd = layernorm.launches, layernorm.bwd_launches
    y, dx, dw, db = _run_kernels(x, w, b, dy, eps, DTYPES[out_key])
    torch.cuda.synchronize()
    assert (layernorm.launches - fwd, layernorm.bwd_launches - bwd) == (1, 1)
    assert (y.dtype, dx.dtype, dw.dtype, db.dtype) == (
        DTYPES[out_key], DTYPES[in_key], torch.float32, torch.float32)
    ref_y, ref_dx, ref_dw, ref_db, scale_w, scale_b = _reference64(
        x, w, b, dy, eps)
    _within(y, ref_y, DTYPES[out_key], "y")
    _within(dx, ref_dx, DTYPES[in_key], "dx")
    # the scale's and bias's gradients: f32 sums over up to 50k rows, in
    # the kernels' fixed order, within 1e-5 of the sums' scales (about a
    # hundred sequential f32 additions a column)
    assert ((dw.double() - ref_dw).abs() <= 1e-5 * scale_w + 1e-30).all()
    assert ((db.double() - ref_db).abs() <= 1e-5 * scale_b + 1e-30).all()
    again = _run_kernels(x, w, b, dy, eps, DTYPES[out_key])
    assert all(torch.equal(a, r) for a, r in zip(again, (y, dx, dw, db)))


@pytest.mark.cuda
def test_the_f32_output_variant_is_the_routers_input():
    """V-MoE's second LayerNorm: a bf16 x, an f32 y for the router, an f32
    dy and a bf16 dx, as the model's ``ln2(x, out_dtype=float32)``."""
    from touhouimageclassification_tpu_torch.models.vit import LayerNorm
    dev = _cuda()
    rows, width, eps = 128 * 197, 1024, 1e-6
    x, w, b, dy = _inputs(rows, width, torch.bfloat16, dev, seed=5,
                          dy_dtype=torch.float32)
    ln = LayerNorm(width, eps=eps, device=dev)
    with torch.no_grad():
        ln.weight.copy_(w)
        ln.bias.copy_(b)
    xl = _leaves(x)[0]
    y = ln(xl, out_dtype=torch.float32)
    y.backward(dy)
    assert y.dtype == torch.float32 and xl.grad.dtype == torch.bfloat16
    ref_y, ref_dx, ref_dw, _, scale_w, _ = _reference64(x, w, b, dy, eps)
    _within(y.detach(), ref_y, torch.float32, "y")
    _within(xl.grad, ref_dx, torch.bfloat16, "dx")
    assert ((ln.weight.grad.double() - ref_dw).abs() <= 1e-5 * scale_w).all()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_a_call_without_autograd_is_the_forward_alone(mode):
    """The serving path: the same autograd function, one forward launch and
    the autograd call's y, under ``no_grad`` and ``inference_mode``."""
    dev = _cuda()
    x, w, b, dy = _inputs(64 * 197, 768, torch.bfloat16, dev, seed=7)
    want = _run_kernels(x, w, b, dy, 1e-12, torch.bfloat16)[0]
    fwd, bwd = layernorm.launches, layernorm.bwd_launches
    with getattr(torch, mode)():
        y = layernorm.layer_norm(x, w.requires_grad_(True), b, 1e-12)
    assert (layernorm.launches - fwd, layernorm.bwd_launches - bwd) == (1, 0)
    assert not y.requires_grad and torch.equal(y, want)


@pytest.mark.cuda
def test_what_the_kernels_refuse():
    dev = _cuda()
    x, w, b, _ = _inputs(4, 64, torch.bfloat16, dev)
    assert layernorm.load_library().tic_layernorm_max_width() == \
        layernorm.MAX_WIDTH
    wide = torch.zeros(2, layernorm.MAX_WIDTH + 1, device=dev)
    with pytest.raises(ValueError, match="widths"):
        layernorm.layer_norm(wide, torch.ones(wide.shape[-1], device=dev),
                             torch.zeros(wide.shape[-1], device=dev), 1e-6)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        layernorm.layer_norm(x.half(), w, b, 1e-6)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        layernorm.layer_norm(x, w, b, 1e-6, torch.float16)
    with pytest.raises(ValueError, match="float32 weight"):
        layernorm.layer_norm(x, w.bfloat16(), b, 1e-6)
    with pytest.raises(ValueError, match="bias"):
        layernorm.layer_norm(x, w, b[:32], 1e-6)


@pytest.mark.cuda
def test_a_strided_view_takes_the_contiguous_rows():
    """A view whose rows are not dense (every other column) is made
    contiguous and normalised as its copy is."""
    dev = _cuda()
    x, w, b, _ = _inputs(33, 256, torch.bfloat16, dev)
    view = x[:, ::2]
    with torch.no_grad():
        got = layernorm.layer_norm(view, w[:128], b[:128], 1e-6)
        want = layernorm.layer_norm(view.contiguous(), w[:128], b[:128], 1e-6)
    assert torch.equal(got, want)


VIT_L = ViTConfig(image_size=224, patch_size=16, hidden_size=1024,
                  num_layers=24, num_heads=16, mlp_dim=4096, num_classes=120,
                  attention_impl="fused", patch_embed_impl="xla")


def _state(trainer):
    return {k: v.detach().clone()
            for k, v in trainer.state.model.named_parameters()}


@pytest.mark.cuda
def test_a_vit_l_step_launches_49_pairs_eager_and_replayed(tmp_path):
    """Two layer norms in each of 24 layers and the final one: 49 forward
    and 49 backward launches a step, counted on the eager steps and
    credited on each replay (a capture runs none); the replayed steps end
    where the eager ones do."""
    dev = _cuda()
    rng = np.random.default_rng(0)
    host = [{"image": rng.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8),
             "label": rng.integers(0, 120, 2)} for _ in range(3)]
    runs = {}
    for graphed in (False, True):
        cfg = dataclasses.replace(PRESETS["nvit"], global_batch_size=2,
                                  seed=0,
                                  log_dir=str(tmp_path / str(graphed)))
        model = ViT(VIT_L, "bfloat16", dev, param_dtype="float32", seed=0)
        trainer = Trainer(cfg, model=model, device=dev)
        state = trainer.init_state()
        trainer._graphable = graphed
        fwd, bwd = layernorm.launches, layernorm.bwd_launches
        metrics = [trainer.train_step(state, trainer.stage(b)) for b in host]
        runs[graphed] = (metrics, _state(trainer), layernorm.launches - fwd,
                         layernorm.bwd_launches - bwd, trainer.graph_replays)
        del trainer, state, model
        torch.cuda.empty_cache()
    (m0, s0, f0, b0, r0), (m1, s1, f1, b1, r1) = runs[False], runs[True]
    assert (r0, r1) == (0, 2)
    assert f0 == b0 == f1 == b1 == 49 * len(host)
    assert m1 == m0 and all(torch.equal(s1[k], s0[k]) for k in s0)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [dict(remat=True),
                                    dict(remat=True, remat_policy="dots")],
                         ids=["full", "dots"])
def test_remat_gives_remat_offs_gradients(policy):
    """The layer norms recomputed in the backward (each layer's forward
    runs twice) write what the first forward wrote, so every gradient is
    remat off's, bit for bit."""
    dev = _cuda()
    base = ViTConfig(image_size=64, patch_size=16, hidden_size=256,
                     num_layers=3, num_heads=4, mlp_dim=512, num_classes=10,
                     attention_impl="fused", patch_embed_impl="xla")
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.randint(0, 256, (4, 64, 64, 3), device=dev, generator=gen)
    images = images.float() / 255.0
    grads, counts = [], []
    for config in (base, dataclasses.replace(base, **policy)):
        model = ViT(config, "bfloat16", dev, param_dtype="float32", seed=3)
        model.train()
        fwd, bwd = layernorm.launches, layernorm.bwd_launches
        model(images).float().square().mean().backward()
        counts.append((layernorm.launches - fwd, layernorm.bwd_launches - bwd))
        grads.append({k: p.grad for k, p in model.named_parameters()})
    assert counts[0] == (7, 7) and counts[1] == (7 + 6, 7)
    assert all(torch.equal(grads[1][k], grads[0][k]) for k in grads[0])
