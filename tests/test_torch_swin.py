"""SwinV2 on the port (``models/swin.py``, ``ops/window_attention.py``)
against the plain float32 reference of the benchmark
(``benchmark/reference/swinv2_plain.py`` and ``train_swin_plain.py``), at a
tiny size: embed 32, depths [2, 2, 2, 2], heads [2, 4, 8, 16], window 4
at 64, so that stages 1 and 2 shift their odd block, stage 3's window is
its map and stage 4's is clipped to its 2 x 2 map; pretrained windows 3,
3, 2 and none, so that the position bias's coordinates are scaled.

The program and the reference both compute in float32 and differ only in
the order of their sums (one roll and partition against the official
helpers, the bias's sigmoid before its gather, a merged (window, head)
layout), so logits, losses and gradients are held to 1e-5 relative to the
largest entry, as the V-MoE tests hold theirs.

On the card (marked ``cuda``; the module imports nothing of JAX, so
``python -m pytest --noconftest tests/test_torch_swin.py -m cuda``): the
window attention's kernel pair (W1) against its plain form in float32
arithmetic on the same bf16 inputs, at SwinV2-L's stage shapes and the tiny
config's D 16, with and without the shift mask, tau about its initial ln 10
and at the clamp, forward and backward; two backward calls bit-equal; a
tiny model's step captured and replayed, bit-equal to eager steps.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from benchmark.compare import moved_leaves
from benchmark.reference import train_swin_plain
from benchmark.reference.swinv2_plain import PlainSwinV2
from benchmark.reference.train_plain import part_norms
from touhouimageclassification_tpu_torch.config import (PRESETS, SWINV2_LARGE,
                                                        SwinV2Config,
                                                        get_image_size)
from touhouimageclassification_tpu_torch.infer.serve import build_predictor
from touhouimageclassification_tpu_torch.models import (create_model,
                                                        input_size,
                                                        model_config_key)
from touhouimageclassification_tpu_torch.models import swin
from touhouimageclassification_tpu_torch.models.swin import SwinV2
from touhouimageclassification_tpu_torch.ops import window_attention as wa
from touhouimageclassification_tpu_torch.train.checkpoint import (
    SERVING_META, SERVING_PARAMS, save_params)
from touhouimageclassification_tpu_torch.train.trainer import Trainer
from touhouimageclassification_tpu_torch.utils import profiling

torch.set_num_threads(1)

RTOL = 1e-5
CFG = SwinV2Config(image_size=64, embed_dim=32, depths=(2, 2, 2, 2),
                   num_heads=(2, 4, 8, 16), window_size=4,
                   pretrained_window_sizes=(3, 3, 2, 0), num_classes=5)
SHAPE = {"image": 64, "patch": 4, "embed": 32, "depths": (2, 2, 2, 2),
         "heads": (2, 4, 8, 16), "window": 4, "pretrained": (3, 3, 2, 0),
         "mlp_ratio": 4, "classes": 5, "eps": CFG.layer_norm_eps}


def _model(seed=3, cfg=CFG) -> SwinV2:
    """A float32 model whose biases, q and v biases and tau are drawn too,
    so that they count."""
    model = SwinV2(cfg, "float32", "cpu", "float32", seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("bias", "logit_scale")):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def _close(a, b, rtol=RTOL):
    a, b = a.detach(), b.detach()
    scale = max(float(b.abs().max()), 1e-30)
    assert float((a - b).abs().max()) <= rtol * scale


def _images(n=3, seed=0):
    return torch.randn(n, 64, 64, 3, generator=torch.Generator()
                       .manual_seed(seed))


def test_logits_and_every_gradient_match_the_reference():
    model = _model()
    images = _images()
    soft = torch.softmax(torch.randn(3, 5, generator=torch.Generator()
                                     .manual_seed(1)), -1)
    logits = model(images)
    (-(soft * torch.log_softmax(logits, -1)).sum(-1).mean()).backward()
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in model.state_dict().items()}
    ref_logits = PlainSwinV2(params, SHAPE).logits(images)
    (-(soft * torch.log_softmax(ref_logits, -1)).sum(-1).mean()).backward()
    _close(logits, ref_logits)
    grads = dict(model.named_parameters())
    assert set(grads) == set(params)
    for name, p in grads.items():
        _close(p.grad, params[name].grad)
    # the position bias, tau and the shifted blocks' weights all learn
    for name in ("layers.0.blocks.1.attn.cpb_mlp.0.weight",
                 "layers.3.blocks.0.attn.logit_scale",
                 "layers.1.blocks.1.attn.qkv.weight"):
        assert float(grads[name].grad.abs().sum()) > 0


@pytest.mark.parametrize("fault", [{"shift": False}, {"bias": False}])
def test_the_reference_faults_change_the_logits(fault):
    """What the benchmark's faults leave out moves the logits far beyond
    the tolerance the program is held to."""
    params = _model().state_dict()
    images = _images()
    sound = PlainSwinV2(params, SHAPE).logits(images)
    faulted = PlainSwinV2(params, SHAPE, **fault).logits(images)
    assert float((sound - faulted).abs().max()) > 100 * RTOL * float(
        sound.abs().max())


def test_three_trainer_steps_match_the_reference_steps(tmp_path):
    """``Trainer.train_step`` on the ``nvit`` preset against
    ``train_swin_plain.train_steps`` from the same weights and batches."""
    cfg = dataclasses.replace(PRESETS["nvit"], global_batch_size=4, seed=9,
                              log_dir=str(tmp_path / "log"))
    model = _model()
    w0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    trainer = Trainer(cfg, model=model, device="cpu")
    assert trainer.out_size == (64, 64)
    state = trainer.init_state()
    rng = np.random.default_rng(0)
    batches = [{"image": rng.integers(0, 256, (4, 72, 72, 3), np.uint8),
                "label": rng.integers(0, 5, 4)} for _ in range(3)]
    losses = [trainer.train_step(state, trainer.stage(b))["loss"]
              for b in batches]
    ref = train_swin_plain.train_steps(
        w0, SHAPE, cfg.seed,
        [(torch.from_numpy(b["image"]), torch.from_numpy(b["label"]))
         for b in batches], cfg.optimizer.learning_rate,
        cfg.optimizer.weight_decay, block=2)
    assert losses == pytest.approx(ref["loss"], rel=RTOL)
    delta = part_norms({name: p.detach() - w0[name]
                        for name, p in model.named_parameters()})
    assert delta.keys() == ref["delta"].keys()
    moved = moved_leaves(ref["grad1"])
    for name, value in delta.items():
        if moved(name):
            assert value == pytest.approx(ref["delta"][name], rel=1e-3), name


def test_a_predictor_serves_an_export(tmp_path):
    """An export as ``--transform`` writes it (the params and the meta with
    the model's config under ``swin_config``) serves in bf16 the classes
    the float32 model gives."""
    model = _model()
    assert model_config_key(model) == "swin_config"
    export = tmp_path / "export"
    export.mkdir()
    save_params(str(export / SERVING_PARAMS), model.state_dict())
    classes = [f"c{i}" for i in range(5)]
    with open(export / SERVING_META, "w") as f:
        json.dump({"model_type": "swinv2-large-w24-384", "epoch": 1,
                   "mean": [0.5] * 3, "std": [0.25] * 3,
                   "swin_config": dataclasses.asdict(CFG),
                   "class_to_idx": {c: i for i, c in enumerate(classes)}}, f)
    predictor = build_predictor(modelt="swinv2-large-w24-384",
                                weights=str(export), device="cpu")
    assert isinstance(predictor.model, SwinV2)
    assert predictor.model.cfg == CFG and predictor.image_size == (64, 64)
    assert not predictor.model.training
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (3, 64, 64, 3), np.uint8)
    pred, conf = predictor.predict_array(images)
    x = (torch.from_numpy(images).float() / 255.0 - 0.5) / 0.25
    with torch.no_grad():
        probs = torch.softmax(model.eval()(x), -1)
    assert pred.shape == (3,) and np.isfinite(conf).all()
    # bf16 may swap classes whose float32 probabilities are close: the
    # served class is within bf16's reach of the best, and its confidence
    # is its float32 probability
    served = probs[torch.arange(3), torch.from_numpy(pred)].numpy()
    assert (probs.max(-1).values.numpy() - served <= 0.05).all()
    assert np.allclose(conf, served, atol=0.05)


def test_create_model_builds_the_published_swinv2_large():
    model = create_model("swinv2-large-w24-384", num_classes=120,
                         param_dtype="float32")
    cfg = model.cfg
    assert (cfg.image_size, cfg.patch_size, cfg.embed_dim, cfg.window_size) \
        == (384, 4, 192, 24)
    assert cfg == dataclasses.replace(SWINV2_LARGE, num_classes=120)
    assert (cfg.depths, cfg.num_heads, cfg.pretrained_window_sizes) == (
        (2, 2, 18, 2), (6, 12, 24, 48), (12, 12, 12, 6))
    # the stages' maps, windows and shifts: shifted 24² windows in stages
    # 1 and 2, one window in stage 3, stage 4's clipped to its 12² map
    assert [(b.resolution, b.window, b.shift) for s in model.layers
            for b in s.blocks[:2]] == [(96, 24, 0), (96, 24, 12),
                                       (48, 24, 0), (48, 24, 12),
                                       (24, 24, 0), (24, 24, 0),
                                       (12, 12, 0), (12, 12, 0)]
    assert sum(len(s.blocks) for s in model.layers) == 24
    assert sum(p.numel() for p in model.parameters()) == 195_387_372
    assert [s.blocks[0].attn.heads * 32 for s in model.layers] == [
        192, 384, 768, 1536]
    assert input_size(model) == (384, 384)
    assert get_image_size("swinv2-large-w24-384") == (384, 384)


def test_an_export_meta_gives_the_config_back():
    """The meta's lists come back as the config's tuples."""
    fields = json.loads(json.dumps(dataclasses.asdict(CFG)))
    assert SwinV2Config(**fields) == CFG
    with pytest.raises(ValueError, match="one entry a stage"):
        SwinV2Config(depths=(2, 2), num_heads=(6, 12, 24, 48))


# ---------------------------------------------------------------------------
# the stages' geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("resolution,window,expected",
                         [(96, 24, (24, 12)), (48, 24, (24, 12)),
                          (24, 24, (24, 0)), (12, 24, (12, 0)),
                          (16, 4, (4, 2)), (4, 4, (4, 0)), (2, 4, (2, 0))])
def test_no_shift_where_the_window_covers_the_map(resolution, window,
                                                  expected):
    assert swin.window_and_shift(resolution, window) == expected


@pytest.mark.parametrize("resolution,window", [(16, 4), (8, 4), (12, 4)])
def test_the_shift_mask_against_an_independent_construction(resolution,
                                                            window):
    """Token (r, c) of the rolled map lies in region (r >= R - M) + (r >=
    R - M/2) by rows, the same by columns; query and key are masked where
    their regions differ."""
    shift = window // 2
    mask = swin.shift_mask(resolution, window, shift)
    g = resolution // window

    def region(x):
        return int(x >= resolution - window) + int(x >= resolution - shift)

    expected = torch.zeros_like(mask)
    for w in range(g * g):
        cells = [(w // g * window + i // window, w % g * window + i % window)
                 for i in range(window * window)]
        labels = [(region(r), region(c)) for r, c in cells]
        for i, a in enumerate(labels):
            for j, b in enumerate(labels):
                expected[w, i, j] = a != b
    assert torch.equal(mask, expected)
    # only the windows on the last row or column mix regions
    mixed = {w for w in range(g * g) if bool(mask[w].any())}
    assert mixed == {w for w in range(g * g)
                     if w // g == g - 1 or w % g == g - 1}


@pytest.mark.parametrize("window,pretrained", [(24, 12), (12, 6), (4, 3),
                                               (2, 0)])
def test_the_position_bias_table_against_its_closed_form(window, pretrained):
    """Row (a + M - 1)(2M - 1) + (b + M - 1) of the table holds f(8 a /
    (P - 1)), f(8 b / (P - 1)) with f(t) = sign(t) log2(1 + |t|) / 3; the
    index of query (i1, j1) and key (i2, j2) is the row of (i1 - i2,
    j1 - j2)."""
    coords = swin.cpb_coords(window, pretrained)
    index = swin.relative_position_index(window)
    p = (pretrained or window) - 1

    def f(t):
        t = 8.0 * t / p
        return math.copysign(math.log2(1 + abs(t)) / 3, t) if t else 0.0

    span = 2 * window - 1
    assert coords.shape == (span * span, 2)
    for a in range(-(window - 1), window):
        for b in range(-(window - 1), window):
            row = (a + window - 1) * span + (b + window - 1)
            assert coords[row].tolist() == pytest.approx([f(a), f(b)],
                                                         rel=1e-6, abs=1e-7)
    n = window * window
    rows, cols = torch.meshgrid(torch.arange(n), torch.arange(n),
                                indexing="ij")
    di = rows // window - cols // window
    dj = rows % window - cols % window
    assert torch.equal(index.view(n, n),
                       (di + window - 1) * span + dj + window - 1)


def test_partition_and_reverse_invert_each_other():
    x = torch.arange(2 * 64 * 3, dtype=torch.float32).view(2, 64, 3)
    for shift in (0, 2):
        w = swin.partition(x, 8, 4, shift)
        assert w.shape == (2 * 4, 16, 3)
        assert torch.equal(swin.reverse(w, 8, 4, shift), x)
    # window 1 of the unshifted map holds rows 0-3, columns 4-7
    w = swin.partition(x, 8, 4, 0)
    assert w[1, :, 0].tolist() == [x[0, r * 8 + c, 0].item()
                                   for r in range(4) for c in range(4, 8)]


# ---------------------------------------------------------------------------
# the window attention
# ---------------------------------------------------------------------------

def _attention_inputs(images=2, windows=4, h=3, n=16, d=8, seed=0,
                      masked=False, dtype=torch.float32, device="cpu"):
    """A (B nW, N, 3C) slab, tau (every third head's above ln 100) and a
    bias, with a random shift-like mask per window index."""
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(images * windows, n, 3 * h * d, generator=gen)
    tau = torch.log(torch.tensor([8.0, 30.0, 200.0]).repeat(h)[:h]).view(
        h, 1, 1)
    bias = 16 * torch.rand(1, h, n, n, generator=gen)
    if masked:
        mask = torch.rand(windows, 1, n, n, generator=gen) < 0.3
        bias = bias + swin.MASK_VALUE * mask
    return qkv.to(device, dtype), tau.to(device), bias.to(device)


def _plain_attention(qkv, tau, bias):
    """Window by window and head by head, in float64."""
    rows, n, c3 = qkv.shape
    h = tau.shape[0]
    d = c3 // 3 // h
    x = qkv.double().view(rows, n, 3, h, d)
    out = torch.empty(rows, n, h, d, dtype=torch.float64)
    for r in range(rows):
        for j in range(h):
            q, k, v = x[r, :, 0, j], x[r, :, 1, j], x[r, :, 2, j]
            qn = q / q.norm(dim=-1, keepdim=True)
            kn = k / k.norm(dim=-1, keepdim=True)
            scale = math.exp(min(float(tau[j]), math.log(100)))
            s = qn @ kn.t() * scale + bias[r % bias.shape[0], j].double()
            out[r, :, j] = torch.softmax(s, -1) @ v
    return out.view(rows, n, h * d)


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_against_its_plain_form(masked):
    qkv, tau, bias = _attention_inputs(masked=masked)
    out = wa.window_attention(qkv, tau, bias)
    _close(out, _plain_attention(qkv, tau, bias).float())
    _close(out, wa.window_attention_reference(qkv, tau, bias))
    # tau above ln 100 is clamped: the third head's scale is 100
    assert float(tau[2]) > wa.LOGIT_SCALE_MAX


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_gradients_against_the_plain_form(masked):
    """The slab's, tau's and the bias's gradients, through the written-out
    backward of the normalisation, against autograd through
    ``F.normalize``."""
    ins = _attention_inputs(masked=masked)
    dout = torch.randn(ins[0].shape[0], 16, 24,
                       generator=torch.Generator().manual_seed(5))
    grads = []
    for fn in (wa.window_attention, wa.window_attention_reference):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        fn(*leaves).backward(dout)
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        _close(got, want)
    # the clamped head's tau takes no gradient, the others do
    assert float(grads[0][1][2].abs()) == 0
    assert float(grads[0][1][:2].abs().min()) > 0


def test_the_normalisation_backward_by_gradcheck():
    qkv, tau, _ = _attention_inputs(1, 2, 3, 4, 4)
    qkv = qkv.double().requires_grad_(True)
    tau = tau.double().requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, b: wa._ScaledCosineQKV.apply(a, b, 3), (qkv, tau))


def test_window_attention_refuses_a_bias_of_another_shape():
    qkv, tau, bias = _attention_inputs()
    with pytest.raises(ValueError, match="do not fit"):
        wa.window_attention(qkv, tau, bias[:, :2])
    with pytest.raises(ValueError, match="do not fit"):
        wa.window_attention(qkv, tau, bias.expand(3, -1, -1, -1))


def test_a_profiled_step_records_the_swin_spans_with_their_counts(tmp_path):
    cfg = dataclasses.replace(PRESETS["nvit"], global_batch_size=2,
                              log_dir=str(tmp_path / "log"))
    trainer = Trainer(cfg, model=_model(), device="cpu")
    state = trainer.init_state()
    batch = {"image": np.full((2, 72, 72, 3), 99, np.uint8),
             "label": np.arange(2)}
    profiling.clear()
    with profiling.trace(str(tmp_path / "trace")):
        trainer.train_step(state, trainer.stage(batch))
    spans = profiling.recorded()
    profiling.clear()
    names = [(s["name"], s["counts"].get("backward", 0)) for s in spans]
    for backward in (0, 1):
        assert names.count(("swin.attention", backward)) == 8
        assert names.count(("swin.bias", backward)) == 8
        # stages 1 and 2 move their tokens twice a block, stages 3 and 4
        # hold one unshifted window
        assert names.count(("swin.shift", backward)) == 8
        assert names.count(("swin.merge", backward)) == 3
    attention = [s["counts"] for s in spans if s["name"] == "swin.attention"
                 and not s["counts"].get("backward")]
    assert [(c["windows"], c["tokens"] // c["windows"], c["heads"],
             c["bias_windows"]) for c in attention] == [
        (32, 16, 2, 1), (32, 16, 2, 16), (8, 16, 4, 1), (8, 16, 4, 4),
        (2, 16, 8, 1), (2, 16, 8, 1), (2, 4, 16, 1), (2, 4, 16, 1)]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


# (images, windows, heads, N, D) of the card tests: SwinV2-L's stage 1 (16
# windows of 576 tokens, 6 heads of 32), stage 3 (one window, 24 heads),
# stage 4 (N 144, 48 heads), and the tiny config's stage 1 (D 16); with
# ``masked`` the bias is one per window, as a shifted block's
CARD_SHAPES = {"stage1": (2, 16, 6, 576, 32), "stage3": (3, 1, 24, 576, 32),
               "stage4": (4, 1, 48, 144, 32), "tiny": (2, 16, 2, 16, 16)}


def _card_inputs(shape, masked, tau0, dev):
    """bf16 slab and bias on the card and an f32 tau of 0.2 standard
    deviations about ``tau0``, each a leaf that takes a gradient."""
    images, windows, heads, n, d = CARD_SHAPES[shape]
    qkv, _, bias = _attention_inputs(images, windows, heads, n, d,
                                     masked=masked, dtype=torch.bfloat16,
                                     device=dev)
    tau = tau0 + 0.2 * torch.randn(
        heads, 1, 1, generator=torch.Generator().manual_seed(3)).to(dev)
    return [t.to(dt).requires_grad_(True) for t, dt in (
        (qkv, torch.bfloat16), (tau, torch.float32), (bias, torch.bfloat16))]


@pytest.mark.cuda
@pytest.mark.parametrize("tau0", [swin.LOGIT_SCALE_INIT, wa.LOGIT_SCALE_MAX],
                         ids=["tau-ln10", "tau-clamp"])
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_on_the_card_against_its_plain_form(masked, shape,
                                                             tau0):
    """W1 on bf16 operands: the output and the slab's, tau's and the
    bias's gradients within bf16's rounding of the float32 plain form on
    the same operands. The head's scale multiplies the f32 scores after
    the product, so tau at the clamp's 100 holds to the tolerance of tau
    about ln 10; the clamped heads' tau takes no gradient."""
    dev = _cuda()
    leaves = _card_inputs(shape, masked, tau0, dev)
    before = (wa.launches, wa.bwd_launches)
    out = wa.window_attention(*leaves)
    dout = torch.randn(out.shape, generator=torch.Generator(dev)
                       .manual_seed(4), device=dev).to(out.dtype)
    out.backward(dout)
    assert (wa.launches, wa.bwd_launches) == (before[0] + 1, before[1] + 1)
    ref_in = [t.detach().float().requires_grad_(True) for t in leaves]
    ref = wa.window_attention_reference(*ref_in)
    ref.backward(dout.float())
    gaps = {name: float((got.detach().float() - want).abs().max()
                        / want.abs().max().clamp_min(1e-30))
            for name, got, want in zip(
                ("out", "qkv", "tau", "bias"),
                (out,) + tuple(t.grad for t in leaves),
                (ref,) + tuple(t.grad for t in ref_in))}
    assert max(gaps.values()) <= 3e-2, gaps
    clamped = (leaves[1] > wa.LOGIT_SCALE_MAX).flatten()
    assert bool((leaves[1].grad.flatten()[clamped] == 0).all())
    assert bool((leaves[1].grad.flatten()[~clamped] != 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["stage1", "stage4"])
def test_two_window_attention_backward_calls_are_bit_equal(shape):
    """W1's backward sums in a fixed order, with no float atomics."""
    dev = _cuda()
    leaves = _card_inputs(shape, True, swin.LOGIT_SCALE_INIT, dev)
    with torch.no_grad():
        saved = wa.window_attention_forward(*leaves)
    dout = torch.randn(saved[0].shape, generator=torch.Generator(dev)
                       .manual_seed(4), device=dev).to(saved[0].dtype)
    first, second = (wa.window_attention_backward(*leaves, *saved, dout)
                     for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_window_attention_on_the_card_refuses_what_w1_does_not_take():
    """Another dtype, head dim or N raises; there is no fallback."""
    dev = _cuda()
    qkv, tau, bias = _card_inputs("tiny", False, swin.LOGIT_SCALE_INIT, dev)
    with pytest.raises(ValueError, match="bfloat16"):
        wa.window_attention(qkv.float(), tau, bias.float())
    wide = torch.zeros(2, 16, 3 * 2 * 64, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="heads of"):
        wa.window_attention(wide, tau, bias)
    n = wa.MAX_TOKENS + 1
    long = torch.zeros(1, n, 3 * 2 * 16, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="tokens"):
        wa.window_attention(long, tau, torch.zeros(
            1, 2, n, n, dtype=torch.bfloat16, device=dev))


@pytest.mark.cuda
def test_a_tiny_swin_step_replays_its_graph_on_the_card(tmp_path):
    """The tiny model's steps (W1 at D 16) captured and replayed equal
    eager steps bit for bit, but for the position-bias MLP: its gradient
    comes through ``index_select``'s backward, whose atomic adds differ
    between two eager runs too. Each replay credits W1's launches, and a
    profiled replay records the attention spans of its capture."""
    dev = _cuda()
    rng = np.random.default_rng(0)
    batches = [{"image": rng.integers(0, 256, (4, 72, 72, 3), np.uint8),
                "label": rng.integers(0, 5, 4)} for _ in range(4)]
    runs = []
    for graphed in (False, True):
        cfg = dataclasses.replace(PRESETS["nvit"], global_batch_size=4,
                                  log_dir=str(tmp_path / str(graphed)))
        model = SwinV2(CFG, "bfloat16", dev, "float32", seed=3)
        trainer = Trainer(cfg, model=model, device=dev)
        state = trainer.init_state()
        trainer._graphable = graphed
        before = (wa.launches, wa.bwd_launches)
        losses = [trainer.train_step(state, trainer.stage(b))["loss"]
                  for b in batches]
        assert all(math.isfinite(x) for x in losses)
        # eight attention calls a step, forward and backward, credited on
        # the replays
        assert (wa.launches - before[0], wa.bwd_launches - before[1]) == (
            8 * 4, 8 * 4)
        runs.append((losses, {k: v.detach().clone() for k, v in
                              model.state_dict().items()}))
    # the first step warms the shapes, the second captures and replays
    assert (trainer.graph_captures, trainer.graph_fallbacks,
            trainer.graph_replays) == (1, 0, 3)
    assert runs[0][0] == runs[1][0]
    differ = [k for k in runs[0][1] if ".cpb_mlp." not in k
              and not torch.equal(runs[0][1][k], runs[1][1][k])]
    assert not differ, differ
    profiling.clear()
    with profiling.trace(str(tmp_path / "trace")):
        trainer.train_step(state, trainer.stage(batches[0]))
    spans = profiling.recorded()
    profiling.clear()
    graph = [s for s in spans if s["name"] == "swin.attention"]
    assert len(graph) == 16 and all(s["device_ms"] > 0 for s in graph)
