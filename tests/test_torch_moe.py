"""The port's mixture families against the JAX package's, on the CPU.

- ``ops/moe_dispatch.py``: the plan's integer arrays equal JAX's exactly
  over several (B, K, E, capacity factor), with and without drops;
  ``dispatch`` / ``combine`` / ``kept_mass`` within 1e-6 (f32 sums of at
  most K terms);
- the losses (symmetric CE, the quadratic and switch balance losses, their
  sum) within 1e-6, and the switch loss's gradient;
- ResMoE dense, sparse-feature and sparse-image forwards against JAX's
  ``MoEClassifier.apply`` on weights carried across by ``from_jax_params``,
  for both balance losses: logits within 1e-5 (f32 through one encoder
  layer and a weighted sum), ``top_i`` equal, ``gate_for_loss`` within
  1e-6 (a softmax of logits that agree to 1e-6);
- ties broken as ``jax.lax.top_k`` breaks them (a zeroed gate head);
- the gate's noise: none in eval, N(0, gateway_t) in training by
  distribution, from the caller's generator only;
- TreeViT dense eval, teacher-forced routing and the renormalised capacity
  path (with drops) against JAX, outputs and gradients;
- the reference-``.pth`` bridges against JAX's ``torch_moe_to_flax`` /
  ``torch_treevit_to_flax`` on a synthetic HF-layout state dict, and a
  3-member ``.pth`` served through ``infer.serve.init``;
- each member's seeded initialisation against flax's by per-leaf
  distribution, as ``tests/test_torch_init.py`` holds the ViT.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import hf_vit_state_dict
from fixtures import make_image_folder
from test_torch_copies import port_config
from test_torch_init import TRUNCATION, _flax_std
from touhouimageclassification_tpu.config import (MoEConfig, TreeViTConfig,
                                                  ViTConfig)
from touhouimageclassification_tpu.models.resmoe import \
    MoEClassifier as JaxMoE
from touhouimageclassification_tpu.models.treevit import TreeViT as JaxTree
from touhouimageclassification_tpu.ops import moe_dispatch as jmd
from touhouimageclassification_tpu.train import losses as jlosses
from touhouimageclassification_tpu.utils import convert as jconvert
from touhouimageclassification_tpu_torch.infer import serve
from touhouimageclassification_tpu_torch.models import (MoEClassifier,
                                                        TreeViT, create_model)
from touhouimageclassification_tpu_torch.models.resmoe import top_k
from touhouimageclassification_tpu_torch.ops import moe_dispatch as md
from touhouimageclassification_tpu_torch.train import losses
from touhouimageclassification_tpu_torch.utils import convert

torch.set_num_threads(1)

TINY_VIT = ViTConfig(image_size=16, patch_size=8, hidden_size=16, num_layers=1,
                     num_heads=2, mlp_dim=32, num_classes=6)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x)).to(dtype)


def _routes(rng, b, k, e):
    """(B, K) distinct experts a row, as a top-k gives them."""
    return np.stack([rng.permutation(e)[:k] for _ in range(b)]).astype(
        np.int32)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

PLANS = [  # (B, K, E, capacity factor, skewed)
    (8, 2, 4, 1.25, False), (8, 1, 4, 2.0, False), (6, 2, 3, 0.5, False),
    (16, 2, 8, 1.0, False), (6, 1, 3, 1.0, True), (5, 3, 4, 0.75, True),
]


def _plan_inputs(b, k, e, factor, skewed):
    rng = np.random.default_rng(b * 100 + k * 10 + e)
    top_i = _routes(rng, b, k, e)
    if skewed:  # most samples to expert 0: drops at any factor
        top_i[: b - 1, 0] = 0
        top_i = np.stack([np.concatenate([[r[0]], [x for x in
                                                   rng.permutation(e)
                                                   if x != r[0]][:k - 1]])
                          for r in top_i]).astype(np.int32)
    return top_i, jmd.capacity_for(b, k, e, factor)


@pytest.mark.parametrize("b,k,e,factor,skewed", PLANS)
def test_dispatch_plan_equals_jax(b, k, e, factor, skewed):
    top_i, capacity = _plan_inputs(b, k, e, factor, skewed)
    assert md.capacity_for(b, k, e, factor) == capacity
    want = jmd.make_dispatch_plan(jnp.asarray(top_i), e, capacity)
    got = md.make_dispatch_plan(torch.from_numpy(top_i), e, capacity)
    assert want._fields == got._fields
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    if skewed:
        assert not bool(got.flat_keep.all())


@pytest.mark.parametrize("b,k,e,factor,skewed", PLANS)
def test_dispatch_combine_kept_mass_match_jax(b, k, e, factor, skewed):
    top_i, capacity = _plan_inputs(b, k, e, factor, skewed)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, 5)).astype(np.float32)
    w = rng.random((b, k)).astype(np.float32)
    outs = rng.standard_normal((e, capacity, 3)).astype(np.float32)
    jplan = jmd.make_dispatch_plan(jnp.asarray(top_i), e, capacity)
    plan = md.make_dispatch_plan(torch.from_numpy(top_i), e, capacity)
    np.testing.assert_array_equal(
        torch.stack([md.dispatch(plan, _t(x), i) for i in range(e)]).numpy(),
        np.asarray(jmd.dispatch(jplan, x)))
    np.testing.assert_allclose(
        md.combine(plan, _t(outs), _t(w), b).numpy(),
        np.asarray(jmd.combine(jplan, outs, w, b)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(md.kept_mass(plan, _t(w), b).numpy(),
                               np.asarray(jmd.kept_mass(jplan, w, b)),
                               atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss_inputs():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 5)).astype(np.float32) * 2
    targets = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 6)]
    gate = rng.random((6, 4)).astype(np.float32)
    gate /= gate.sum(-1, keepdims=True)
    top_i = _routes(rng, 6, 2, 4)
    weights = np.array([1, 0, 1, 1, 0, 1], np.float32)
    return logits, targets, gate, top_i, weights


@pytest.mark.parametrize("name", ["sce", "sce_weighted", "quadratic",
                                  "switch", "total"])
def test_losses_match_jax(name):
    logits, targets, gate, top_i, weights = _loss_inputs()
    calls = {
        "sce": lambda m, a: m.symmetric_cross_entropy(a(logits), a(targets)),
        "sce_weighted": lambda m, a: m.symmetric_cross_entropy(
            a(logits), a(targets), 0.3, 0.7, sample_weights=a(weights)),
        "quadratic": lambda m, a: m.load_balance_loss(a(gate)),
        "switch": lambda m, a: m.switch_load_balance_loss(
            a(gate), a(top_i, True), 4),
        "total": lambda m, a: m.moe_total_loss(a(logits), a(targets),
                                               a(gate)),
    }

    def port_arg(x, integer=False):
        return torch.from_numpy(x).long() if integer else _t(x)

    def jax_arg(x, integer=False):
        return jnp.asarray(x)

    got = calls[name](losses, port_arg).item()
    want = float(calls[name](jlosses, jax_arg))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)


def test_switch_loss_gradient_matches_jax():
    """f is counted, not differentiated: the gradient reaches the router
    probabilities only, E * f_e / B for each row."""
    _, _, gate, top_i, _ = _loss_inputs()
    want = jax.grad(lambda g: jlosses.switch_load_balance_loss(
        g, jnp.asarray(top_i), 4))(jnp.asarray(gate))
    g = _t(gate).requires_grad_()
    losses.switch_load_balance_loss(g, torch.from_numpy(top_i).long(),
                                    4).backward()
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(want), atol=1e-6)


# ---------------------------------------------------------------------------
# ResMoE
# ---------------------------------------------------------------------------

def _moe_cfg(routing="dense", **over):
    kw = dict(num_experts=4, top_k=2, num_classes=6, routing=routing,
              capacity_factor=8.0, expert_vit=TINY_VIT)
    kw.update(over)
    return MoEConfig(**kw)


def _images(b=5, seed=0, size=16):
    return np.random.default_rng(seed).standard_normal(
        (b, size, size, 3)).astype(np.float32)


def _port_moe(cfg, params):
    pcfg = port_config(cfg)
    model = MoEClassifier(pcfg, "float32", "cpu")
    model.load_state_dict(convert.from_jax_params(params, pcfg))
    return model.eval()


MOE_CASES = [  # (routing, dispatch level, capacity factor)
    ("dense", "feature", 8.0), ("sparse", "feature", 8.0),
    ("sparse", "image", 8.0), ("sparse", "feature", 0.75),
    ("sparse", "image", 0.75),
]


@pytest.mark.parametrize("balance", ["quadratic", "switch"])
@pytest.mark.parametrize("routing,level,factor", MOE_CASES)
def test_moe_forward_matches_jax(routing, level, factor, balance):
    cfg = _moe_cfg(routing, dispatch_level=level, capacity_factor=factor,
                   balance_loss=balance)
    jmodel = JaxMoE(cfg, compute_dtype="float32")
    x = _images()
    params = jax.device_get(jmodel.init(jax.random.key(1), x))
    want = [np.asarray(o) for o in jmodel.apply(params, x)]
    with torch.no_grad():
        got = [o.numpy() for o in _port_moe(cfg, params)(_t(x))]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)


def test_top_k_breaks_ties_as_jax():
    """Rows of many equal values: the lower index wins, as in lax.top_k."""
    rng = np.random.default_rng(0)
    logits = rng.integers(0, 3, (64, 8)).astype(np.float32)
    for k in (1, 2, 3, 8):
        want_v, want_i = jax.lax.top_k(jnp.asarray(logits), k)
        got_v, got_i = top_k(_t(logits), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("routing", ["dense", "sparse"])
def test_zeroed_gate_head_picks_as_jax(routing):
    """A zeroed gate head scores every expert 0: both pick experts 0 and 1
    for every image (identical images in a judge bucket tie the same way);
    a bias of [1, 0, 1, 0] picks 0 and 2."""
    cfg = _moe_cfg(routing)
    jmodel = JaxMoE(cfg, compute_dtype="float32")
    x = _images()
    params = jax.device_get(jmodel.init(jax.random.key(1), x))
    head = params["params"]["gate"]["vit"]["head"]
    for bias, picked in ((np.zeros(4), [0, 1]), (np.array([1., 0, 1, 0]),
                                                 [0, 2])):
        head["kernel"] = np.zeros_like(head["kernel"])
        head["bias"] = bias.astype(np.float32)
        want = np.asarray(jmodel.apply(params, x)[2])
        with torch.no_grad():
            got = _port_moe(cfg, params)(_t(x))[2].numpy()
        np.testing.assert_array_equal(got, want)
        assert (got == picked).all()


def test_gate_noise_only_in_training():
    """Eval: no noise, the generator ignored. Training: the router's log
    probabilities move by N(0, gateway_t) noise (centred per row, whose std
    is gateway_t * sqrt((E - 1) / E)); the same seed gives the same noise;
    a training forward without a generator raises."""
    t, e = 0.5, 8
    cfg = port_config(_moe_cfg(num_experts=e, gateway_t=t))
    model = MoEClassifier(cfg, "float32", "cpu", seed=2)
    x = _t(_images(b=128, seed=4))
    with torch.no_grad():
        model.eval()
        base = model.gate(x)[2]
        again = model.gate(x, torch.Generator().manual_seed(5))[2]
        assert torch.equal(base, again)
        model.train()
        runs = [model.gate(x, torch.Generator().manual_seed(s))[2]
                for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    moved = runs[0].log() - base.log()
    moved = moved - moved.mean(-1, keepdim=True)
    std = t * ((e - 1) / e) ** 0.5
    n = moved.numel()
    assert abs(moved.mean().item()) <= 1e-5
    assert abs(moved.std().item() / std - 1) <= 0.06, moved.std()
    # each expert's noise is centred: no expert drifts
    assert moved.mean(0).abs().max().item() <= 4 * std / (n / e) ** 0.5
    with pytest.raises(ValueError, match="Generator"):
        model(x)


# ---------------------------------------------------------------------------
# TreeViT
# ---------------------------------------------------------------------------

def _tree_cfg(**over):
    kw = dict(num_categories=3, num_classes=6, top_k=2, capacity_factor=8.0,
              vit=TINY_VIT)
    kw.update(over)
    return TreeViTConfig(**kw)


def _port_tree(cfg, params):
    pcfg = port_config(cfg)
    model = TreeViT(pcfg, "float32", "cpu")
    model.load_state_dict(convert.from_jax_params(params, pcfg))
    return model


TREE_CASES = {  # name: (config overrides, JAX deterministic, route labels)
    "dense_eval": ({}, True, False),
    "teacher_forced": ({}, False, True),
    "capacity": ({}, False, False),
    "capacity_drops": (dict(capacity_factor=0.5), False, False),
    "capacity_eval": (dict(eval_dense=False, capacity_factor=0.5), True,
                      False),
}


@pytest.mark.parametrize("name", list(TREE_CASES))
def test_treevit_matches_jax(name):
    """Outputs, and the gradients of sum(c^2) + sum(choice^2) w.r.t. every
    parameter (the combine's backward through index_add_): relative
    difference in norm within 1e-4 a leaf (1.1e-5 measured)."""
    over, deterministic, forced = TREE_CASES[name]
    cfg = _tree_cfg(**over)
    jmodel = JaxTree(cfg, compute_dtype="float32")
    x = _images(b=6)
    route = np.array([0, 2, 1, 1, 0, 2], np.int32) if forced else None
    params = jax.device_get(jmodel.init(jax.random.key(1), x))

    def jloss(p):
        c, ch, _ = jmodel.apply(p, x, deterministic=deterministic,
                                route_labels=route)
        return jnp.sum(c ** 2) + jnp.sum(ch ** 2)

    want = [np.asarray(o) for o in jmodel.apply(
        params, x, deterministic=deterministic, route_labels=route)]
    want_grads = convert.from_jax_params(
        jax.device_get(jax.grad(jloss)(params)), port_config(cfg))
    model = _port_tree(cfg, params).train(not deterministic)
    got = model(_t(x), route_labels=(None if route is None
                                     else torch.from_numpy(route)))
    (got[0].pow(2).sum() + got[1].pow(2).sum()).backward()
    if name == "capacity_drops":
        assert (want[2] < 1).any()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=1e-5, rtol=0)
    for k, p in model.named_parameters():
        # f32 gradients up to ~500 (squares of logits of tens), summed over
        # the batch in other orders: held in norm, leaf by leaf
        rel = (p.grad - want_grads[k]).norm() / want_grads[k].norm()
        assert rel.item() <= 1e-4, (k, rel)


# ---------------------------------------------------------------------------
# reference checkpoints
# ---------------------------------------------------------------------------

def _hf(num_classes, seed):
    return hf_vit_state_dict(16, 1, 32, num_classes, image_size=16, patch=8,
                             seed=seed)


def _reference_sd(family, members, classes):
    """A reference MoEClassifier / TreeModule state dict of HF ViTs: gate or
    root scoring ``members``, member heads of ``classes`` classes."""
    first = "gate.vit." if family == "resmoe" else "root."
    name = "experts" if family == "resmoe" else "sons"
    sd = {first + k: v for k, v in _hf(members, 0).items()}
    for i in range(members):
        sd.update({f"{name}.{i}.{k}": v
                   for k, v in _hf(classes, i + 1).items()})
    return sd


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=path)


@pytest.mark.parametrize("classes", [6, 5])
@pytest.mark.parametrize("family", ["resmoe", "treevit"])
def test_reference_bridges_equal_jax(family, classes):
    """Three members (not the presets' 8); a member head of 5 classes
    against a 6-class model is drawn afresh with seed i, as in JAX."""
    sd = _reference_sd(family, 3, classes)
    bridge = {"resmoe": "torch_moe_to_flax",
              "treevit": "torch_treevit_to_flax"}[family]
    want = getattr(jconvert, bridge)(sd, 6)
    _assert_trees_equal(getattr(convert, bridge)(sd, 6), want)
    assert (convert.member_overrides(sd, family)
            == jconvert.member_overrides(sd, family))
    cfg = (_moe_cfg(num_experts=3) if family == "resmoe"
           else _tree_cfg(num_categories=3))
    got = convert.convert_checkpoint(sd, port_config(cfg))
    ref = convert.from_jax_params(want, port_config(cfg))
    assert got.keys() == ref.keys()
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    with pytest.raises(ValueError, match="contiguous"):
        convert.member_overrides({k: v for k, v in sd.items()
                                  if not k.startswith(("experts.1.",
                                                       "sons.1."))}, family)


@pytest.mark.parametrize("family", ["resmoe", "treevit"])
def test_three_member_pth_serves(family, tmp_path, monkeypatch):
    """``init`` on a reference .pth of 3 members builds the model with 3
    (the presets have 8) and serves it; the members here are tiny ViTs, so
    the factory is pinned to them."""
    data = make_image_folder(str(tmp_path / "data"), num_classes=6,
                             per_class=1, size=20)
    pth = tmp_path / "mix.pth"
    torch.save(_reference_sd(family, 3, 6), pth)
    member = port_config(TINY_VIT)
    over = {"expert_vit" if family == "resmoe" else "vit": member}

    def tiny(mt, **kw):
        return create_model(mt, compute_dtype="float32", **over, **kw)

    monkeypatch.setattr(serve, "create_model", tiny)
    predictor = serve.init(modelt=family, weights=str(pth), data_dir=data,
                           device="cpu")
    model = predictor.model
    members = model.experts if family == "resmoe" else model.sons
    assert len(members) == 3 and predictor.image_size == (16, 16)
    pred, conf = predictor.predict_array(
        np.random.default_rng(0).integers(0, 256, (4, 20, 20, 3),
                                          dtype=np.uint8))
    assert pred.shape == (4,) and ((conf > 0) & (conf <= 1)).all()


# ---------------------------------------------------------------------------
# the seeded initialisation
# ---------------------------------------------------------------------------

INIT_VIT = ViTConfig(image_size=32, patch_size=8, hidden_size=64,
                     num_layers=2, num_heads=4, mlp_dim=128, num_classes=16)


@pytest.mark.parametrize("family", ["resmoe", "treevit"])
def test_member_init_follows_flax(family):
    """Every member's every leaf against the same leaf of flax's init of the
    JAX model (the rules of ``test_torch_init.py``, the std's bound widened
    to 4 standard errors for leaves under 800 values), and the members drawn
    apart from each other, and the same seed giving the same model."""
    if family == "resmoe":
        cfg = MoEConfig(num_experts=2, top_k=1, num_classes=16,
                        expert_vit=INIT_VIT)
        jmodel, cls = JaxMoE(cfg, compute_dtype="float32"), MoEClassifier
    else:
        cfg = TreeViTConfig(num_categories=2, num_classes=16, top_k=1,
                            vit=INIT_VIT)
        jmodel, cls = JaxTree(cfg, compute_dtype="float32"), TreeViT
    pcfg = port_config(cfg)
    params = jmodel.init(jax.random.key(0), np.zeros((1, 32, 32, 3),
                                                     np.float32))
    jax_sd = convert.from_jax_params(jax.device_get(params), pcfg)
    port_sd = cls(pcfg, "float32", "cpu", seed=0).state_dict()
    assert port_sd.keys() == jax_sd.keys()
    for name, want in jax_sd.items():
        got = port_sd[name]
        assert got.shape == want.shape and got.dtype == torch.float32, name
        leaf = name.split(".", 2)[-1] if family == "resmoe" else (
            name.split(".", 1)[1] if name.startswith("root.")
            else name.split(".", 2)[2])
        std = _flax_std(leaf, want)
        if std is None:
            constant = want.flatten()[0].item()
            assert torch.equal(got, torch.full_like(got, constant)), name
            continue
        n = got.numel()
        assert abs(got.mean().item()) <= 3 * std / n ** 0.5, name
        # a sample std's relative error is ~1/sqrt(2n): 10%, or 4 of those
        # for the gate's and root's small heads (E x hidden values)
        for t in (got, want):
            assert abs(t.std().item() / std - 1) <= max(
                0.10, 4 / (2 * n) ** 0.5), (name, t.std())
            if leaf != "pos_embed":
                assert t.abs().max().item() <= TRUNCATION * std, name
    name = "experts" if family == "resmoe" else "sons"
    a, b = (port_sd[f"{name}.{i}.layer.0.attn.qkv.weight"] for i in (0, 1))
    assert not torch.equal(a, b)
    again = cls(pcfg, "float32", "cpu", seed=0).state_dict()
    assert all(torch.equal(again[k], v) for k, v in port_sd.items())
