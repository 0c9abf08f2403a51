"""The port's augmentation, mixup, losses, optimizer and train step against
the JAX package's, on the CPU.

The JAX random ops draw their parameters from key splits; the tests replay
those splits, hand the same numbers to the port's deterministic apply
functions and compare elementwise (f32: summation order only, 1e-5). The
port's samplers, which draw from a ``torch.Generator``, are held by their
distributions instead. The train step is compared with the JAX ``Trainer``
(built once per configuration and module) on a tiny f32 ViT with
augmentation and mixup off, from the same parameters and batches, after 1 and
10 steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touhouimageclassification_tpu.config import (
    AugmentConfig, CheckpointConfig, MixConfig, OptimizerConfig, TrainConfig,
    ViTConfig)
from touhouimageclassification_tpu.models.vit import ViT as JaxViT
from touhouimageclassification_tpu.ops import augment as jaug
from touhouimageclassification_tpu.ops import mixup as jmix
from touhouimageclassification_tpu.parallel.mesh import create_mesh, data_sharding
from touhouimageclassification_tpu.train import losses as jlosses
from touhouimageclassification_tpu.train import optim as joptim
from touhouimageclassification_tpu.train.trainer import Trainer as JaxTrainer
from touhouimageclassification_tpu_torch.models.vit import ViT
from touhouimageclassification_tpu_torch.ops import augment as aug
from touhouimageclassification_tpu_torch.ops import mixup
from touhouimageclassification_tpu_torch.train import losses
from touhouimageclassification_tpu_torch.train import optim
from touhouimageclassification_tpu_torch.train.trainer import Trainer
from touhouimageclassification_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)

ATOL = 1e-5   # f32 image ops: summation order of the resize matmuls only


def _images(b=3, h=20, w=24, seed=0):
    return np.random.default_rng(seed).random((b, h, w, 3), dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


# ---------------------------------------------------------------------------
# augmentation
# ---------------------------------------------------------------------------

def test_crop_and_resize_matches_jax():
    x = _images()
    rng = np.random.default_rng(1)
    crop_h = rng.uniform(2, 20, 3).astype(np.float32)
    crop_w = rng.uniform(2, 24, 3).astype(np.float32)
    top = (rng.random(3) * (20 - crop_h)).astype(np.float32)
    left = (rng.random(3) * (24 - crop_w)).astype(np.float32)
    want = jaug.crop_and_resize(x, top, left, crop_h, crop_w, (16, 12))
    got = aug.crop_and_resize(_t(x), _t(top), _t(left), _t(crop_h), _t(crop_w),
                              (16, 12))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_resize_matches_jax():
    x = _images()
    np.testing.assert_allclose(aug.resize(_t(x), (16, 12)).numpy(),
                               np.asarray(jaug.resize(x, (16, 12))), atol=ATOL)


def test_random_resized_crop_replays_jax():
    x = _images()
    key = jax.random.key(3)
    want = jaug.random_resized_crop(key, x, (16, 16))
    b, h, w, _ = x.shape
    k_area, k_ratio, k_top, k_left = jax.random.split(key, 4)
    area = jax.random.uniform(k_area, (b,), minval=0.08, maxval=1.0) * (h * w)
    aspect = jnp.exp(jax.random.uniform(k_ratio, (b,), minval=jnp.log(3 / 4),
                                        maxval=jnp.log(4 / 3)))
    crop_w = jnp.clip(jnp.sqrt(area * aspect), 1.0, w)
    crop_h = jnp.clip(jnp.sqrt(area / aspect), 1.0, h)
    top = jax.random.uniform(k_top, (b,)) * (h - crop_h)
    left = jax.random.uniform(k_left, (b,)) * (w - crop_w)
    got = aug.crop_and_resize(_t(x), _t(top), _t(left), _t(crop_h), _t(crop_w),
                              (16, 16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_hflip_and_grayscale_replay_jax():
    x = _images(6)
    key = jax.random.key(4)
    flip = np.array(jax.random.bernoulli(key, 0.5, (6,)))
    np.testing.assert_array_equal(
        aug.hflip(_t(x), torch.from_numpy(flip)).numpy(),
        np.asarray(jaug.random_hflip(key, x, 0.5)))
    on = np.array(jax.random.bernoulli(key, 0.4, (6,)))
    np.testing.assert_allclose(
        aug.apply_grayscale(_t(x), torch.from_numpy(on)).numpy(),
        np.asarray(jaug.random_grayscale(key, x, 0.4)), atol=ATOL)


@pytest.mark.parametrize("name", ["brightness", "contrast", "saturation",
                                  "hue"])
def test_color_adjust_matches_jax(name):
    x = _images(4)
    factor = np.random.default_rng(5).uniform(0.5, 1.5, 4).astype(np.float32)
    if name == "hue":
        factor = factor - 1.0
    ours = getattr(aug, f"_adjust_{name}")(_t(x), _t(factor))
    want = getattr(jaug, f"_adjust_{name}")(jnp.asarray(x), jnp.asarray(factor))
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), atol=ATOL)


def test_color_jitter_replays_jax():
    x = _images(4)
    key = jax.random.key(6)
    want = jaug.color_jitter(key, x, 0.2, 0.2, 0.2, 0.1)
    kb, kc, ks, kh = jax.random.split(key, 4)
    factors = {
        "brightness": jax.random.uniform(kb, (4,), minval=0.8, maxval=1.2),
        "contrast": jax.random.uniform(kc, (4,), minval=0.8, maxval=1.2),
        "saturation": jax.random.uniform(ks, (4,), minval=0.8, maxval=1.2),
        "hue": jax.random.uniform(kh, (4,), minval=-0.1, maxval=0.1)}
    got = aug.apply_color_jitter(_t(x), {k: _t(v) for k, v in factors.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_hsv_round_trip_and_jax_parity():
    rng = np.random.default_rng(7)
    x = rng.random((2, 9, 11, 3), dtype=np.float32)
    x[0, 0, :4] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0]]
    hsv = aug._rgb_to_hsv(_t(x))
    np.testing.assert_allclose(hsv.numpy(), np.asarray(jaug._rgb_to_hsv(x)),
                               atol=1e-6)
    np.testing.assert_allclose(aug._hsv_to_rgb(hsv).numpy(), x, atol=1e-6)
    np.testing.assert_allclose(
        aug._hsv_to_rgb(hsv).numpy(),
        np.asarray(jaug._hsv_to_rgb(jnp.asarray(hsv.numpy()))), atol=1e-6)


def test_random_erasing_replays_jax():
    x = _images(6)
    key = jax.random.key(8)
    want = jaug.random_erasing(key, x, 0.5)
    b, h, w, _ = x.shape
    k_on, k_area, k_ratio, k_top, k_left = jax.random.split(key, 5)
    on = jax.random.bernoulli(k_on, 0.5, (b,))
    area = jax.random.uniform(k_area, (b,), minval=0.02, maxval=0.33) * (h * w)
    aspect = jnp.exp(jax.random.uniform(k_ratio, (b,), minval=jnp.log(0.3),
                                        maxval=jnp.log(3.3)))
    eh = jnp.clip(jnp.sqrt(area / aspect), 1.0, h)
    ew = jnp.clip(jnp.sqrt(area * aspect), 1.0, w)
    top = jax.random.uniform(k_top, (b,)) * (h - eh)
    left = jax.random.uniform(k_left, (b,)) * (w - ew)
    got = aug.apply_erasing(_t(x), torch.from_numpy(np.array(on)), _t(top),
                            _t(left), _t(eh), _t(ew))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.asarray(on).any() and (got.numpy() == 0).any()


def test_resized_crop_and_erasing_samplers_by_distribution():
    """The port's samplers follow the JAX package's distributions (as
    test_augment_golden.py::test_rrc_sampler_distribution checks them):
    area fraction ~ U(scale) with the clamp only shrinking boxes, aspect
    log-uniform within the ratio bounds, erasing on with probability p."""
    gen = torch.Generator().manual_seed(0)
    imgs = torch.zeros(4096, 256, 256, 1)
    top, left, crop_h, crop_w = aug.sample_resized_crop(gen, imgs)
    frac = (crop_w * crop_h / 256 ** 2).numpy()
    assert 0.45 <= frac.mean() <= 0.60, frac.mean()
    ar = (crop_w / crop_h).numpy()
    assert ar.min() >= 0.74 and ar.max() <= 1.34
    assert abs(np.log(ar).mean()) < 0.02
    assert (top >= 0).all() and (top + crop_h <= 256 + 1e-3).all()
    assert (left >= 0).all() and (left + crop_w <= 256 + 1e-3).all()
    on, top, left, eh, ew = aug.sample_erasing(gen, imgs, 0.5)
    assert 0.45 <= on.float().mean() <= 0.55
    efrac = (eh * ew / 256 ** 2).numpy()
    assert 0.15 <= efrac.mean() <= 0.19, efrac.mean()   # E[U(.02, .33)] .175


@pytest.mark.parametrize("recipe", [
    AugmentConfig(), AugmentConfig(enable_generalization=False),
    AugmentConfig(enable_diversity=False),
    AugmentConfig(only_grey_augmentation=True),
    AugmentConfig(enable_augmentation=False)])
def test_augment_recipes_shape_range_and_determinism(recipe):
    x = _t(_images(4, 24, 24))
    fn = aug.build_augment_fn(recipe, (16, 16))
    a = fn(torch.Generator().manual_seed(1), x)
    b = fn(torch.Generator().manual_seed(1), x)
    assert a.shape == (4, 16, 16, 3) and torch.isfinite(a).all()
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    lo = (0 - np.max(recipe.mean)) / np.min(recipe.std)
    hi = (1 - np.min(recipe.mean)) / np.min(recipe.std)
    assert lo - 1e-5 <= a.min() and a.max() <= hi + 1e-5
    if not recipe.enable_augmentation:
        np.testing.assert_allclose(
            aug.build_eval_fn(recipe, (16, 16))(x).numpy(),
            np.asarray(jaug.build_eval_fn(recipe, (16, 16))(x.numpy())),
            atol=ATOL)


# ---------------------------------------------------------------------------
# mixup
# ---------------------------------------------------------------------------

def _jax_draw(key, h, w):
    """The JAX cutmix_or_mixup's draws for ``key``, replayed."""
    k_choice, k_op = jax.random.split(key)
    if bool(jax.random.bernoulli(k_choice, 0.5)):
        k_lam, k_y, k_x = jax.random.split(k_op, 3)
        return {"cutmix": True, "lam": float(jax.random.beta(k_lam, 1.0, 1.0)),
                "cy": float(jax.random.uniform(k_y) * h),
                "cx": float(jax.random.uniform(k_x) * w)}
    return {"cutmix": False, "lam": float(jax.random.beta(k_op, 1.0, 1.0))}


@pytest.mark.parametrize("seed,is_cutmix", [(0, False), (3, True)])
def test_cutmix_and_mixup_replay_jax(seed, is_cutmix):
    x = _images(5, 16, 16)
    labels = np.eye(4, dtype=np.float32)[[0, 1, 2, 3, 1]]
    key = jax.random.key(seed)
    want_x, want_y = jmix.cutmix_or_mixup(key, x, labels)
    draw = _jax_draw(key, 16, 16)
    assert draw["cutmix"] == is_cutmix
    got_x, got_y = mixup.apply_cutmix_or_mixup(_t(x), _t(labels), draw)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=1e-6)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-6)


def test_mixup_sampler_draws_both_branches_and_valid_lambdas():
    rng = np.random.default_rng(0)
    draws = [mixup.sample_cutmix_or_mixup(rng, 16, 16) for _ in range(400)]
    cut = [d for d in draws if d["cutmix"]]
    assert 150 < len(cut) < 250
    assert all(0 <= d["lam"] <= 1 for d in draws)
    assert all(0 <= d["cy"] < 16 and 0 <= d["cx"] < 16 for d in cut)
    x, y = mixup.cutmix_or_mixup(rng, _t(_images(3, 16, 16)), torch.eye(3))
    torch.testing.assert_close(y.sum(-1), torch.ones(3))


# ---------------------------------------------------------------------------
# losses and optimizer pieces
# ---------------------------------------------------------------------------

def test_cross_entropy_and_accuracy_match_jax():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((6, 5)).astype(np.float32)
    soft = rng.dirichlet(np.ones(5), 6).astype(np.float32)
    weights = np.array([1, 0, 1, 1, 0, 1], np.float32)
    for w in (None, weights):
        np.testing.assert_allclose(
            losses.cross_entropy(_t(logits), _t(soft),
                                 None if w is None else _t(w)).item(),
            float(jlosses.cross_entropy(logits, soft, w)), rtol=1e-6)
    labels = np.array([0, 1, 2, 3, 4, 0])
    mask = np.array([1, 1, 1, 0, 1, 0], bool)
    for m in (None, mask):
        got = losses.accuracy(_t(logits), torch.from_numpy(labels),
                              None if m is None else torch.from_numpy(m))
        want = jlosses.accuracy(logits, labels, m)
        assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))


@pytest.mark.parametrize("cfg", [
    OptimizerConfig(learning_rate=3e-4),
    OptimizerConfig(learning_rate=3e-4, schedule="warmup_linear",
                    warmup_steps=5, total_steps=20),
    OptimizerConfig(learning_rate=3e-4, schedule="warmup_linear",
                    warmup_steps=0, total_steps=9),
    OptimizerConfig(learning_rate=0.1, schedule="step", step_lr_epoch_size=2,
                    step_lr_gamma=0.25)])
def test_schedules_match_optax(cfg):
    ours = optim.build_schedule(cfg, steps_per_epoch=3)
    want = joptim.build_schedule(cfg, steps_per_epoch=3)
    for count in range(30):
        np.testing.assert_allclose(ours(count), float(want(count)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(count))


def test_global_norm_matches_jax_leafsum():
    rng = np.random.default_rng(10)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in
              ((3, 4), (5,), (2, 2, 2))]
    np.testing.assert_allclose(
        optim.global_norm([_t(x) for x in leaves]).item(),
        float(joptim.fast_global_norm(leaves)), rtol=1e-6)
    leaves[1][2] = np.nan
    assert not np.isfinite(optim.global_norm([_t(x) for x in leaves]).item())


# ---------------------------------------------------------------------------
# the train step against the JAX Trainer
# ---------------------------------------------------------------------------

TINY = ViTConfig(image_size=16, patch_size=8, hidden_size=16, num_layers=1,
                 num_heads=2, mlp_dim=32, num_classes=4)
STEPS = 10

OPTIMIZERS = {
    "adamw": (OptimizerConfig(name="adamw", learning_rate=1e-3,
                              weight_decay=0.01), True),
    "sgd_momentum": (OptimizerConfig(name="sgd", learning_rate=1e-2,
                                     momentum=0.9), True),
    # accumulation, with global-norm clipping and a warmup schedule riding
    # along: both act on the accumulated gradient every second step
    "accum_k2": (OptimizerConfig(name="adamw", learning_rate=1e-3,
                                 weight_decay=0.01, grad_accum_steps=2,
                                 max_grad_norm=0.5, schedule="warmup_linear",
                                 warmup_steps=2, total_steps=8), True),
    "frozen_backbone": (OptimizerConfig(name="adamw", learning_rate=1e-3,
                                        weight_decay=0.01), False),
}


def _train_cfg(tmp, opt, full_finetune=True):
    return TrainConfig(
        train_id="torch_parity", model_type="vit-base", global_batch_size=8,
        seed=0, optimizer=opt, full_finetune=full_finetune,
        augment=AugmentConfig(enable_augmentation=False),
        mix=MixConfig(enable_mixup=False),
        checkpoint=CheckpointConfig(directory=str(tmp / "c"), async_save=False),
        log_dir=str(tmp / "l"))


def _batches(n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (8, 16, 16, 3)).astype(np.uint8),
             "label": rng.integers(0, 4, 8).astype(np.int32),
             "mask": np.ones(8, bool)} for _ in range(n)]


def _jax_trainer(tmp, opt, full_finetune=True):
    mesh = create_mesh(num_data=1, devices=jax.devices()[:1])
    trainer = JaxTrainer(_train_cfg(tmp, opt, full_finetune),
                         model=JaxViT(TINY, compute_dtype="float32"), mesh=mesh)
    return trainer, mesh


def _port_trainer(tmp, opt, params, full_finetune=True):
    return Trainer(_train_cfg(tmp, opt, full_finetune),
                   model=ViT(TINY, compute_dtype="float32", device="cpu",
                             param_dtype="float32"),
                   device="cpu", init_params=from_jax_params(params, TINY))


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    """name -> {step: (jax metrics, port metrics, jax params as port state
    dict, port params)} at steps 1 and STEPS; each configuration's JAX
    Trainer is built and compiled once."""
    cache = {}

    def run(name):
        if name not in cache:
            opt, full = OPTIMIZERS[name]
            tmp = tmp_path_factory.mktemp(name)
            jt, mesh = _jax_trainer(tmp, opt, full)
            jstate = jt.init_state(4)
            step = jt._make_train_step()
            pt = _port_trainer(tmp, opt, jax.device_get(jstate.params), full)
            pstate = pt.init_state(4)
            out = {}
            for i, batch in enumerate(_batches(), start=1):
                jstate, jm = step(jstate, jax.device_put(batch,
                                                         data_sharding(mesh)))
                pm = pt.train_step(pstate, pt.stage(batch))
                if i in (1, STEPS):
                    out[i] = ({k: float(v) for k, v in jm.items()}, pm,
                              from_jax_params(jax.device_get(jstate.params),
                                              TINY),
                              {k: p.detach().clone() for k, p in
                               pstate.model.named_parameters()})
            assert int(jstate.step) == pstate.step == STEPS
            cache[name] = out
        return cache[name]

    return run


def _key_bias(name):
    """The key third of a fused QKV bias. Its gradient is zero in exact
    arithmetic (a constant added to every score of a softmax row changes
    nothing), so both frameworks' gradients there are rounding noise, which
    AdamW's division by sqrt(v) scales up to +-lr per update."""
    c = TINY.hidden_size
    return (slice(c, 2 * c) if name.endswith("attn.qkv.bias") else
            slice(0, 0))


@pytest.mark.parametrize("steps", [1, STEPS])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_train_steps_match_jax_trainer(trajectories, name, steps):
    """Loss, grad_norm and every parameter after 1 and 10 steps. f32 on the
    CPU: loss and grad_norm differ by summation order (1e-5 relative). The
    parameters carry that difference through the updates: SGD at lr 1e-2 on
    gradients of norm up to 44 moves a parameter up to ~0.4 per step, so a
    1e-6 relative gradient difference, summed by momentum 0.9 over 10 steps,
    reaches ~4e-6: 1e-5 absolute, 1e-5 relative. The key bias, whose true
    gradient is zero, is held to the size of the updates themselves:
    2 x lr per step."""
    jm, pm, jparams, pparams = trajectories(name)[steps]
    np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(pm["grad_norm"], jm["grad_norm"], rtol=1e-5)
    assert jparams.keys() == pparams.keys()
    lr = OPTIMIZERS[name][0].learning_rate
    for k in jparams:
        got, want = pparams[k].clone(), jparams[k].clone()
        kb = _key_bias(k)
        assert np.abs((got[kb] - want[kb]).numpy()).max(initial=0.0) <= (
            2 * lr * steps), k
        got[kb] = want[kb] = 0.0
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5, msg=k)


def test_frozen_backbone_updates_only_the_head(trajectories):
    _, _, _, start = trajectories("frozen_backbone")[1]
    _, _, _, end = trajectories("frozen_backbone")[STEPS]
    for k in start:
        assert torch.equal(start[k], end[k]) != k.startswith("head."), k


def _poison(trainer_state):
    with torch.no_grad():
        for p in trainer_state.model.parameters():
            if p.dim() == 2:
                p.mul_(1e38)


def test_nan_guard_skips_update_and_keeps_optimizer_state(tmp_path):
    """As test_nan_guard.py: a step whose loss or grad_norm is not finite
    leaves parameters and optimizer state unchanged; step still advances."""
    opt = OptimizerConfig(name="adamw", learning_rate=1e-2)
    params = JaxViT(TINY, compute_dtype="float32").init(
        jax.random.key(0), np.zeros((1, 16, 16, 3), np.float32))
    trainer = _port_trainer(tmp_path, opt, params)
    state = trainer.init_state(4)
    good, = _batches(1)
    trainer.train_step(state, trainer.stage(good))
    assert state.optimizer.count == 1
    moments = {id(p): {k: v.clone() for k, v in s.items()}
               for p, s in state.optimizer.inner.state.items()}
    _poison(state)
    before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    bad = {"image": np.full((8, 16, 16, 3), 255, np.uint8),
           "label": np.zeros(8, np.int32), "mask": np.ones(8, bool)}
    metrics = trainer.train_step(state, trainer.stage(bad))
    assert not (np.isfinite(metrics["loss"])
                and np.isfinite(metrics["grad_norm"]))
    for k, p in state.model.named_parameters():
        assert torch.equal(p, before[k]), k
    assert state.optimizer.count == 1 and state.step == 2
    for p, s in state.optimizer.inner.state.items():
        for k, v in s.items():
            assert torch.equal(v, moments[id(p)][k]), k


def test_finite_step_updates_every_trainable_parameter(tmp_path):
    opt = OptimizerConfig(name="sgd", learning_rate=1e-2)
    params = JaxViT(TINY, compute_dtype="float32").init(
        jax.random.key(0), np.zeros((1, 16, 16, 3), np.float32))
    trainer = _port_trainer(tmp_path, opt, params)
    state = trainer.init_state(4)
    before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    metrics = trainer.train_step(state, trainer.stage(_batches(1)[0]))
    assert np.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
    changed = [k for k, p in state.model.named_parameters()
               if not torch.equal(p, before[k])]
    assert "head.weight" in changed and "layer.0.attn.qkv.weight" in changed


def test_evaluate_padded_tail_matches_jax(tmp_path):
    """Masked loss sum and accuracy over a padded last batch, against the
    JAX evaluate; an all-masked loader raises as there."""
    opt = OptimizerConfig(name="adamw", learning_rate=1e-3)
    jt, _ = _jax_trainer(tmp_path, opt)
    jstate = jt.init_state(4)
    pt = _port_trainer(tmp_path, opt, jax.device_get(jstate.params))
    pt.init_state(4)
    loader = _batches(2, seed=3)
    loader[1]["mask"] = np.arange(8) < 3
    loader[1]["image"][3:] = 0
    want = jt.evaluate(loader, jstate)
    got = pt.evaluate(loader)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-5)
    assert got["val_acc"] == want["val_acc"]
    assert pt.test(loader) == {"test_loss": got["val_loss"],
                               "test_acc": got["val_acc"]}
    empty = [dict(loader[0], mask=np.zeros(8, bool))]
    with pytest.raises(ValueError, match="no valid samples"):
        pt.evaluate(empty)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_trainer_with_full_augmentation_and_mixup_is_reproducible(tmp_path,
                                                                  dropout):
    """Per-step randomness is keyed by (seed, step): two trainers from the
    same weights take the same augmented, mixed steps, dropout included,
    and a draw between steps does not disturb them."""
    cfg = dataclasses.replace(
        _train_cfg(tmp_path, OptimizerConfig(name="adamw", learning_rate=1e-3)),
        augment=AugmentConfig(), mix=MixConfig())
    model_cfg = dataclasses.replace(TINY, dropout_rate=dropout,
                                    attention_dropout_rate=dropout)
    params = from_jax_params(JaxViT(TINY, compute_dtype="float32").init(
        jax.random.key(0), np.zeros((1, 16, 16, 3), np.float32)), TINY)
    runs = []
    for run in range(2):
        torch.manual_seed(run)
        trainer = Trainer(cfg, model=ViT(model_cfg, compute_dtype="float32",
                                         device="cpu", param_dtype="float32"),
                          device="cpu", init_params=params)
        state = trainer.init_state(4)
        batch = {"image": np.random.default_rng(0).integers(
            0, 256, (8, 20, 20, 3)).astype(np.uint8),
            "label": np.arange(8, dtype=np.int32) % 4, "mask": np.ones(8, bool)}
        runs.append([trainer.train_step(state, trainer.stage(batch))
                     for _ in range(3)])
    assert runs[0] == runs[1]
    assert len({m["loss"] for m in runs[0]}) == 3
    assert all(np.isfinite(m["loss"]) for m in runs[0])
