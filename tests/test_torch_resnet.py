"""The port's ResNet family against the JAX package's, on the CPU.

Both sides hold the same weights (JAX ``ResNet.init`` -> ``from_jax_params``,
or one torchvision-layout ``.pth`` loaded by each package's converter) and
see the same NHWC images:

- the forward in eval mode, depths 18 and 50 at 64x64 and 152 at 32x32
  (one image), with randomised BN statistics: f32 within 1e-5 of the
  largest logit (summation order only); bf16 compute over f32 parameters
  within twice the JAX model's own bf16-vs-f32 difference;
- the padding trap: JAX's ``'SAME'`` pads a stride-2 3x3 conv (0, 1) on an
  even input; with torch's symmetric (1, 1) the logits move far past the
  f32 tolerance;
- BatchNorm in train mode: flax's momentum 0.9 and biased variance (a 7x7
  batch of 2, n = 98, where torch's unbiased fold differs by 1%), and the
  running statistics of a whole train-mode forward;
- the seeded scratch init by distribution against ``ResNet.init``;
- 1 and 5 SGD steps of a ResNet-18 ``Trainer`` against the JAX
  ``Trainer``, parameters and BN statistics (after 5 steps within the
  reference's own spread from a one-ulp nudge); the NaN guard with the BN
  statistics; exact resume; the ``resnet_train`` CLI to a serving export
  served back.

Deep random-init features have channels whose mean dwarfs their spread,
where flax's ``E[x^2] - E[x]^2`` loses digits to cancellation in both
packages alike (they sum in other orders); the train-mode checks run on
images of distinct content and name their tolerances.
"""
import contextlib
import csv
import dataclasses
import importlib
import json
import os
import signal

import jax
import numpy as np
import pytest
import torch
from flax import linen as fnn

from fixtures import make_image_folder
from test_torch_copies import port_config
from touhouimageclassification_tpu.config import (AugmentConfig,
                                                  CheckpointConfig, MixConfig,
                                                  OptimizerConfig,
                                                  ResNetConfig, TrainConfig)
from touhouimageclassification_tpu.models.resnet import ResNet as JaxResNet
from touhouimageclassification_tpu.parallel.mesh import (create_mesh,
                                                         data_sharding)
from touhouimageclassification_tpu.train.trainer import Trainer as JaxTrainer
from touhouimageclassification_tpu.utils import convert as jconvert
from touhouimageclassification_tpu_torch.infer import serve
from touhouimageclassification_tpu_torch.models import create_model
from touhouimageclassification_tpu_torch.models.resnet import (BatchNorm2d,
                                                               ResNet)
from touhouimageclassification_tpu_torch.train import resnet_train
from touhouimageclassification_tpu_torch.train.trainer import Trainer
from touhouimageclassification_tpu_torch.utils.convert import (
    from_jax_params, load_resnet_weights)

torch.set_num_threads(1)
# the module (the package's ``resnet`` is the depth factory)
resnet_mod = importlib.import_module(
    "touhouimageclassification_tpu_torch.models.resnet")

N_CLASSES = 5
F32_TOL = 1e-5       # of the largest |logit|: summation order only


def _images(b, size, seed=0):
    """Images of distinct content: a per-image base colour under noise."""
    rng = np.random.default_rng(seed)
    base = rng.random((b, 1, 1, 3))
    return (0.5 * base + 0.5 * rng.random((b, size, size, 3))).astype(
        np.float32)


def _jax_model(depth, dtype="float32", **kw):
    return JaxResNet(ResNetConfig(depth=depth, num_classes=N_CLASSES, **kw),
                     compute_dtype=dtype)


def _port_model(depth, dtype="float32", variables=None, **kw):
    model = ResNet(port_config(ResNetConfig(depth=depth,
                                            num_classes=N_CLASSES, **kw)),
                   compute_dtype=dtype, param_dtype="float32", device="cpu")
    if variables is not None:
        model.load_state_dict(from_jax_params(variables, model.cfg))
    return model


def _randomised(variables, seed=1):
    """JAX variables with BN statistics drawn away from 0 / 1: means from
    N(0, 0.1), variances from U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "var"
                         else rng.normal(0, 0.1, a.shape)).astype(np.float32),
        jax.device_get(variables["batch_stats"]))
    return {"params": jax.device_get(variables["params"]),
            "batch_stats": stats}


FORWARD_CASES = {18: (2, 64), 50: (2, 64), 152: (1, 32)}


@pytest.fixture(scope="module")
def forward_runs():
    """depth -> (variables, images, JAX f32 logits, JAX bf16 logits)."""
    cache = {}

    def run(depth):
        if depth not in cache:
            b, size = FORWARD_CASES[depth]
            x = _images(b, size)
            variables = _randomised(_jax_model(depth).init(
                jax.random.key(0), x[:1]))
            cache[depth] = (variables, x, *(
                np.asarray(_jax_model(depth, dt).apply(variables, x))
                for dt in ("float32", "bfloat16")))
        return cache[depth]

    return run


def _port_logits(depth, variables, x, dtype="float32"):
    with torch.no_grad():
        return _port_model(depth, dtype, variables).eval()(
            torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("depth", sorted(FORWARD_CASES))
def test_forward_f32_matches_jax(forward_runs, depth):
    variables, x, want, _ = forward_runs(depth)
    got = _port_logits(depth, variables, x)
    assert got.shape == want.shape == (x.shape[0], N_CLASSES)
    assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()


@pytest.mark.parametrize("depth", sorted(FORWARD_CASES))
def test_forward_bf16_matches_jax(forward_runs, depth):
    """bf16 activations over f32 parameters, as the JAX model computes:
    the two packages' bf16 logits differ by at most twice what bf16 moves
    the JAX logits from its f32 ones (rounding in other orders)."""
    variables, x, want32, want16 = forward_runs(depth)
    got = _port_logits(depth, variables, x, "bfloat16")
    spread = np.abs(want16 - want32).max()
    assert spread > 0
    assert np.abs(got - want16).max() <= 2 * spread
    assert np.abs(got - want32).max() <= 2 * spread


def test_stride2_padding_is_jax_same(forward_runs, monkeypatch):
    """At 64x64 every stride-2 3x3 conv of stages 2-4 sees an even input, so
    'SAME' pads (0, 1): the port matches JAX within the f32 tolerance, and
    with torch's symmetric (1, 1) it would not."""
    assert resnet_mod.same_pads(56, 3, 2) == (0, 1)
    assert resnet_mod.same_pads(64, 3, 2) == (0, 1)
    assert resnet_mod.same_pads(7, 3, 2) == (1, 1)
    assert resnet_mod.same_pads(64, 1, 2) == (0, 0)
    assert resnet_mod.same_pads(64, 3, 1) == (1, 1)
    variables, x, want, _ = forward_runs(18)
    tol = F32_TOL * np.abs(want).max()
    assert np.abs(_port_logits(18, variables, x) - want).max() <= tol
    monkeypatch.setattr(resnet_mod, "same_pads",
                        lambda size, k, s: ((k - 1) // 2, (k - 1) // 2))
    assert np.abs(_port_logits(18, variables, x) - want).max() > 100 * tol


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_step_follows_flax(dtype):
    """One train-mode call on a (2, 7, 7, 16) batch (n = 98): output and
    running statistics as flax.linen.BatchNorm(momentum=0.9) computes them
    (f32 statistics: 1e-6 relative; output: one rounding to the dtype); the
    unbiased variance torch's nn.BatchNorm2d folds differs by n/(n-1)."""
    rng = np.random.default_rng(3)
    x = (2.0 * rng.standard_normal((2, 7, 7, 16)) + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.normal(0, 0.1, 16).astype(np.float32)
    jdt = {"float32": np.float32, "bfloat16": jax.numpy.bfloat16}[dtype]
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       dtype=jdt, param_dtype=np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": np.zeros(16, np.float32),
                                 "var": np.ones(16, np.float32)}}
    want, upd = bn.apply(variables, x.astype(jdt), mutable=["batch_stats"])
    port = BatchNorm2d(16).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2))
    assert got.dtype == tdt
    np.testing.assert_allclose(
        got.float().permute(0, 2, 3, 1).numpy(),
        np.asarray(want, np.float32),
        atol=1e-5 if dtype == "float32" else 2 ** -7 * 4, rtol=0)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(upd["batch_stats"][key]),
                                   rtol=1e-6, atol=1e-7)
    stock = torch.nn.BatchNorm2d(16, momentum=0.1).train()
    with torch.no_grad():
        stock(torch.from_numpy(x).permute(0, 3, 1, 2))
    rel = np.abs(stock.running_var.detach().numpy()
                 - np.asarray(upd["batch_stats"]["var"])).max() / 0.9
    assert rel > 1e-3  # 0.1 * var / (n - 1): 1% of the batch share


def test_train_forward_updates_batch_stats_as_flax():
    """A whole ResNet-18 train-mode forward (64x64, batch 4: the last stage
    normalises over n = 16): logits and every running statistic against
    flax's, 1e-4 relative (f32, the moments summed in other orders)."""
    x = _images(4, 64, seed=5)
    jm = _jax_model(18)
    variables = jax.device_get(jm.init(jax.random.key(0), x[:1]))
    want, upd = jm.apply(variables, x, train=True, mutable=["batch_stats"])
    model = _port_model(18, variables=variables).train()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    ref = from_jax_params((variables["params"], dict(upd)), model.cfg)
    for name, value in model.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(value.numpy(), ref[name].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("variant", ["batch", "ghost", "stale"])
def test_unported_bn_variants_raise(variant):
    with pytest.raises(NotImplementedError, match="Not ported"):
        create_model("resnet18", num_classes=3, device="cpu",
                     bn_variant=variant)


@pytest.mark.parametrize("name,depth", [("resnet18", 18), ("resnet34", 34),
                                        ("resnet50", 50), ("resnet101", 101),
                                        ("resnet152", 152), ("resnet", 152)])
def test_factory_builds_torchvision_layout(name, depth):
    """Every depth through create_model, keys in torchvision's layout
    (as jconvert.torch_resnet_to_flax reads them), no num_batches_tracked."""
    model = create_model(name, num_classes=7, device="cpu")
    assert isinstance(model, ResNet) and model.cfg.depth == depth
    keys = list(model.state_dict())
    assert keys[:5] == ["conv1.weight", "bn1.weight", "bn1.bias",
                        "bn1.running_mean", "bn1.running_var"]
    assert keys[-2:] == ["fc.weight", "fc.bias"]
    assert not any("num_batches_tracked" in k for k in keys)
    _, stages = resnet_mod._LAYOUTS[depth]
    for s, blocks in enumerate(stages, start=1):
        assert f"layer{s}.{blocks - 1}.conv1.weight" in keys
        assert f"layer{s}.{blocks}.conv1.weight" not in keys
    assert model.conv1.weight.is_contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# scratch init
# ---------------------------------------------------------------------------

INIT_CFG = ResNetConfig(depth=18, num_classes=16)
INIT_NAMES = list(ResNet(port_config(INIT_CFG), "float32", "cpu")
                  .state_dict())


@pytest.fixture(scope="module")
def init_leaves():
    variables = JaxResNet(INIT_CFG, compute_dtype="float32").init(
        jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32))
    cfg = port_config(INIT_CFG)
    jax_sd = from_jax_params(jax.device_get(variables), cfg)
    port_sd = ResNet(cfg, "float32", "cpu", seed=0).state_dict()
    return jax_sd, port_sd


def _flax_std(name, value):
    """flax's standard deviation of a random leaf (None for a constant):
    conv kernels variance_scaling(2, fan_out, normal), the head
    lecun_normal."""
    if value.dim() == 4:
        out, _, kh, kw = value.shape
        return (2.0 / (kh * kw * out)) ** 0.5
    if name == "fc.weight":
        return value.shape[1] ** -0.5
    return None


@pytest.mark.parametrize("name", INIT_NAMES)
def test_init_leaf_follows_flax(init_leaves, name):
    """Each leaf, seed 0: BN scale / running var one, BN bias / running
    mean / head bias zero (as flax puts them); a random leaf's mean within
    3 sigma/sqrt(n) of 0 and both packages' standard deviations within 10%
    of flax's; the head inside lecun's +-2 sigma/0.8796 truncation."""
    jax_sd, port_sd = init_leaves
    want, got = jax_sd[name], port_sd[name]
    assert got.shape == want.shape and got.dtype == torch.float32
    std = _flax_std(name, want)
    if std is None:
        assert torch.equal(got, want), name
        assert set(got.unique().tolist()) <= {0.0, 1.0}
        return
    n = got.numel()
    assert abs(got.mean().item()) <= 3 * std / n ** 0.5
    for leaf in (got, want):
        assert abs(leaf.std().item() / std - 1) <= 0.1
    if name == "fc.weight":
        assert got.abs().max().item() <= 2 * std / 0.87962566103423978


def test_init_zero_residual_and_seed():
    """zero_init_residual zeroes the last BN scale of every residual branch
    (not the downsample's), as the JAX model's scale_init; one seed gives
    one model, another seed another."""
    cfg = port_config(dataclasses.replace(INIT_CFG, zero_init_residual=True))
    sd = ResNet(cfg, "float32", "cpu", seed=0).state_dict()
    jax_sd = from_jax_params(jax.device_get(JaxResNet(
        dataclasses.replace(INIT_CFG, zero_init_residual=True),
        compute_dtype="float32").init(jax.random.key(0), np.zeros(
            (1, 32, 32, 3), np.float32))), cfg)
    for name in sd:
        if name.endswith(".weight") and sd[name].dim() == 1:
            zero = name.endswith("bn2.weight")
            assert bool((jax_sd[name] == 0).all()) == zero, name
            assert bool((sd[name] == 0).all()) == zero, name
    a, b = (ResNet(port_config(INIT_CFG), "float32", "cpu", seed=s)
            for s in (0, 0))
    c = ResNet(port_config(INIT_CFG), "float32", "cpu", seed=1)
    assert torch.equal(a.conv1.weight, b.conv1.weight)
    assert not torch.equal(a.conv1.weight, c.conv1.weight)


# ---------------------------------------------------------------------------
# torchvision-layout .pth
# ---------------------------------------------------------------------------

def torchvision_resnet18_sd(num_classes, seed=0):
    """A state dict with torchvision's resnet18 names and shapes (random
    values, BN statistics included, and the num_batches_tracked buffers
    torchvision writes)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[name + ".weight"] = torch.randn(o, i, k, k, generator=g) * 0.05

    def bn(name, c):
        sd[name + ".weight"] = torch.rand(c, generator=g) + 0.5
        sd[name + ".bias"] = torch.randn(c, generator=g) * 0.1
        sd[name + ".running_mean"] = torch.randn(c, generator=g) * 0.1
        sd[name + ".running_var"] = torch.rand(c, generator=g) + 0.5
        sd[name + ".num_batches_tracked"] = torch.tensor(7)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    widths = [64, 128, 256, 512]
    for s, w in enumerate(widths, start=1):
        for b in range(2):
            pre = f"layer{s}.{b}"
            w_in = w if (b > 0 or s == 1) else widths[s - 2]
            conv(f"{pre}.conv1", w, w_in, 3)
            bn(f"{pre}.bn1", w)
            conv(f"{pre}.conv2", w, w, 3)
            bn(f"{pre}.bn2", w)
            if s > 1 and b == 0:
                conv(f"{pre}.downsample.0", w, w_in, 1)
                bn(f"{pre}.downsample.1", w)
    sd["fc.weight"] = torch.randn(num_classes, 512, generator=g) * 0.05
    sd["fc.bias"] = torch.randn(num_classes, generator=g) * 0.05
    return sd


@pytest.mark.parametrize("pth_classes", [N_CLASSES, 9])
def test_pth_loads_to_the_same_logits(tmp_path, pth_classes):
    """One torchvision-layout .pth (saved as the reference saves it, in a
    dict under 'model'): the JAX converter + model and the port's loader +
    model give the same f32 logits; with another class count both draw the
    same fresh head."""
    path = tmp_path / "resnet18.pth"
    torch.save({"model": torchvision_resnet18_sd(pth_classes)}, path)
    x = _images(2, 64, seed=2)
    params, state = jconvert.torch_resnet_to_flax(
        jconvert._normalize_ckpt(str(path)), N_CLASSES)
    want = np.asarray(_jax_model(18).apply({"params": params, **state}, x))
    model = _port_model(18)
    model.load_state_dict(load_resnet_weights(str(path), model.cfg))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F32_TOL * np.abs(want).max())


# ---------------------------------------------------------------------------
# the train step against the JAX Trainer
# ---------------------------------------------------------------------------

STEPS = 5
TRAIN_MODEL = ResNetConfig(depth=18, num_classes=4, image_size=64)
LR = 1e-4


def _train_cfg(tmp, lr=LR):
    return TrainConfig(
        train_id="resnet_parity", model_type="resnet18", global_batch_size=8,
        seed=0, optimizer=OptimizerConfig(name="sgd", learning_rate=lr,
                                          momentum=0.9),
        augment=AugmentConfig(enable_augmentation=False),
        mix=MixConfig(enable_mixup=False),
        checkpoint=CheckpointConfig(directory=str(tmp / "c"),
                                    async_save=False),
        log_dir=str(tmp / "l"))


def _batches(n=STEPS, seed=0, size=64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        base = rng.integers(0, 200, (8, 1, 1, 3))
        noise = rng.integers(0, 56, (8, size, size, 3))
        out.append({"image": (base + noise).astype(np.uint8),
                    "label": rng.integers(0, 4, 8).astype(np.int32),
                    "mask": np.ones(8, bool)})
    return out


def _port_trainer(tmp, variables, lr=LR, model_cfg=TRAIN_MODEL):
    cfg = port_config(model_cfg)
    model = ResNet(cfg, "float32", "cpu", param_dtype="float32")
    return Trainer(port_config(_train_cfg(tmp, lr)), model=model,
                   device="cpu", init_params=from_jax_params(variables, cfg))


@pytest.fixture(scope="module")
def trajectory(tmp_path_factory):
    """{step: {run: (metrics, state as a port state dict)}} at steps 1 and
    STEPS, for the JAX Trainer, the JAX Trainer from parameters nudged by
    one f32 ulp (``nextafter`` towards +inf), and the port's Trainer."""
    import jax.numpy as jnp

    tmp = tmp_path_factory.mktemp("resnet_train")
    mesh = create_mesh(num_data=1, devices=jax.devices()[:1])
    runs = {}
    for name in ("jax", "nudged"):
        jt = JaxTrainer(_train_cfg(tmp), model=JaxResNet(
            TRAIN_MODEL, compute_dtype="float32"), mesh=mesh)
        jstate = jt.init_state(4)
        if name == "nudged":
            jstate = jstate.replace(params=jax.tree_util.tree_map(
                lambda p: jnp.nextafter(p, jnp.inf), jstate.params))
        runs[name] = (jt._make_train_step(), jstate)
    variables = jax.device_get({"params": runs["jax"][1].params,
                                **runs["jax"][1].model_state})
    pt = _port_trainer(tmp, variables)
    pstate = pt.init_state(4)
    out = {}
    for i, batch in enumerate(_batches(), start=1):
        record = {}
        for name, (step, jstate) in runs.items():
            jstate, jm = step(jstate, jax.device_put(batch,
                                                     data_sharding(mesh)))
            runs[name] = (step, jstate)
            record[name] = ({k: float(v) for k, v in jm.items()},
                            from_jax_params(jax.device_get(
                                (jstate.params, jstate.model_state)),
                                port_config(TRAIN_MODEL)))
        pm = pt.train_step(pstate, pt.stage(batch))
        record["port"] = (pm, {k: v.clone() for k, v in
                               pstate.model.state_dict().items()})
        if i in (1, STEPS):
            out[i] = record
    assert pstate.step == STEPS
    return out


def _spread(a, b):
    """Largest |difference| of any leaf, and of the loss and grad norm."""
    leaves = max((a[1][k] - b[1][k]).abs().max().item() for k in a[1])
    scalars = {k: abs(a[0][k] - b[0][k]) for k in ("loss", "grad_norm")}
    return leaves, scalars


def test_train_step_matches_jax_trainer(trajectory):
    """One SGD step (lr 1e-4, momentum 0.9), f32, BN in train mode: loss
    and grad_norm within 1e-5 relative, every parameter and BN statistic
    within 1e-5 absolute and relative (summation order)."""
    (jm, want), (pm, got) = trajectory[1]["jax"], trajectory[1]["port"]
    np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(pm["grad_norm"], jm["grad_norm"], rtol=1e-5)
    assert want.keys() == got.keys()
    assert sum("running" in k for k in want) == 2 * 20
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=1e-5, rtol=1e-5,
                                   msg=k)


def test_five_steps_stay_within_the_references_own_spread(trajectory):
    """After 5 steps: a random-init ResNet at batch 8 amplifies rounding
    from step to step (the JAX Trainer started one ulp away drifts from
    itself by ~10x a step, its grad norm by a percent by step 5), so the
    port is held to the reference's own spread: every parameter and BN
    statistic, the loss and the grad norm within 4x the JAX-vs-nudged-JAX
    difference."""
    record = trajectory[STEPS]
    ref_leaves, ref_scalars = _spread(record["jax"], record["nudged"])
    leaves, scalars = _spread(record["jax"], record["port"])
    assert 0 < ref_leaves
    assert leaves <= max(4 * ref_leaves, 1e-5)
    for k, v in scalars.items():
        assert v <= max(4 * ref_scalars[k], 1e-5 * record["jax"][0][k]), k


def test_nan_guard_keeps_bn_statistics(tmp_path):
    """A step whose loss is not finite leaves parameters, optimizer state
    and every BN running statistic as they were; step still advances."""
    variables = jax.device_get(JaxResNet(TRAIN_MODEL, compute_dtype="float32")
                               .init(jax.random.key(0),
                                     np.zeros((1, 32, 32, 3), np.float32)))
    trainer = _port_trainer(tmp_path, variables)
    state = trainer.init_state(4)
    good, = _batches(1)
    trainer.train_step(state, trainer.stage(good))
    assert state.optimizer.count == 1
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    moments = {id(p): {k: v.clone() for k, v in s.items()}
               for p, s in state.optimizer.inner.state.items()}
    with torch.no_grad():
        state.model.fc.weight.mul_(float("inf"))
    before["fc.weight"] = state.model.fc.weight.detach().clone()
    metrics = trainer.train_step(state, trainer.stage(good))
    assert not np.isfinite(metrics["loss"])
    after = state.model.state_dict()
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    assert state.optimizer.count == 1 and state.step == 2
    for p, s in state.optimizer.inner.state.items():
        for k, v in s.items():
            assert torch.equal(v, moments[id(p)][k]), k


def test_nan_image_step_restores_bn_statistics(tmp_path):
    """A NaN pixel poisons the batch statistics of every BN the forward
    reaches: the skipped step puts the running statistics back."""
    variables = jax.device_get(JaxResNet(TRAIN_MODEL, compute_dtype="float32")
                               .init(jax.random.key(0),
                                     np.zeros((1, 32, 32, 3), np.float32)))
    trainer = _port_trainer(tmp_path, variables)
    state = trainer.init_state(4)
    good, = _batches(1)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    staged = trainer.stage(good)
    staged["image"] = staged["image"].float()
    staged["image"][0, 0, 0, 0] = float("nan")
    metrics = trainer.train_step(state, staged)
    assert not np.isfinite(metrics["loss"])
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    metrics = trainer.train_step(state, trainer.stage(good))
    assert np.isfinite(metrics["loss"])
    assert not torch.equal(state.model.bn1.running_var, before["bn1.running_var"])


# ---------------------------------------------------------------------------
# fit with exact resume, and the resnet_train CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_image_folder(str(tmp_path_factory.mktemp("resnet_data")),
                             num_classes=4, per_class=12, size=40)


class KillAtBatch:
    """A loader that sends this process SIGTERM when batch ``n`` of the run
    is asked for, once."""

    def __init__(self, loader, n):
        self.loader, self.n, self.count = loader, n, 0

    def steps_per_epoch(self):
        return self.loader.steps_per_epoch()

    def set_epoch(self, *args):
        self.loader.set_epoch(*args)

    def __iter__(self):
        for batch in self.loader:
            if self.count == self.n:
                os.kill(os.getpid(), signal.SIGTERM)
            self.count += 1
            yield batch


def test_fit_resume_is_bit_exact(dataset, tmp_path):
    """ResNet-18 at 32x32, 2 epochs of 4 steps: a run killed after batch 3
    and resumed ends with every parameter and BN statistic equal to an
    uninterrupted run's (the BN statistics travel in the checkpoint)."""
    from touhouimageclassification_tpu_torch.data import (image_loader,
                                                         random_split,
                                                         scan_image_folder)

    index = scan_image_folder(dataset)
    tr, va = random_split(len(index), 0.75, 0)

    def loaders():
        return (image_loader(index, tr, batch_size=8, canvas=(32, 32),
                             shuffle=True, seed=0, drop_last=True),
                image_loader(index, va, batch_size=8, canvas=(32, 32),
                             shuffle=False, drop_last=False))

    def trainer(run):
        cfg = dataclasses.replace(_train_cfg(tmp_path / run, lr=5e-2),
                                  max_epochs=2, train_id="fit")
        model = ResNet(port_config(dataclasses.replace(
            TRAIN_MODEL, image_size=32)), "float32", "cpu",
            param_dtype="float32", seed=0)
        return Trainer(port_config(cfg), model=model, device="cpu")

    train, val = loaders()
    control = trainer("control")
    control.fit(train, val, resume=False)
    killed = trainer("resumed")
    assert killed.fit(KillAtBatch(train, 3), val, resume=False) == []
    resumed = trainer("resumed")
    history = resumed.fit(train, val, resume=True)
    assert [r["epoch"] for r in history] == [1, 2]
    assert resumed.state.step == control.state.step == 2 * 4
    want = control.state.model.state_dict()
    for k, v in resumed.state.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_resnet_train_cli_transform_serve(dataset, tmp_path, monkeypatch):
    """``resnet_train --depth 18 --device cpu`` for one epoch of the
    resnet152 preset (SGD, step schedule, 256x256, dataset statistics), then
    ``--transform`` to a serving export whose meta carries the ResNet
    config, then serve --full from it: the same predictions as a Predictor
    on the trained model; init(modelt='resnet') falls back to the registry
    path."""
    monkeypatch.chdir(tmp_path)
    base = ["--depth", "18", "--data-dir", dataset, "--batch-size", "16",
            "--max-epochs", "1", "--device", "cpu", "--seed", "0"]
    trainer = resnet_train.main([*base, "--no-resume"])
    assert trainer.state.step == 2 and trainer.out_size == (256, 256)
    assert trainer.cfg.optimizer.name == "sgd"
    assert trainer.cfg.optimizer.schedule == "step"
    export = tmp_path / "export"
    resnet_train.main([*base, "--transform", str(export)])
    meta = json.loads((export / "serving_meta.json").read_text())
    assert meta["model_type"] == "resnet152"
    assert meta["resnet_config"]["depth"] == 18
    assert meta["resnet_config"]["num_classes"] == 4
    assert "vit_config" not in meta
    assert meta["mean"] == list(trainer.cfg.augment.mean)
    out = tmp_path / "judge.csv"
    serve.main(["--model", "resnet", "--weights", str(export), "--image",
                dataset, "--data-dir", dataset, "--output", str(out),
                "--full", "--canvas-cache", "off", "--device", "cpu"])
    with open(out, newline="") as f:
        rows = list(csv.reader(f))[1:]
    assert len(rows) == 48
    model = create_model("resnet18", num_classes=4, device="cpu")
    model.load_state_dict(trainer.state.model.state_dict())
    pred = serve.Predictor(model=model, class_to_idx=meta["class_to_idx"],
                           image_size=(256, 256), mean=meta["mean"],
                           std=meta["std"], device=torch.device("cpu"))
    mem = tmp_path / "mem.csv"
    serve.full_judge(pred, dataset, str(mem), progress=False,
                     canvas_cache="off")
    with open(mem, newline="") as f:
        assert [r[1] for r in rows] == [r[1] for r in list(csv.reader(f))[1:]]
    monkeypatch.setitem(serve.model_checkpoints, "resnet", str(export))
    with contextlib.redirect_stdout(None):
        predictor = serve.init(modelt="resnet", data_dir=dataset,
                               device="cpu")
    assert isinstance(predictor.model, ResNet)
    assert predictor.image_size == (256, 256)
