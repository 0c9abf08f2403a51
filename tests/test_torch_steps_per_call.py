"""``TrainConfig.steps_per_call = k``: k train steps a call in the port's
Trainer, against k single steps and against the JAX package's ``lax.scan``
of its step, on the CPU.

- ``Trainer.train_steps`` on k batches leaves the parameters, the
  optimizer's state and counters and ``step`` bit for bit where k
  ``train_step`` calls leave them (AdamW with clipping and a warm-up
  schedule, SGD, 2-step accumulation; augmentation and CutMix/MixUp on),
  with one device -> host copy, and returns the means of their metrics;
- the mirror of ``tests/test_scan_training.py``: the scan of 4 steps
  against ``train_steps`` from the same parameters, within 1e-5, and
  ``fit`` with k = 2;
- a NaN batch inside a call: with the guard, skipped on the device (the
  step advances, nothing else moves) and the rest of the call as the
  single steps and JAX's scan train it; without it, committed as JAX
  commits it;
- ``fit``: equal to k = 1, a partial last group dropped with JAX's warning
  and the schedule counted without it, ``limit_train_batches`` counted in
  loader batches as JAX counts them, and the mirror of
  ``tests/test_train_e2e.py``'s preemption and resume with k = 2,
  bit-identical to the uninterrupted control.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from fixtures import make_image_folder
from test_torch_copies import port_config
from test_torch_fit import KillAtBatch
from touhouimageclassification_tpu.config import (AugmentConfig,
                                                  CheckpointConfig, MixConfig,
                                                  OptimizerConfig,
                                                  ResNetConfig, TrainConfig,
                                                  ViTConfig)
from touhouimageclassification_tpu.data.folder import (
    random_split as jax_random_split, scan_image_folder as jax_scan)
from touhouimageclassification_tpu.data.loader import (
    HostImageLoader as JaxLoader)
from touhouimageclassification_tpu.models.vit import ViT as JaxViT
from touhouimageclassification_tpu.parallel.mesh import create_mesh
from touhouimageclassification_tpu.train.trainer import Trainer as JaxTrainer
from touhouimageclassification_tpu_torch.data import (image_loader,
                                                     random_split,
                                                     scan_image_folder)
from touhouimageclassification_tpu_torch.models.resnet import ResNet
from touhouimageclassification_tpu_torch.models.vit import ViT
from touhouimageclassification_tpu_torch.train.trainer import Trainer
from touhouimageclassification_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)

TINY = ViTConfig(image_size=16, patch_size=8, hidden_size=16, num_layers=1,
                 num_heads=2, mlp_dim=32, num_classes=4)
TINY_RESNET = ResNetConfig(depth=18, num_classes=4, image_size=16)
K = 4

OPTIMIZERS = {
    "adamw": OptimizerConfig(name="adamw", learning_rate=1e-2,
                             weight_decay=0.05, max_grad_norm=1.0,
                             schedule="warmup_linear", warmup_steps=2,
                             total_steps=10),
    "sgd": OptimizerConfig(name="sgd", learning_rate=1e-2),
    "adamw_accum2": OptimizerConfig(name="adamw", learning_rate=1e-2,
                                    grad_accum_steps=2),
}


def _cfg(tmp_path, **over):
    base = dict(
        train_id="scan_run", model_type="vit-base", global_batch_size=8,
        seed=0, max_epochs=1,
        optimizer=OptimizerConfig(name="sgd", learning_rate=1e-2),
        augment=AugmentConfig(enable_augmentation=False),
        mix=MixConfig(enable_mixup=False),
        checkpoint=CheckpointConfig(directory=str(tmp_path / "c"),
                                    async_save=False),
        log_dir=str(tmp_path / "l"), early_stop_patience=0)
    base.update(over)
    return TrainConfig(**base)


def _batches(n, b=8, poison=None, size=16):
    """Seeded batches; ``poison`` makes batch ``poison`` carry a NaN pixel
    (float images, integer-valued elsewhere)."""
    rng = np.random.default_rng(0)
    out = [{"image": rng.integers(0, 256, (b, size, size, 3)).astype(
                np.uint8 if poison is None else np.float32),
            "label": (np.arange(b) % 4).astype(np.int32),
            "mask": np.ones((b,), bool)} for _ in range(n)]
    if poison is not None:
        out[poison]["image"][0, 0, 0, 0] = np.nan
    return out


def _port_trainer(cfg, variables=None, seed=0, family="vit"):
    if family == "vit":
        pcfg = port_config(TINY)
        model = ViT(pcfg, "float32", "cpu", param_dtype="float32", seed=seed)
    else:
        pcfg = port_config(TINY_RESNET)
        model = ResNet(pcfg, "float32", "cpu", param_dtype="float32",
                       seed=seed)
    init = (None if variables is None
            else from_jax_params(jax.device_get(variables), pcfg))
    return Trainer(port_config(cfg), model=model, device="cpu",
                   init_params=init)


def _state(trainer):
    """Parameters, floating buffers (a ResNet's BatchNorm running
    statistics), optimizer tensors and host counters of a trainer."""
    opt = trainer.state.optimizer
    tensors = {f"param:{k}": v.detach().clone()
               for k, v in trainer.state.model.named_parameters()}
    tensors.update({f"buffer:{k}": v.clone()
                    for k, v in trainer.state.model.named_buffers()
                    if v.is_floating_point()})
    names = {id(p): k for k, p in trainer.state.model.named_parameters()}
    for p, s in opt.inner.state.items():
        for key, v in s.items():
            tensors[f"{key}:{names[id(p)]}"] = v.clone()
    for i, a in enumerate(opt.acc or []):
        tensors[f"acc:{i}"] = a.clone()
    return tensors, (trainer.state.step, opt.count, opt.mini_step)


def _assert_close_to_jax(params, want, updates, lr=1e-2):
    """Every parameter within 1e-5 (absolute and relative) of JAX's; the key
    third of a qkv bias, whose true gradient is zero and whose AdamW updates
    are rounding's sign, within the size of ``updates`` updates."""
    c = TINY.hidden_size
    for k, p in params:
        g, w = p.detach().clone(), want[k].clone()
        kb = slice(c, 2 * c) if k.endswith("attn.qkv.bias") else slice(0, 0)
        assert np.abs((g[kb] - w[kb]).numpy()).max(initial=0.0) <= (
            2 * lr * updates), k
        g[kb] = w[kb] = 0.0
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5, msg=k)


def _assert_same(a, b):
    assert a[1] == b[1]
    assert a[0].keys() == b[0].keys()
    for k, v in a[0].items():
        assert torch.equal(v, b[0][k]), k


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("augmented", [False, True])
def test_k_steps_equal_k_single_steps(tmp_path, opt, augmented):
    """train_steps on 4 batches against 4 train_step calls from the same
    seeded model: every tensor and counter bit for bit, one host copy, and
    the metrics the single steps' means."""
    over = dict(optimizer=OPTIMIZERS[opt])
    if augmented:
        over.update(augment=AugmentConfig(), mix=MixConfig())
    batches = _batches(K)
    single = _port_trainer(_cfg(tmp_path, **over))
    single.init_state(4)
    per_step = [single.train_step(single.state, single.stage(b))
                for b in batches]
    grouped = _port_trainer(_cfg(tmp_path, steps_per_call=K, **over))
    grouped.init_state(4)
    means = grouped.train_steps(grouped.state,
                                [grouped.stage(b) for b in batches])
    assert grouped.host_syncs == 1 and single.host_syncs == K
    _assert_same(_state(grouped), _state(single))
    assert means.keys() == per_step[0].keys()
    for k, v in means.items():
        assert v == np.mean([m[k] for m in per_step]), k


def _jax_scan(cfg, batches, k=K):
    """(JAX state after one scan of k steps, its fetched metrics,
    variables it started from)."""
    mesh = create_mesh(num_data=1, devices=jax.devices()[:1])
    jt = JaxTrainer(cfg, model=JaxViT(TINY, compute_dtype="float32"),
                    mesh=mesh)
    state = jt.init_state(4)
    # the scan donates its input state
    start = {"params": jax.device_get(state.params)}
    stacked = {key: np.stack([b[key] for b in batches]) for key in batches[0]}
    state, metrics = jt._make_train_scan(k)(state, stacked)
    return state, {k: float(v) for k, v in metrics.items()}, start


def test_scan_equals_train_steps(tmp_path):
    """The mirror of ``test_scan_equals_sequential``: JAX's scan of 4 SGD
    steps and the port's train_steps from the same parameters: parameters
    within 1e-5 (JAX's test holds its scan to its own steps at 1e-6; two
    frameworks sum in other orders), step 4, the metrics (JAX's means)
    within 1e-5."""
    batches = _batches(K)
    jstate, jm, start = _jax_scan(_cfg(tmp_path, steps_per_call=K), batches)
    pt = _port_trainer(_cfg(tmp_path, steps_per_call=K), start)
    pt.init_state(4)
    pm = pt.train_steps(pt.state, [pt.stage(b) for b in batches])
    assert int(jstate.step) == pt.state.step == K
    want = from_jax_params(jax.device_get(jstate.params), port_config(TINY))
    _assert_close_to_jax(pt.state.model.named_parameters(), want, K)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-5)


@pytest.mark.parametrize("nan_guard", [True, False])
@pytest.mark.parametrize("opt", ["sgd", "adamw_accum2"])
def test_nan_batch_inside_a_call(tmp_path, nan_guard, opt):
    """Batch 1 of 4 carries a NaN pixel. With the guard, train_steps skips
    it on the device: the state equals 4 single steps' bit for bit (the
    optimizer moved 3 times, step 4) and JAX's scan within 1e-5, and the
    loss mean is NaN in both (the skipped step's loss is in it). Without
    it, the NaN is committed: every parameter non-finite in both."""
    batches = _batches(K, poison=1)
    over = dict(optimizer=OPTIMIZERS[opt], nan_guard=nan_guard,
                steps_per_call=K)
    jstate, jm, start = _jax_scan(_cfg(tmp_path, **over), batches)
    grouped = _port_trainer(_cfg(tmp_path, **over), start)
    grouped.init_state(4)
    pm = grouped.train_steps(grouped.state,
                             [grouped.stage(b) for b in batches])
    assert np.isnan(pm["loss"]) and np.isnan(jm["loss"])
    assert grouped.state.step == int(jstate.step) == K
    want = from_jax_params(jax.device_get(jstate.params), port_config(TINY))
    params = dict(grouped.state.model.named_parameters())
    if not nan_guard:
        assert not any(torch.isfinite(p).all() for p in params.values())
        assert not any(np.isfinite(w.numpy()).all() for w in want.values())
        return
    _assert_close_to_jax(params.items(), want, K)
    single = _port_trainer(_cfg(tmp_path, **over), start)
    single.init_state(4)
    for b in batches:
        single.train_step(single.state, single.stage(b))
    _assert_same(_state(grouped), _state(single))
    updates = 3 if opt == "sgd" else 1   # 3 micro-steps, one window of 2
    assert grouped.state.optimizer.count == updates


@pytest.mark.parametrize("family", ["vit", "resnet"])
def test_skipped_step_moves_nothing_on_the_device(tmp_path, family):
    """A call of 2 whose last batch is poisoned: the first step commits,
    the second leaves every parameter, moment, counter and (for the ResNet,
    whose forward moves them in place) BatchNorm running statistic where
    the first left them, and step still advances."""
    batches = _batches(2, poison=1)
    cfg = _cfg(tmp_path, steps_per_call=2, optimizer=OPTIMIZERS["adamw"],
               model_type="vit-base" if family == "vit" else "resnet18")
    ref = _port_trainer(cfg, family=family)
    ref.init_state(4)
    ref.train_step(ref.state, ref.stage(batches[0]))
    got = _port_trainer(cfg, family=family)
    got.init_state(4)
    m = got.train_steps(got.state, [got.stage(b) for b in batches])
    assert np.isnan(m["loss"])
    want = _state(ref)
    _assert_same(_state(got), (want[0], (2, *want[1][1:])))


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_image_folder(str(tmp_path_factory.mktemp("scan_data")),
                             num_classes=4, per_class=8, size=20)


def _loader(dataset, make_index=scan_image_folder, loader=image_loader):
    index = make_index(dataset)
    return loader(index, np.arange(len(index)), batch_size=8,
                  canvas=(16, 16), shuffle=True, seed=0, drop_last=True)


def test_fit_with_steps_per_call(dataset, tmp_path):
    """The mirror of ``test_fit_with_steps_per_call``: 2 epochs at k = 2
    train every group; the parameters equal k = 1's fit bit for bit and
    JAX's k = 2 fit within 1e-5, the train losses JAX's within 1e-5."""
    cfg = _cfg(tmp_path / "k2", steps_per_call=2, max_epochs=2)
    mesh = create_mesh(num_data=1, devices=jax.devices()[:1])
    jt = JaxTrainer(_cfg(tmp_path / "jax", steps_per_call=2, max_epochs=2),
                    model=JaxViT(TINY, compute_dtype="float32"), mesh=mesh)
    j_hist = jt.fit(_loader(dataset, jax_scan, JaxLoader), None, resume=False)
    init = JaxViT(TINY, compute_dtype="float32").init(
        jax.random.key(0), np.zeros((1, 16, 16, 3), np.float32))
    tr = _port_trainer(cfg, init)
    hist = tr.fit(_loader(dataset), None, resume=False)
    assert len(hist) == 2
    spe = _loader(dataset).steps_per_epoch()
    assert tr.state.step == 2 * (spe // 2 * 2) == int(jt.state.step)
    for got, want in zip(hist, j_hist):
        np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                                   rtol=1e-5)
    want = from_jax_params(jax.device_get(jt.state.params),
                           port_config(TINY))
    _assert_close_to_jax(tr.state.model.named_parameters(), want,
                         tr.state.step)
    one = _port_trainer(_cfg(tmp_path / "k1", max_epochs=2), init)
    one.fit(_loader(dataset), None, resume=False)
    for (k, p), q in zip(tr.state.model.named_parameters(),
                         one.state.model.parameters()):
        assert torch.equal(p, q), k


def test_partial_group_is_dropped_with_jax_warning(dataset, tmp_path,
                                                   caplog):
    """4 steps an epoch at k = 3: one group an epoch, the last batch
    dropped with JAX's warning; the warm-up schedule's horizon counts the 3
    trained steps, as JAX's does."""
    opt = OptimizerConfig(name="adamw", learning_rate=1e-2,
                          schedule="warmup_linear", warmup_steps=1)
    cfg = _cfg(tmp_path, steps_per_call=3, max_epochs=2, optimizer=opt)
    tr = _port_trainer(cfg)
    tr.fit(_loader(dataset), None, resume=False)
    assert tr.state.step == 2 * 3
    log = caplog.text
    assert ("steps_per_call=3 does not divide 4 steps/epoch: the last 1 "
            "batch(es) of every epoch are dropped (drop_last-style; "
            "reshuffled each epoch)") in log
    assert tr.state.optimizer.cfg.total_steps == 2 * 3


def test_limit_train_batches_counts_loader_batches(dataset, tmp_path):
    """limit_train_batches=3 at k = 2 (4 batches an epoch): JAX checks the
    limit before each group on the loader batches trained so far, so both
    train two groups."""
    mesh = create_mesh(num_data=1, devices=jax.devices()[:1])
    jt = JaxTrainer(_cfg(tmp_path / "jax", steps_per_call=2,
                         limit_train_batches=3),
                    model=JaxViT(TINY, compute_dtype="float32"), mesh=mesh)
    jt.fit(_loader(dataset, jax_scan, JaxLoader), None, resume=False)
    tr = _port_trainer(_cfg(tmp_path / "port", steps_per_call=2,
                            limit_train_batches=3))
    tr.fit(_loader(dataset), None, resume=False)
    assert tr.state.step == int(jt.state.step) == 4


def test_preemption_resume_with_steps_per_call(tmp_path):
    """The mirror of ``test_preemption_resume_with_scan_fused_steps``:
    k = 2, SIGTERM when batch 3 is asked for, the resumed run regroups from
    the saved offset (a multiple of k) and ends bit-identical to the
    uninterrupted control."""
    data = make_image_folder(str(tmp_path / "d"), num_classes=4,
                             per_class=16, size=48)
    index = scan_image_folder(data)
    tr_idx, va_idx = random_split(len(index), 0.75, 0)

    def loaders():
        return (image_loader(index, tr_idx, batch_size=8, canvas=(16, 16),
                             shuffle=True, seed=0, drop_last=True),
                image_loader(index, va_idx, batch_size=8, canvas=(16, 16),
                             shuffle=False, drop_last=False))

    cfg = _cfg(tmp_path / "run", max_epochs=2, steps_per_call=2,
               optimizer=OPTIMIZERS["adamw"])
    train, val = loaders()
    assert _port_trainer(cfg).fit(KillAtBatch(train, 3), val,
                                  resume=False) == []
    resumed = _port_trainer(cfg)
    history = resumed.fit(train, val, resume=True)
    assert [r["epoch"] for r in history] == [1, 2]
    control = _port_trainer(dataclasses.replace(
        cfg, checkpoint=dataclasses.replace(
            cfg.checkpoint, directory=str(tmp_path / "control" / "c")),
        log_dir=str(tmp_path / "control" / "l")))
    h_control = control.fit(*loaders(), resume=False)
    assert history[0]["train_loss"] != h_control[0]["train_loss"]
    assert resumed.state.step == control.state.step
    for (k, p), q in zip(resumed.state.model.named_parameters(),
                         control.state.model.parameters()):
        assert torch.equal(p, q), k
