"""``Trainer.fit`` of the port against the JAX package's, and the epoch
loop's resume and early-stop rules, on the CPU.

Parity: JAX's ``Trainer.fit`` (one-device CPU mesh) and the port's run 2
epochs of 6 steps of the tiny f32 ViT of ``test_train_e2e.py`` from the
same parameters (``from_jax_params``) on the same 4-class fixture, with
augmentation and mixup off (the two packages draw from different random
streams by design; ``test_torch_train.py`` holds the augmented step's
reproducibility). Each epoch's train_loss, val_loss and val_acc agree
within rtol 1e-4, and the final parameters within 1e-5 absolute and
relative, as ``test_train_steps_match_jax_trainer`` holds them: f32
summation order, carried through 12 AdamW updates. The key third of each
qkv bias, whose true gradient is zero, is held to the size of the updates
(2 x lr a step) instead.

The rest mirrors the JAX package's loop tests on the port alone
(``test_train_e2e.py``, ``test_trainer_edges.py``): SIGTERM preemption and
exact resume, stale and orphan partial saves, preemption in an epoch's
last step, accumulation resumed mid-window, early-stop state across a
resume, and the CLI's ``--test`` and empty-val-split rules.
"""
import dataclasses
import json
import os
import shutil
import signal

import jax
import numpy as np
import pytest
import torch

from fixtures import make_image_folder
from test_torch_copies import port_config
from touhouimageclassification_tpu.config import (AugmentConfig,
                                                  CheckpointConfig, MixConfig,
                                                  OptimizerConfig, TrainConfig,
                                                  ViTConfig)
from touhouimageclassification_tpu.data.folder import (
    random_split as jax_random_split, scan_image_folder as jax_scan)
from touhouimageclassification_tpu.data.loader import (
    HostImageLoader as JaxLoader)
from touhouimageclassification_tpu.models.vit import ViT as JaxViT
from touhouimageclassification_tpu.parallel.mesh import create_mesh
from touhouimageclassification_tpu.train.trainer import Trainer as JaxTrainer
from touhouimageclassification_tpu.train.trainer import (
    window_early_exit as jax_window_early_exit)
from touhouimageclassification_tpu_torch.data import (image_loader,
                                                     random_split,
                                                     scan_image_folder)
from touhouimageclassification_tpu_torch.models.vit import ViT
from touhouimageclassification_tpu_torch.train import cli
from touhouimageclassification_tpu_torch.train.checkpoint import (
    CheckpointManager)
from touhouimageclassification_tpu_torch.train.trainer import Trainer
from touhouimageclassification_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)

N_CLASSES = 4
TINY = ViTConfig(image_size=32, patch_size=8, hidden_size=32, num_layers=2,
                 num_heads=2, mlp_dim=64, num_classes=N_CLASSES)
LR = 1e-3
EPOCHS = 2


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("fit_data")
    return make_image_folder(str(root), num_classes=N_CLASSES, per_class=16,
                             size=48)


def _cfg(tmp_path, **over):
    defaults = dict(
        train_id="fit_run", model_type="vit-base", global_batch_size=8,
        max_epochs=EPOCHS, seed=0,
        optimizer=OptimizerConfig(name="adamw", learning_rate=LR,
                                  weight_decay=0.0),
        augment=AugmentConfig(enable_augmentation=False),
        mix=MixConfig(enable_mixup=False),
        checkpoint=CheckpointConfig(directory=str(tmp_path / "ckpt"), top_k=2,
                                    monitor="val_acc", every_n_epochs=1,
                                    async_save=False),
        log_dir=str(tmp_path / "log"), early_stop_patience=0)
    defaults.update(over)
    return TrainConfig(**defaults)


def _loaders(dataset, make_index=scan_image_folder, split=random_split,
             loader=image_loader):
    index = make_index(dataset)
    tr, va = split(len(index), 0.75, 0)
    return (loader(index, tr, batch_size=8, canvas=(48, 48), shuffle=True,
                   seed=0, drop_last=True),
            loader(index, va, batch_size=8, canvas=(48, 48), shuffle=False,
                   drop_last=False))


def _trainer(cfg, model_cfg=TINY, init_params=None):
    model = ViT(port_config(model_cfg), "float32", "cpu",
                param_dtype="float32", seed=0)
    return Trainer(port_config(cfg), model=model, device="cpu",
                   init_params=init_params)


def _params(trainer):
    return {k: p.detach().clone()
            for k, p in trainer.state.model.named_parameters()}


def _records(cfg):
    with open(os.path.join(cfg.log_dir, cfg.train_id, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def fits(dataset, tmp_path_factory):
    """(JAX history, JAX final params in the port's layout, port history,
    port final params, port metrics.jsonl records)."""
    tmp = tmp_path_factory.mktemp("parity")
    cfg = _cfg(tmp / "jax")
    mesh = create_mesh(num_data=1, devices=jax.devices()[:1])
    jt = JaxTrainer(cfg, model=JaxViT(TINY, compute_dtype="float32"),
                    mesh=mesh)
    j_hist = jt.fit(*_loaders(dataset, jax_scan, jax_random_split,
                              JaxLoader), resume=False)
    j_params = from_jax_params(jax.device_get(jt.state.params),
                               port_config(TINY))
    init = JaxViT(TINY, compute_dtype="float32").init(
        jax.random.key(cfg.seed), np.zeros((1, 32, 32, 3), np.float32))
    pcfg = _cfg(tmp / "port")
    pt = _trainer(pcfg, init_params=from_jax_params(jax.device_get(init),
                                                    port_config(TINY)))
    p_hist = pt.fit(*_loaders(dataset), resume=False)
    return j_hist, j_params, p_hist, _params(pt), _records(pcfg)


@pytest.mark.parametrize("epoch", range(EPOCHS))
def test_fit_epoch_metrics_match_jax(fits, epoch):
    j_hist, _, p_hist, _, records = fits
    assert len(j_hist) == len(p_hist) == EPOCHS
    assert p_hist[epoch].keys() == j_hist[epoch].keys()
    assert records[epoch] == p_hist[epoch]
    for key in ("train_loss", "val_loss", "val_acc", "grad_norm"):
        np.testing.assert_allclose(p_hist[epoch][key], j_hist[epoch][key],
                                   rtol=1e-4, err_msg=key)


def test_fit_final_params_match_jax(fits):
    _, want, _, got, _ = fits
    assert got.keys() == want.keys()
    c = TINY.hidden_size
    for k in want:
        g, w = got[k].clone(), want[k].clone()
        kb = slice(c, 2 * c) if k.endswith("attn.qkv.bias") else slice(0, 0)
        assert np.abs((g[kb] - w[kb]).numpy()).max(initial=0.0) <= (
            2 * LR * EPOCHS * 6), k
        g[kb] = w[kb] = 0.0
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5, msg=k)


class KillAtBatch:
    """Loader wrapper delivering SIGTERM to this process when the n-th
    batch (counted across epochs) is asked for, once."""

    def __init__(self, loader, n):
        self.loader, self.n, self.count = loader, n, 0

    def steps_per_epoch(self):
        return self.loader.steps_per_epoch()

    def set_epoch(self, *args):
        self.loader.set_epoch(*args)

    def __iter__(self):
        for b in iter(self.loader):
            if self.count == self.n:
                os.kill(os.getpid(), signal.SIGTERM)
            self.count += 1
            yield b


def _control(dataset, tmp_path, **over):
    cfg = _cfg(tmp_path / "control", **over)
    trainer = _trainer(cfg)
    history = trainer.fit(*_loaders(dataset), resume=False)
    return history, trainer


def _assert_params_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_sigterm_preemption_checkpoints_and_resumes(dataset, tmp_path):
    cfg = _cfg(tmp_path, max_epochs=3)
    train, val = _loaders(dataset)
    prev = signal.getsignal(signal.SIGTERM)
    assert _trainer(cfg).fit(KillAtBatch(train, 2), val, resume=False) == []
    assert signal.getsignal(signal.SIGTERM) is prev  # restored
    assert CheckpointManager(port_config(cfg.checkpoint),
                             cfg.train_id).latest_epoch() is None
    last = _records(cfg)[-1]
    assert last == {"epoch": 1, "preempted": True, "steps": 2}

    resumed = _trainer(cfg)
    history = resumed.fit(train, val, resume=True)
    assert [r["epoch"] for r in history] == [1, 2, 3]
    assert resumed.state.step == 3 * train.steps_per_epoch()
    marks = [r for r in _records(cfg) if "resumed_mid_epoch" in r]
    assert marks == [{"resumed_mid_epoch": 1, "start_batch": 2,
                      "global_step": 2}]

    h_control, control = _control(dataset, tmp_path, max_epochs=3)
    # the resumed epoch 1 averaged only its remaining batches
    assert history[0]["train_loss"] != h_control[0]["train_loss"]
    _assert_params_equal(_params(resumed), _params(control))


def test_preemption_resume_mid_accumulation_window(dataset, tmp_path):
    """Preempted inside an accumulation window (6 steps a epoch,
    accumulation 2, killed after 3): the half-full accumulator is restored
    and training continues bit for bit."""
    opt = OptimizerConfig(name="adamw", learning_rate=LR, weight_decay=0.0,
                          grad_accum_steps=2)
    cfg = _cfg(tmp_path, optimizer=opt)
    train, val = _loaders(dataset)
    assert _trainer(cfg).fit(KillAtBatch(train, 3), val, resume=False) == []
    resumed = _trainer(cfg)
    history = resumed.fit(train, val, resume=True)
    assert [r["epoch"] for r in history] == [1, 2]
    h_control, control = _control(dataset, tmp_path, optimizer=opt)
    assert history[0]["train_loss"] != h_control[0]["train_loss"]
    _assert_params_equal(_params(resumed), _params(control))


def test_stale_partial_checkpoints_do_not_resurrect(dataset, tmp_path):
    train, val = _loaders(dataset)
    spe = train.steps_per_epoch()
    cfg = _cfg(tmp_path, max_epochs=3)
    history = _trainer(cfg).fit(KillAtBatch(train, spe + 2), val,
                                resume=False)
    assert [r["epoch"] for r in history] == [1]  # epoch 2 preempted
    partial_dir = os.path.join(str(tmp_path / "ckpt"), "fit_run_partial")
    assert any(d.isdigit() for d in os.listdir(partial_dir))

    # a fresh start purges the stale partial
    assert [r["epoch"] for r in _trainer(_cfg(tmp_path, max_epochs=1)).fit(
        train, val, resume=False)] == [1]
    assert not any(d.isdigit() for d in os.listdir(partial_dir))

    # auto-resume continues from the fresh full save, not the stale partial
    trainer = _trainer(_cfg(tmp_path, max_epochs=2))
    assert [r["epoch"] for r in trainer.fit(train, val, resume=True)] == [2]
    assert trainer.state.step == 2 * spe
    assert not any("resumed_mid_epoch" in r for r in _records(cfg))


def test_boundary_preemption_still_writes_the_full_save(dataset, tmp_path):
    """A partial with steps_done == steps_per_epoch and no full save: the
    resumed epoch trains nothing, still runs val and writes the full save,
    and training continues bit for bit."""
    train, val = _loaders(dataset)
    spe = train.steps_per_epoch()
    cfg = _cfg(tmp_path, max_epochs=1)
    first = _trainer(cfg)
    first.fit(train, val, resume=False)
    partial = CheckpointManager(
        dataclasses.replace(port_config(cfg.checkpoint), monitor="steps_done",
                            mode="max", top_k=1, every_n_epochs=0),
        cfg.train_id,
        directory=os.path.join(str(tmp_path / "ckpt"), "fit_run_partial"))
    partial.save(spe, first.state, {"epoch_index": 0.0,
                                    "steps_done": float(spe)})
    shutil.rmtree(os.path.join(str(tmp_path / "ckpt"), "fit_run"))

    cfg2 = _cfg(tmp_path, max_epochs=2)
    resumed = _trainer(cfg2)
    history = resumed.fit(train, val, resume=True)
    assert [r["epoch"] for r in history] == [1, 2]
    assert history[0]["images_per_second"] == 0.0 and "val_acc" in history[0]
    assert CheckpointManager(port_config(cfg2.checkpoint),
                             cfg2.train_id).all_steps() == [1, 2]
    assert resumed.state.step == 2 * spe
    _, control = _control(dataset, tmp_path, max_epochs=2)
    _assert_params_equal(_params(resumed), _params(control))


def test_orphan_partial_from_deleted_lineage_is_ignored(dataset, tmp_path):
    train, val = _loaders(dataset)
    spe = train.steps_per_epoch()
    cfg = _cfg(tmp_path, max_epochs=3)
    _trainer(cfg).fit(KillAtBatch(train, spe + 2), val, resume=False)
    partial_dir = os.path.join(str(tmp_path / "ckpt"), "fit_run_partial")
    assert any(d.isdigit() for d in os.listdir(partial_dir))
    shutil.rmtree(os.path.join(str(tmp_path / "ckpt"), "fit_run"))

    trainer = _trainer(cfg)
    assert [r["epoch"] for r in trainer.fit(train, val, resume=True)] == [
        1, 2, 3]  # from scratch
    assert trainer.state.step == 3 * spe
    assert not any(d.isdigit() for d in os.listdir(partial_dir))
    assert not any("resumed_mid_epoch" in r for r in _records(cfg))


def test_explicit_restore_path_resumes_and_purges_partials(dataset,
                                                           tmp_path):
    train, val = _loaders(dataset)
    source = _cfg(tmp_path / "src", max_epochs=1)
    _trainer(source).fit(train, val, resume=False)
    src_dir = os.path.join(source.checkpoint.directory, source.train_id)
    cfg = _cfg(tmp_path, max_epochs=2)
    trainer = _trainer(cfg)
    assert [r["epoch"] for r in trainer.fit(train, val,
                                            resume=src_dir)] == [2]
    assert trainer.state.step == 2 * train.steps_per_epoch()
    with pytest.raises(FileNotFoundError, match="No checkpoint"):
        _trainer(cfg).fit(train, val, resume=str(tmp_path / "nowhere"))


def test_early_stop_state_survives_resume(dataset, tmp_path):
    """lr 0 freezes the parameters, so val_acc stagnates from epoch 2: the
    control stops after epoch 3, and a run interrupted at the epoch-2
    boundary and resumed stops there too."""
    frozen = OptimizerConfig(name="adamw", learning_rate=0.0,
                             weight_decay=0.0)

    def run(max_epochs, run_id, resume):
        cfg = _cfg(tmp_path, max_epochs=max_epochs, optimizer=frozen,
                   early_stop_patience=2, train_id=run_id)
        return _trainer(cfg).fit(*_loaders(dataset), resume=resume)

    control = run(10, "es_control", False)
    assert len(control) == 3
    first = run(2, "es_resumed", False)
    second = run(10, "es_resumed", True)
    assert len(first) == 2 and len(second) == 1


def test_window_early_stop_and_train_loss_ranking(dataset, tmp_path):
    """No val loader: train loss (sign-adjusted) ranks the saves and drives
    the window rule on train_loss."""
    cfg = _cfg(tmp_path, max_epochs=4, early_stop_window=True,
               early_stop_patience=2, early_stop_monitor="train_loss",
               early_stop_mode="min",
               optimizer=OptimizerConfig(name="adamw", learning_rate=0.0))
    train, _ = _loaders(dataset)
    history = _trainer(cfg).fit(train, None, resume=False)
    losses = [r["train_loss"] for r in history]
    # lr 0: the loss stagnates; the run stops at the first epoch where the
    # JAX package's rule fires
    stops = [jax_window_early_exit(losses[:i], 2, "min")
             for i in range(1, len(losses) + 1)]
    assert not any(stops[:-1]) and (stops[-1] or len(history) == 4)
    mgr = CheckpointManager(port_config(cfg.checkpoint), cfg.train_id)
    metrics = mgr.metrics(mgr.latest_epoch())
    assert mgr.latest_epoch() == len(losses)
    assert metrics["val_acc"] == -losses[-1]
    assert metrics["early_stop"]["timeline"] == losses[-3:]


def test_limits_and_profiled_window(dataset, tmp_path):
    cfg = _cfg(tmp_path, max_epochs=1, limit_train_batches=3,
               limit_val_batches=1, profile_dir=str(tmp_path / "prof"),
               profile_steps=2)
    trainer = _trainer(cfg)
    history = trainer.fit(*_loaders(dataset), resume=False)
    # 3 loader batches, the second trained profile_steps times
    assert trainer.state.step == 4 and len(history) == 1
    assert [f for f in os.listdir(tmp_path / "prof") if f.endswith(".json")]


def test_steps_per_call_is_not_ported(dataset, tmp_path):
    with pytest.raises(NotImplementedError, match="steps_per_call"):
        _trainer(_cfg(tmp_path, steps_per_call=2)).fit(*_loaders(dataset))


def _cli_args(**over):
    import argparse

    ns = argparse.Namespace(
        restore=None, no_resume=False, test=False, transform=None,
        data_dir=None, max_epochs=None, batch_size=None, lr=None,
        schedule=None, coordinator=None, num_processes=None, process_id=None,
        device="cpu")
    for k, v in over.items():
        setattr(ns, k, v)
    return ns


def test_test_mode_requires_checkpoint(dataset, tmp_path):
    cfg = port_config(_cfg(tmp_path, data_dir=dataset))
    model = ViT(port_config(TINY), "float32", "cpu", param_dtype="float32")
    with pytest.raises(FileNotFoundError, match="--test"):
        cli.run(cfg, _cli_args(test=True), model=model)


def test_empty_val_split_degrades_to_no_val(dataset, tmp_path):
    cfg = port_config(_cfg(tmp_path, data_dir=dataset, train_split=1.0))
    train, val, test, _ = cli.build_loaders(cfg, (32, 32))
    assert val is None and test is None
    assert train.steps_per_epoch() > 0
