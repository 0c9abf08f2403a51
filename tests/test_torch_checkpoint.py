"""The port's checkpoints (safetensors + JSON) against the JAX package's
Orbax manager, and the early-exit rule against the JAX package's.

- retention: the same metric sequences saved through both managers keep the
  same steps and name the same best and latest step;
- a save restores bit for bit: parameters, the AdamW moments and step, the
  accumulator of an open accumulation window, ``step``, ``count`` and
  ``mini_step``, and training goes on identically from it;
- a save that dies before its rename is not a checkpoint;
- ``window_early_exit`` equals the JAX package's on random timelines.
"""
import dataclasses
import json
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_copies import port_config
from touhouimageclassification_tpu.config import (AugmentConfig,
                                                  CheckpointConfig, MixConfig,
                                                  OptimizerConfig, TrainConfig,
                                                  ViTConfig)
from touhouimageclassification_tpu.train.checkpoint import (
    CheckpointManager as JaxCheckpointManager)
from touhouimageclassification_tpu.train.trainer import (
    window_early_exit as jax_window_early_exit)
from touhouimageclassification_tpu_torch.models.vit import ViT
from touhouimageclassification_tpu_torch.train import checkpoint as ck
from touhouimageclassification_tpu_torch.train.trainer import (
    Trainer, window_early_exit)

torch.set_num_threads(1)

TINY = ViTConfig(image_size=16, patch_size=8, hidden_size=16, num_layers=1,
                 num_heads=2, mlp_dim=32, num_classes=4)

# metric sequences (epoch -> value) and the manager config they go through
RETENTION = {
    # test_train_e2e.py::test_checkpoint_retention_caps_every_n
    "max_every_3": (dict(top_k=3, monitor="val_acc", mode="max",
                         every_n_epochs=3),
                    {1: .2, 2: .9, 3: .3, 4: .85, 5: .4, 6: .41, 7: .42,
                     8: .88, 9: .1, 10: .05, 11: .06}),
    # val_loss, lower is better, with ties; every-2 keeps
    "min_with_ties": (dict(top_k=2, monitor="val_loss", mode="min",
                           every_n_epochs=2),
                      {1: .9, 2: .5, 3: .5, 4: .7, 5: .4, 6: .8, 7: .4,
                       8: .95, 9: .6}),
    # no monitor: the latest k
    "no_monitor": (dict(top_k=2, monitor="", mode="max", every_n_epochs=4),
                   {e: float(e % 3) for e in range(1, 10)}),
}


@pytest.fixture(scope="module")
def jax_retention(tmp_path_factory):
    """name -> (kept steps, best, latest) of the JAX Orbax manager."""
    out = {}
    for name, (over, metrics) in RETENTION.items():
        cfg = CheckpointConfig(directory=str(tmp_path_factory.mktemp(name)),
                               async_save=False, **over)
        mgr = JaxCheckpointManager(cfg, "run")
        for epoch, value in metrics.items():
            mgr.save(epoch, {"w": jnp.zeros((2,))},
                     {cfg.monitor or "val_acc": value})
        mgr.wait()
        out[name] = (set(mgr._mgr.all_steps()), mgr.best_epoch(),
                     mgr.latest_epoch())
        mgr.close()
    assert out["max_every_3"][0] == {2, 3, 4, 6, 8, 9, 11}
    return out


def _trainer(tmp_path, opt=None, seed=0, **over):
    cfg = TrainConfig(
        train_id="ckpt", model_type="vit-base", global_batch_size=8, seed=0,
        optimizer=opt or OptimizerConfig(name="adamw", learning_rate=1e-3,
                                         weight_decay=0.01),
        augment=AugmentConfig(enable_augmentation=False),
        mix=MixConfig(enable_mixup=False),
        checkpoint=CheckpointConfig(directory=str(tmp_path / "c"),
                                    async_save=False),
        log_dir=str(tmp_path / "l"), **over)
    model = ViT(port_config(TINY), "float32", "cpu", param_dtype="float32",
                seed=seed)
    return Trainer(port_config(cfg), model=model, device="cpu")


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (8, 16, 16, 3)).astype(np.uint8),
             "label": rng.integers(0, 4, 8).astype(np.int32),
             "mask": np.ones(8, bool)} for _ in range(n)]


@pytest.mark.parametrize("async_save", [False, True])
@pytest.mark.parametrize("name", list(RETENTION))
def test_retention_keeps_what_jax_keeps(jax_retention, tmp_path, name,
                                        async_save):
    over, metrics = RETENTION[name]
    cfg = port_config(CheckpointConfig(directory=str(tmp_path),
                                       async_save=async_save, **over))
    mgr = ck.CheckpointManager(cfg, "run")
    trainer = _trainer(tmp_path)
    state = trainer.init_state()
    for epoch, value in metrics.items():
        assert mgr.save(epoch, state, {cfg.monitor or "val_acc": value})
    mgr.wait()
    assert (set(mgr.all_steps()), mgr.best_epoch(),
            mgr.latest_epoch()) == jax_retention[name]
    # as Orbax: a step at or below the latest is not saved again
    assert not mgr.save(max(metrics), state, {cfg.monitor or "val_acc": 0.0})
    names = sorted(os.listdir(os.path.join(mgr.directory,
                                           str(mgr.latest_epoch()))))
    assert names == ["meta.json", "metrics.json", "state.safetensors"]


def _snapshot(state):
    opt = state.optimizer
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {i: {k: v.clone() for k, v in s.items()}
             for i, s in opt.inner.state_dict()["state"].items()},
            None if opt.acc is None else [a.clone() for a in opt.acc],
            (state.step, opt.count, opt.mini_step))


def _assert_same(a, b):
    params_a, opt_a, acc_a, counters_a = a
    params_b, opt_b, acc_b, counters_b = b
    assert counters_a == counters_b
    assert params_a.keys() == params_b.keys()
    assert all(torch.equal(params_a[k], params_b[k]) for k in params_a)
    assert opt_a.keys() == opt_b.keys()
    for i in opt_a:
        assert opt_a[i].keys() == opt_b[i].keys()
        assert all(torch.equal(opt_a[i][k], opt_b[i][k]) for k in opt_a[i])
    assert (acc_a is None) == (acc_b is None)
    if acc_a is not None:
        assert all(torch.equal(x, y) for x, y in zip(acc_a, acc_b))


@pytest.mark.parametrize("opt", [
    OptimizerConfig(name="adamw", learning_rate=1e-3, weight_decay=0.01),
    OptimizerConfig(name="adamw", learning_rate=1e-3, weight_decay=0.01,
                    grad_accum_steps=2, schedule="warmup_linear",
                    warmup_steps=2, total_steps=8),
    OptimizerConfig(name="sgd", learning_rate=1e-2, momentum=0.9)],
    ids=["adamw", "adamw_accum2_open_window", "sgd_momentum"])
def test_save_then_restore_is_bit_exact(tmp_path, opt):
    """Three micro-steps (with accumulation 2, the second window is half
    full), save, restore into a trainer built from another seed: every
    tensor and counter equal; one more step on each stays equal."""
    batches = _batches(4)
    src = _trainer(tmp_path, opt)
    state = src.init_state(4)
    for batch in batches[:3]:
        src.train_step(state, src.stage(batch))
    if opt.grad_accum_steps > 1:
        assert state.optimizer.mini_step == 1 and state.optimizer.acc
    mgr = ck.CheckpointManager(port_config(src.cfg.checkpoint), "run")
    mgr.save(1, state, {"val_acc": 0.5})
    dst = _trainer(tmp_path, opt, seed=1)
    restored = mgr.restore(dst.init_state(4))
    _assert_same(_snapshot(restored), _snapshot(state))
    with open(os.path.join(mgr.directory, "1", "meta.json")) as f:
        meta = json.load(f)
    assert (meta["step"], meta["count"], meta["mini_step"]) == (
        3, state.optimizer.count, state.optimizer.mini_step)
    src.train_step(state, src.stage(batches[3]))
    dst.train_step(restored, dst.stage(batches[3]))
    _assert_same(_snapshot(restored), _snapshot(state))


def test_resnet_save_then_restore_is_bit_exact(tmp_path):
    """A ResNet-18 (SGD with momentum, BN in train mode): three steps, save,
    restore into a trainer built from another seed: parameters, the BN
    running statistics, the momentum buffers and the counters equal; one
    more step on each stays equal."""
    from touhouimageclassification_tpu_torch.config import ResNetConfig
    from touhouimageclassification_tpu_torch.models.resnet import ResNet

    opt = OptimizerConfig(name="sgd", learning_rate=1e-2, momentum=0.9)

    def trainer(seed):
        cfg = TrainConfig(
            train_id="ckpt_resnet", model_type="resnet18", global_batch_size=8,
            seed=0, optimizer=opt,
            augment=AugmentConfig(enable_augmentation=False),
            mix=MixConfig(enable_mixup=False),
            checkpoint=CheckpointConfig(directory=str(tmp_path / "c"),
                                        async_save=False),
            log_dir=str(tmp_path / "l"))
        model = ResNet(ResNetConfig(depth=18, num_classes=4, image_size=16),
                       "float32", "cpu", param_dtype="float32", seed=seed)
        return Trainer(port_config(cfg), model=model, device="cpu")

    batches = _batches(4)
    src = trainer(0)
    state = src.init_state(4)
    for batch in batches[:3]:
        src.train_step(state, src.stage(batch))
    mgr = ck.CheckpointManager(port_config(src.cfg.checkpoint), "run")
    mgr.save(1, state, {"val_acc": 0.5})
    dst = trainer(1)
    restored = mgr.restore(dst.init_state(4))
    snap = _snapshot(restored)
    assert sum("running" in k for k in snap[0]) == 2 * 20
    _assert_same(snap, _snapshot(state))
    src.train_step(state, src.stage(batches[3]))
    dst.train_step(restored, dst.stage(batches[3]))
    _assert_same(_snapshot(restored), _snapshot(state))


def test_interrupted_save_is_not_a_checkpoint(tmp_path, monkeypatch):
    trainer = _trainer(tmp_path)
    state = trainer.init_state()
    mgr = ck.CheckpointManager(port_config(trainer.cfg.checkpoint), "run")
    mgr.save(1, state, {"val_acc": 0.1})

    def die(*args):
        raise OSError("killed before the rename")

    monkeypatch.setattr(ck.os, "rename", die)
    with pytest.raises(OSError, match="killed"):
        mgr.save(2, state, {"val_acc": 0.9})
    monkeypatch.undo()
    assert os.path.isdir(os.path.join(mgr.directory, "2" + ck._TMP))
    assert mgr.latest_epoch() == 1 and mgr.all_steps() == [1]
    assert mgr.best_epoch() == 1
    mgr.restore(trainer.init_state())
    assert mgr.save(2, state, {"val_acc": 0.9})  # the leftover is replaced
    assert mgr.all_steps() == [1, 2]
    assert not os.path.exists(os.path.join(mgr.directory, "2" + ck._TMP))


def test_async_save_error_surfaces_in_wait(tmp_path, monkeypatch):
    trainer = _trainer(tmp_path)
    cfg = dataclasses.replace(port_config(trainer.cfg.checkpoint),
                              async_save=True)
    mgr = ck.CheckpointManager(cfg, "run")
    def full(*args):
        raise OSError("disk full")

    monkeypatch.setattr(ck, "save_safetensors", full)
    assert mgr.save(1, trainer.init_state(), {"val_acc": 0.1})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.latest_epoch() is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int64, torch.uint8,
                                   torch.bool])
def test_safetensors_writer_reads_back_with_the_library(tmp_path, dtype):
    """save_safetensors writes what safetensors' reader reads: every dtype
    the checkpoints hold, 0-d (AdamW's step), empty and odd-sized tensors,
    names in any order."""
    from safetensors import safe_open
    from safetensors.torch import load_file

    gen = torch.Generator().manual_seed(0)
    tensors = {
        "z/last": (torch.rand(3, 5, generator=gen) * 100).to(dtype),
        "a.scalar": torch.tensor(7.5).to(dtype),
        "m/empty": torch.zeros(0, 4, dtype=dtype),
        "b.odd": (torch.rand(7, generator=gen) * 100).to(dtype),
    }
    path = str(tmp_path / "t.safetensors")
    ck.save_safetensors(tensors, path)
    back = load_file(path)
    assert back.keys() == tensors.keys()
    for k, t in tensors.items():
        assert back[k].dtype == dtype and back[k].shape == t.shape, k
        assert torch.equal(back[k], t), k
    with safe_open(path, "pt") as f:
        assert sorted(f.keys()) == sorted(tensors)
    with open(path, "rb") as f:
        assert (8 + int.from_bytes(f.read(8), "little")) % 8 == 0


def test_params_only_export_round_trip(tmp_path):
    sd = ViT(port_config(TINY), "float32", "cpu", seed=2).state_dict()
    path = str(tmp_path / "params.safetensors")
    ck.save_params(path, sd)
    back = ck.load_params(path)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def _timelines():
    rng = random.Random(0)
    out = []
    for length in range(0, 7):
        for _ in range(10):
            out.append([round(rng.uniform(0, 1), 1) for _ in range(length)])
    return out


@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("patience", [0, 1, 2, 3])
def test_window_early_exit_matches_jax(patience, mode):
    for timeline in _timelines() + [[1.0, 5.0, 4.0, 4.5, 4.6],
                                    [0.5, 0.5, 0.4, 0.3]]:
        assert window_early_exit(timeline, patience, mode) == \
            jax_window_early_exit(timeline, patience, mode), timeline
