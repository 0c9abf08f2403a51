"""The port's data parallelism on 2 gloo ranks of the CPU, against one
process on the global batch (the JAX package's single-process step, which
JAX's own DP tests equate with its sharded step).

- a ViT step with the ``nvit`` augmentation and CutMix/MixUp on, and one
  with them off: two ranks of 4 rows equal JAX's one-device Trainer at 8.
  The two packages draw from different generators (``torch.Generator`` and
  host numpy in the port, ``jax.random`` keys in JAX), so the JAX step is
  traced with the numbers the port draws for the global batch: each
  uniform and Bernoulli draw of JAX's augment and mixup modules returns
  the port's (``augment_replay.ReplayAugment``, ``_ReplayMix``), and
  JAX's own code crops, jitters, erases, rolls the global batch and mixes. A rank that
  drew for its own rows only, or rolled its rows alone, differs. Loss
  1e-5, parameters 1e-5 (``tests/test_parallel.py``'s bound), the key bias
  to 2 x lr a step (its gradient is rounding noise,
  ``test_torch_train.py``);
- a ResNet-18 step: the BatchNorm moments, the running statistics and the
  parameters of two ranks equal JAX's one-device step within 1e-5;
- ``Trainer.fit`` on two ranks: SIGTERM to one rank stops both at the same
  step, one ``metrics.jsonl`` (rank 0's), and the checkpoints resume
  elastically 2 -> 1 (after the mid-epoch preemption) -> 2 and 1 -> 2
  (after a full epoch) to the parameters of an uninterrupted one-process
  run;
- the ``ntrain`` CLI under two processes (``--coordinator`` with a
  ``file://`` rendezvous, ``--num-processes``, ``--process-id``).

Each rank is a child process (``torch_mp_child.py``) with one thread, its
own ``communicate`` timeout and a 60 s timeout on every collective.
"""
import dataclasses
import itertools
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from augment_replay import ReplayAugment
from fixtures import make_image_folder
from test_torch_copies import port_config
from torch_mp import merged, spawn
from touhouimageclassification_tpu.config import (PRESETS, AugmentConfig,
                                                  CheckpointConfig, MixConfig,
                                                  OptimizerConfig,
                                                  ResNetConfig, TrainConfig,
                                                  ViTConfig)
from touhouimageclassification_tpu.models.resnet import ResNet as JaxResNet
from touhouimageclassification_tpu.models.vit import ViT as JaxViT
from touhouimageclassification_tpu.ops import augment as jaug
from touhouimageclassification_tpu.ops import mixup as jmix
from touhouimageclassification_tpu.parallel.mesh import (create_mesh,
                                                         data_sharding)
from touhouimageclassification_tpu.train.trainer import Trainer as JaxTrainer
from touhouimageclassification_tpu_torch.models.vit import ViT
from touhouimageclassification_tpu_torch.ops import augment as aug
from touhouimageclassification_tpu_torch.ops import mixup
from touhouimageclassification_tpu_torch.train.trainer import Trainer
from touhouimageclassification_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)

TINY = ViTConfig(image_size=16, patch_size=8, hidden_size=16, num_layers=1,
                 num_heads=2, mlp_dim=32, num_classes=4)
ADAMW = OptimizerConfig(name="adamw", learning_rate=1e-3, weight_decay=0.01)
STEPS = 2


def _cfg(tmp, model_type="vit-base", opt=ADAMW, augment=False, batch=8,
         **kw):
    return TrainConfig(
        train_id="mp", model_type=model_type, global_batch_size=batch,
        seed=0,
        optimizer=opt,
        augment=(PRESETS["nvit"].augment if augment
                 else AugmentConfig(enable_augmentation=False)),
        mix=MixConfig(enable_mixup=augment),
        checkpoint=CheckpointConfig(directory=str(tmp / "c"),
                                    async_save=False),
        log_dir=str(tmp / "l"), **kw)


def _batches(size, n=STEPS, seed=0, batch=8):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (batch, size, size, 3)).astype(
                np.uint8),
             "label": rng.integers(0, 4, batch).astype(np.int32),
             "mask": np.ones(batch, bool)} for _ in range(n)]


class _ReplayMix:
    """The same for ``ops/mixup.py``: the coin, lambda and box centre the
    port drew on the host (``host``: the values its numpy generator
    returned, in order). Both branches of JAX's ``lax.cond`` are traced;
    the coin picks the port's."""
    lax, Array = jax.lax, jax.Array

    def __init__(self, host):
        self.random = self
        self._coin, self._lam, *centre = host
        self._centre = itertools.cycle(centre or [0.5, 0.5])

    def split(self, key, num=2):
        return [key] * num

    def bernoulli(self, key, p=0.5, shape=()):
        return jnp.asarray(self._coin < p)

    def beta(self, key, a, b, shape=(), dtype=jnp.float32):
        return jnp.asarray(self._lam, dtype)

    def uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0,
                maxval=1.0):
        return jnp.asarray(next(self._centre), dtype)


class _LoggedRng:
    """A numpy generator that logs what ``random`` and ``beta`` return."""

    def __init__(self, rng, log):
        self._rng, self._log = rng, log

    def random(self):
        self._log.append(self._rng.random())
        return self._log[-1]

    def beta(self, a, b):
        self._log.append(self._rng.beta(a, b))
        return self._log[-1]


def _port_draws(cfg, model_cfg, batches):
    """What the port's one-process Trainer draws for each step's global
    batch: (the augmentation's per-image uniforms in order, the CutMix/MixUp
    host draws)."""
    one = Trainer(cfg, model=ViT(model_cfg, "float32", "cpu",
                                 param_dtype="float32"), device="cpu")
    rand, sample = aug._rand, mixup.sample_cutmix_or_mixup
    draws = []
    for step, batch in enumerate(batches):
        uniforms, host = [], []

        def logged_rand(*args, uniforms=uniforms):
            uniforms.append(rand(*args))
            return uniforms[-1]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(aug, "_rand", logged_rand)
            mp.setattr(mixup, "sample_cutmix_or_mixup",
                       lambda rng, *a, host=host: sample(
                           _LoggedRng(rng, host), *a))
            aug_seed, mix, _, _ = one._draws(SimpleNamespace(step=step))
            one._inputs(one.stage(batch),
                        torch.Generator().manual_seed(aug_seed), mix)
        draws.append((uniforms, host))
    return draws


def _jax_run(tmp, cfg, model, batches, draws=None):
    """JAX's one-device Trainer: (initial variables, per-step metrics,
    final variables). With ``draws`` (``_port_draws``), each step is traced
    anew with JAX's random draws replaced by the port's."""
    mesh = create_mesh(num_data=1, devices=jax.devices()[:1])
    jt = JaxTrainer(cfg, model=model, mesh=mesh)
    state = jt.init_state(4)
    init = jax.device_get({"params": state.params, **state.model_state})
    step = jt._make_train_step()
    metrics = []
    for i, batch in enumerate(batches):
        with pytest.MonkeyPatch.context() as mp:
            if draws is not None:
                replay = ReplayAugment(draws[i][0])
                mp.setattr(jaug, "jax", replay)
                mp.setattr(jmix, "jax", _ReplayMix(draws[i][1]))
                step = jt._make_train_step()
            state, m = step(state, jax.device_put(batch, data_sharding(mesh)))
            if draws is not None:
                assert replay.done(), "JAX drew fewer numbers than the port"
        metrics.append({k: float(v) for k, v in m.items()})
    return init, metrics, jax.device_get({"params": state.params,
                                          **state.model_state})


def _key_bias(name):
    c = TINY.hidden_size
    return (slice(c, 2 * c) if name.endswith("attn.qkv.bias") else
            slice(0, 0))


def _assert_vit_params(got, want, lr):
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k].clone(), want[k].clone()
        kb = _key_bias(k)
        assert np.abs((g[kb] - w[kb]).numpy()).max(initial=0.0) <= (
            2 * lr * STEPS), k
        g[kb] = w[kb] = 0.0
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5, msg=k)


def _assert_metrics(got, want, keys=("loss", "grad_norm")):
    for g, w in zip(got, want, strict=True):
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


@pytest.fixture(scope="module")
def vit_runs(tmp_path_factory):
    """Both ViT runs on one pair of ranks: (outputs of the two ranks, the
    one-process references)."""
    tmp = tmp_path_factory.mktemp("vit_dp")
    pcfg = port_config(TINY)
    plain, augmented = _cfg(tmp), _cfg(tmp, augment=True)
    aug_batches = _batches(20, seed=1)
    draws = _port_draws(port_config(augmented), pcfg, aug_batches)
    refs, runs = [], []
    for cfg, batches, replay in ((augmented, aug_batches, draws),
                                 (plain, _batches(16), None)):
        jinit, jmetrics, jfinal = _jax_run(
            tmp, cfg, JaxViT(TINY, compute_dtype="float32"), batches, replay)
        init = from_jax_params(jinit, pcfg)
        refs.append((jmetrics, from_jax_params(jfinal, pcfg)))
        runs.append(dict(family="ViT", model_cfg=pcfg, cfg=port_config(cfg),
                         init_params=init, batches=batches))
    outs = spawn(tmp / "ranks", "steps", 2, {"runs": runs})
    return outs, refs


@pytest.mark.parametrize("run", [0, 1], ids=["nvit_augment_mixup",
                                             "plain_vs_jax"])
def test_vit_dp_step_equals_one_process_at_the_global_batch(vit_runs, run):
    outs, refs = vit_runs
    want_metrics, want_params = refs[run]
    assert [o[run]["view"] for o in outs] == [(0, 2), (1, 2)]
    for out in outs:
        # the fetched loss and grad norm are the global batch's, on both
        assert out[run]["metrics"] == outs[0][run]["metrics"]
        _assert_metrics(out[run]["metrics"], want_metrics)
    assert outs[0][run]["step"] == STEPS
    _assert_vit_params(merged([o[run] for o in outs]), want_params,
                       ADAMW.learning_rate)


@pytest.mark.parametrize("bn_variant", ["flax", "batch", "ghost", "stale"])
def test_resnet_dp_step_syncs_batchnorm(tmp_path, bn_variant):
    """One SGD step of a ResNet-18 at 32² (two ranks of 4): the global
    batch's BN moments make the loss, the grad norm, every parameter and
    every running statistic JAX's one-device step's at 8, with each
    BatchNorm variant. 'ghost' takes the global batch's first quarter,
    which lies on rank 0 alone; it runs at 64² on two ranks of 8, against
    the port in one process: moments of 4 rows make its step
    ill-conditioned (JAX's own grad norm moves by 2e-5 when its parameters
    move one ulp), and the port's one-process parity with JAX is
    ``test_torch_bn_variants.py``'s."""
    size, batch = (64, 16) if bn_variant == "ghost" else (32, 8)
    rcfg = ResNetConfig(depth=18, num_classes=4, image_size=size,
                        bn_variant=bn_variant)
    opt = OptimizerConfig(name="sgd", learning_rate=1e-4, momentum=0.9)
    cfg = _cfg(tmp_path, "resnet18", opt, batch=batch)
    batches = _batches(size, n=1, seed=2, batch=batch)
    jinit, jmetrics, jfinal = _jax_run(
        tmp_path, cfg, JaxResNet(rcfg, compute_dtype="float32"), batches)
    pcfg = port_config(rcfg)
    spec = {"runs": [dict(family="ResNet", model_cfg=pcfg,
                          cfg=port_config(cfg),
                          init_params=from_jax_params(jinit, pcfg),
                          batches=batches)]}
    outs = spawn(tmp_path / "ranks", "steps", 2, spec)
    want = from_jax_params(jfinal, pcfg)
    if bn_variant == "ghost":
        one, = spawn(tmp_path / "one", "steps", 1, spec)
        jmetrics, want = one[0]["metrics"], one[0]["held"]
    got = merged([o[0] for o in outs])
    _assert_metrics(outs[0][0]["metrics"], jmetrics)
    assert got.keys() == want.keys()
    assert sum("running" in k for k in want) == 2 * 20
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=1e-5, rtol=1e-5,
                                   msg=k)


# ---------------------------------------------------------------------------
# Trainer.fit: preemption agreement, rank-0 metrics, elastic resume
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_image_folder(str(tmp_path_factory.mktemp("mp_fit")),
                             num_classes=4, per_class=5, size=16)


def _fit_spec(corpus, work, epochs, **kw):
    """Tiny ViT, SGD, no augmentation: the loss of a global batch is the
    same whichever process holds which row, so 1 and 2 ranks agree to
    rounding. 16 training images, 4 steps an epoch."""
    cfg = port_config(dataclasses.replace(
        _cfg(work, opt=OptimizerConfig(name="sgd", learning_rate=0.05,
                                       momentum=0.9)),
        data_dir=corpus, train_split=0.8, max_epochs=epochs,
        global_batch_size=4))
    init = ViT(port_config(TINY), "float32", "cpu", param_dtype="float32",
               seed=0).state_dict()
    return dict(family="ViT", model_cfg=port_config(TINY), cfg=cfg,
                init_params=init, **kw)


def _assert_close_params(got, want):
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=1e-5, rtol=1e-5,
                                   msg=k)


def _control(corpus, work, epochs):
    """An uninterrupted one-process run of ``epochs`` epochs."""
    out, = spawn(work / "ranks", "fit", 1, _fit_spec(corpus, work, epochs))
    assert [r["epoch"] for r in out["history"]] == list(range(1, epochs + 1))
    return out


@pytest.fixture(scope="module")
def control(corpus, tmp_path_factory):
    return _control(corpus, tmp_path_factory.mktemp("control"), 2)


def _records(work):
    with open(work / "l" / "mp" / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_preemption_agreement_and_elastic_resume_2_to_1_to_2(
        corpus, control, tmp_path):
    """SIGTERM reaches rank 1 alone after step 2: both ranks stop at step 2
    and save one mid-epoch checkpoint; rank 0 alone writes the record. One
    process resumes it mid-epoch and finishes both epochs at the
    uninterrupted run's parameters; two ranks then train epoch 3 from its
    checkpoint to a 3-epoch uninterrupted run's parameters."""
    outs = spawn(tmp_path / "a", "fit", 2, _fit_spec(
        corpus, tmp_path, 2, sigterm=(1, 2)))
    assert [o["step"] for o in outs] == [2, 2]
    assert [o["history"] for o in outs] == [[], []]
    assert _records(tmp_path) == [{"epoch": 1, "preempted": True,
                                   "steps": 2}]
    partial = tmp_path / "c" / "mp_partial" / "2"
    assert sorted(os.listdir(partial)) == ["meta.json", "metrics.json",
                                           "state.safetensors"]
    out, = spawn(tmp_path / "b", "fit", 1, _fit_spec(corpus, tmp_path, 2))
    assert out["step"] == control["step"] == 8
    assert [r["epoch"] for r in out["history"]] == [1, 2]
    assert _records(tmp_path)[1] == {"resumed_mid_epoch": 1,
                                     "start_batch": 2, "global_step": 2}
    _assert_close_params(out["held"], control["held"])
    outs = spawn(tmp_path / "c", "fit", 2, _fit_spec(corpus, tmp_path, 3))
    assert [o["step"] for o in outs] == [12, 12]
    assert [[r["epoch"] for r in o["history"]] for o in outs] == [[3], [3]]
    assert [r.get("epoch") for r in _records(tmp_path)] == [1, None, 1, 2, 3]
    _assert_close_params(merged(outs), _control(
        corpus, tmp_path / "control3", 3)["held"])


def test_elastic_resume_1_to_2(corpus, control, tmp_path):
    """One process trains epoch 1; two ranks resume it for epoch 2 and end
    at the uninterrupted run's parameters; their records are rank 0's."""
    out, = spawn(tmp_path / "a", "fit", 1, _fit_spec(corpus, tmp_path, 1))
    assert out["step"] == 4
    outs = spawn(tmp_path / "b", "fit", 2, _fit_spec(corpus, tmp_path, 2))
    assert [o["step"] for o in outs] == [8, 8]
    assert [[r["epoch"] for r in o["history"]] for o in outs] == [[2], [2]]
    assert [r["epoch"] for r in _records(tmp_path)] == [1, 2]
    np.testing.assert_allclose(outs[0]["history"][0]["train_loss"],
                               control["history"][1]["train_loss"],
                               rtol=1e-5)
    _assert_close_params(merged(outs), control["held"])


def test_fit_with_steps_per_call_on_two_processes(corpus, control,
                                                  tmp_path):
    """steps_per_call=2 on two ranks: each call of 2 steps agrees on SIGTERM
    once and fetches once, and the run ends at the one-process k=1 run's
    parameters and step, its records rank 0's."""
    spec = _fit_spec(corpus, tmp_path, 2)
    spec["cfg"] = dataclasses.replace(spec["cfg"], steps_per_call=2)
    outs = spawn(tmp_path / "ranks", "fit", 2, spec)
    assert [o["step"] for o in outs] == [8, 8]
    assert [r["epoch"] for r in _records(tmp_path)] == [1, 2]
    for got, want in zip(outs[0]["history"], control["history"]):
        np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                                   rtol=1e-5)
    _assert_close_params(merged(outs), control["held"])


def test_ntrain_cli_on_two_processes(corpus, tmp_path):
    """``ntrain --tiny`` with --coordinator/--num-processes/--process-id:
    both ranks train the epoch and hold the same parameters; one record."""
    outs = spawn(tmp_path / "ranks", "cli", 2, dict(
        cli="ntrain", workdir=str(tmp_path),
        argv=["--tiny", "--data-dir", corpus, "--batch-size", "4",
              "--max-epochs", "1", "--seed", "0", "--no-pretrained",
              "--no-resume"]))
    assert outs[0]["step"] == outs[1]["step"] > 0
    merged(outs)  # replicated: equal on both ranks
    with open(tmp_path / "log" / "nViT" / "metrics.jsonl") as f:
        assert [json.loads(line)["epoch"] for line in f] == [1]
