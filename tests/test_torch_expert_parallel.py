"""The port's expert parallelism on gloo ranks of the CPU, against JAX's
one-device ``MoEClassifier`` / ``TreeViT`` and ``Trainer`` on the global
batch.

ResMoE (dense; sparse by features with drops; sparse by images with the
Switch balance loss; 4 experts, top 2) and TreeViT's teacher-forced sons and
full stages (2 sons) run on two ranks of pure expert parallelism, each rank
holding half of the members, and on four ranks of (data=2, expert=2). Each
rank computes the eval logits of its rows and takes two SGD steps (lr
5e-2) on its rows of the global batch of 8. The logits, every fetched
scalar (loss, grad norm, the routing telemetry) and every parameter after
the steps are held to ``test_torch_train_families.py``'s bounds against
JAX: 1e-5 relative (1e-6 absolute) for the scalars and logits, 1e-5 for
the parameters. The replicated gate and root are equal on every rank, and
each member is held by the ranks of its expert index only: on the others it
is on the meta device.

The ``resmoe --expert-shards 2`` CLI on two ranks is in
``test_torch_train_families.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_copies import port_config
from torch_mp import merged, spawn
from touhouimageclassification_tpu.config import (PRESETS, AugmentConfig,
                                                  CheckpointConfig,
                                                  MeshConfig, MixConfig,
                                                  MoEConfig, TrainConfig,
                                                  TreeViTConfig, ViTConfig)
from touhouimageclassification_tpu.models.resmoe import \
    MoEClassifier as JaxMoE
from touhouimageclassification_tpu.models.treevit import TreeViT as JaxTree
from touhouimageclassification_tpu.parallel.mesh import (create_mesh,
                                                         data_sharding)
from touhouimageclassification_tpu.train import tasks as jtasks
from touhouimageclassification_tpu.train import treevit as jtreevit
from touhouimageclassification_tpu.train.trainer import Trainer as JaxTrainer
from touhouimageclassification_tpu_torch.parallel import sharding
from touhouimageclassification_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)

N_CLASSES = 4
STEPS = 2
TINY_VIT = ViTConfig(image_size=16, patch_size=8, hidden_size=16, num_layers=1,
                     num_heads=2, mlp_dim=32, num_classes=N_CLASSES)
CMAP = np.array([0, 0, 1, 1], np.int32)
CONFIGS = ["moe_dense", "moe_sparse_feature", "moe_sparse_image",
           "tree_sons", "tree_full"]


def _model_cfg(name):
    if name.startswith("moe"):
        routing, level, factor = {
            "moe_dense": ("dense", "feature", 1.25),
            "moe_sparse_feature": ("sparse", "feature", 0.75),
            "moe_sparse_image": ("sparse", "image", 1.0)}[name]
        return MoEConfig(num_experts=4, top_k=2, num_classes=N_CLASSES,
                         routing=routing, dispatch_level=level,
                         capacity_factor=factor, gateway_t=0.0,
                         balance_loss="switch" if level == "image"
                         else "quadratic", expert_vit=TINY_VIT)
    return TreeViTConfig(num_categories=2, num_classes=N_CLASSES, top_k=1,
                         capacity_factor=1.0, vit=TINY_VIT)


def _train_cfg(tmp, name):
    return TrainConfig(
        train_id="ep", global_batch_size=8, seed=0,
        model_type="vit-moe" if name.startswith("moe") else "tree-vit",
        optimizer=dataclasses.replace(PRESETS["resmoe"].optimizer,
                                      grad_accum_steps=1),
        augment=AugmentConfig(enable_augmentation=False),
        mix=MixConfig(enable_mixup=False),
        checkpoint=CheckpointConfig(directory=str(tmp / "c"),
                                    async_save=False),
        log_dir=str(tmp / "l"))


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (8, 16, 16, 3)).astype(np.uint8),
             "label": rng.integers(0, N_CLASSES, 8).astype(np.int32),
             "mask": np.ones(8, bool)} for _ in range(STEPS)]


def _eval_images():
    return np.random.default_rng(7).random((8, 16, 16, 3), np.float32)


def _jax_reference(tmp, name):
    """JAX's one-device run of ``name``: (initial params as a port state
    dict, eval logits, per-step metrics, final params as a port state
    dict), and the port's run spec."""
    cfg = _model_cfg(name)
    stage = None if name.startswith("moe") else name.removeprefix("tree_")
    if stage is None:
        jmodel, jtask = JaxMoE(cfg, compute_dtype="float32"), \
            jtasks.MoETask(cfg)
    else:
        cls = {"sons": "TreeSonsTask", "full": "TreeFullTask"}[stage]
        jmodel = JaxTree(cfg, compute_dtype="float32")
        jtask = getattr(jtasks, cls)(cfg, CMAP)
    tcfg = _train_cfg(tmp, name)
    mesh = create_mesh(num_data=1, devices=jax.devices()[:1])
    jt = JaxTrainer(tcfg, model=jmodel, task=jtask, mesh=mesh,
                    param_filter=stage and jtreevit._mask_for_stage(stage))
    state = jt.init_state(4)
    pcfg = port_config(cfg)
    init = from_jax_params(jax.device_get(state.params), pcfg)
    outputs, _ = jtask.forward(jmodel, {"params": state.params},
                               _eval_images(), None, False, None)
    logits = np.asarray(jtask.logits(outputs))
    step = jt._make_train_step()
    metrics = []
    for batch in _batches():
        state, m = step(state, jax.device_put(batch, data_sharding(mesh)))
        metrics.append({k: float(v) for k, v in m.items()})
    final = from_jax_params(jax.device_get(state.params), pcfg)
    task = (("MoETask", pcfg) if stage is None else
            ({"sons": "TreeSonsTask", "full": "TreeFullTask"}[stage], pcfg,
             CMAP))
    run = dict(family="MoEClassifier" if stage is None else "TreeViT",
               model_cfg=pcfg, task=task, stage=stage, init_params=init,
               cfg=port_config(dataclasses.replace(
                   tcfg, mesh=MeshConfig(num_expert_shards=2))),
               batches=_batches(), eval_images=_eval_images())
    return (logits, metrics, final), run


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep_ref")
    return {name: _jax_reference(tmp, name) for name in CONFIGS}


@pytest.fixture(scope="module", params=[2, 4], ids=["ep2", "dp2_ep2"])
def ranks(request, references, tmp_path_factory):
    world = request.param
    tmp = tmp_path_factory.mktemp(f"ep{world}")
    outs = spawn(tmp, "steps", world,
                 {"runs": [references[n][1] for n in CONFIGS]}, timeout=240)
    return world, outs


@pytest.mark.parametrize("name", CONFIGS)
def test_expert_parallel_steps_equal_jax(ranks, references, name):
    world, outs = ranks
    run = CONFIGS.index(name)
    (want_logits, want_metrics, want_params), spec = references[name]
    mine = [o[run] for o in outs]
    num_data = world // 2
    assert [(o["data_index"], o["expert_index"]) for o in mine] == \
        [(r // 2, r % 2) for r in range(world)]
    assert [o["view"] for o in mine] == \
        [(r // 2, num_data) for r in range(world)]
    # logits: each data index's rows, equal over its expert group
    for o in mine:
        rows = slice(o["view"][0] * 8 // num_data,
                     (o["view"][0] + 1) * 8 // num_data)
        np.testing.assert_allclose(o["logits"].numpy(), want_logits[rows],
                                   rtol=1e-5, atol=1e-6)
    for o in mine:
        assert o["metrics"] == mine[0]["metrics"]
        for g, w in zip(o["metrics"], want_metrics, strict=True):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-6,
                                           err_msg=f"{name} {k}")
    # every member is held by the ranks of its expert index alone
    model_cfg = spec["model_cfg"]
    stack = "experts" if name.startswith("moe") else "sons"
    members = (model_cfg.num_experts if stack == "experts"
               else model_cfg.num_categories)
    for o in mine:
        owned = {sharding.member_of(k)[1] for k in o["held"]
                 if sharding.member_of(k)}
        assert owned == set(sharding.owned_members(members, 2,
                                                   o["expert_index"]))
        # the other members are on the meta device, not stale copies
        assert o["released"] == {
            k for k in spec["init_params"] if sharding.member_of(k)
            and sharding.member_of(k)[1] not in owned}
    got = merged(mine)
    assert got.keys() == want_params.keys()
    for k in want_params:
        torch.testing.assert_close(got[k], want_params[k], atol=1e-5,
                                   rtol=1e-5, msg=f"{name} {k}")
