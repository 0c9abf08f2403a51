"""The mixture families' training against the JAX package's, on the CPU.

- ``Trainer`` steps with ``MoETask`` (dense, sparse-feature with drops,
  sparse-image; ``gateway_t=0``, so the two frameworks' noise draws do not
  enter) against JAX's ``Trainer`` from the same parameters and batches,
  the ``resmoe`` preset's SGD with 4-step accumulation: loss, grad_norm and
  every task scalar within 1e-5 at each of the 4 steps before the update
  (grad_norm within 1e-4 after it), the parameters after the update within
  1e-5;
- the TreeViT stage tasks (root, teacher-forced sons, full) the same way,
  under each stage's ``param_filter``;
- the stage masks select the parameters JAX's ``_mask_for_stage`` selects,
  leaf for leaf through ``from_jax_params``; the category maps equal JAX's;
- ``train.resmoe.main --tiny`` and ``train.treevit.main --tiny`` for one
  epoch on ``--device cpu``, then ``--transform``, then serve from the
  export (equal to a Predictor on the restored model), ``infer.filter
  --model resmoe``, the accuracy sweep's ResMoE row and the web daemon on
  that export.
"""
import contextlib
import csv
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from fixtures import make_image_folder
from test_torch_copies import port_config
from touhouimageclassification_tpu.config import (
    PRESETS, AugmentConfig, CheckpointConfig, MixConfig, MoEConfig,
    TrainConfig, TreeViTConfig, ViTConfig)
from touhouimageclassification_tpu.models.resmoe import \
    MoEClassifier as JaxMoE
from touhouimageclassification_tpu.models.treevit import TreeViT as JaxTree
from touhouimageclassification_tpu.parallel.mesh import (create_mesh,
                                                         data_sharding)
from touhouimageclassification_tpu.train import tasks as jtasks
from touhouimageclassification_tpu.train import treevit as jtreevit
from touhouimageclassification_tpu.train.trainer import Trainer as JaxTrainer
from touhouimageclassification_tpu_torch.analysis import acc
from touhouimageclassification_tpu_torch.data import get_class_to_idx
from touhouimageclassification_tpu_torch.infer import filter as port_filter
from touhouimageclassification_tpu_torch.infer import serve
from touhouimageclassification_tpu_torch.models import (MoEClassifier,
                                                        TreeViT, input_size)
from touhouimageclassification_tpu_torch.train import resmoe, tasks, treevit
from touhouimageclassification_tpu_torch.train.trainer import Trainer
from touhouimageclassification_tpu_torch.utils.convert import from_jax_params
from touhouimageclassification_tpu_torch.web import runtime

torch.set_num_threads(1)

N_CLASSES = 4
STEPS = 5
TINY_VIT = ViTConfig(image_size=16, patch_size=8, hidden_size=16, num_layers=1,
                     num_heads=2, mlp_dim=32, num_classes=N_CLASSES)


def _train_cfg(tmp, model_type):
    return TrainConfig(
        train_id="families", model_type=model_type, global_batch_size=8,
        seed=0, optimizer=PRESETS["resmoe"].optimizer,
        augment=AugmentConfig(enable_augmentation=False),
        mix=MixConfig(enable_mixup=False),
        checkpoint=CheckpointConfig(directory=str(tmp / "c"),
                                    async_save=False),
        log_dir=str(tmp / "l"))


def _batches(n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (8, 16, 16, 3)).astype(np.uint8),
             "label": rng.integers(0, N_CLASSES, 8).astype(np.int32),
             "mask": np.ones(8, bool)} for _ in range(n)]


def _class_to_category():
    return np.array([0, 0, 1, 1], np.int32)


def _pair(name):
    """(JAX model, JAX task, port model class, port task, model config,
    param filter name) of a configuration."""
    if name.startswith("moe"):
        routing, level, factor = {
            "moe_dense": ("dense", "feature", 1.25),
            "moe_sparse_feature": ("sparse", "feature", 0.75),
            "moe_sparse_image": ("sparse", "image", 1.0)}[name]
        cfg = MoEConfig(num_experts=3, top_k=2, num_classes=N_CLASSES,
                        routing=routing, dispatch_level=level,
                        capacity_factor=factor, gateway_t=0.0,
                        balance_loss="switch" if level == "image"
                        else "quadratic", expert_vit=TINY_VIT)
        return (JaxMoE(cfg, compute_dtype="float32"), jtasks.MoETask(cfg),
                MoEClassifier, tasks.MoETask(port_config(cfg)), cfg, None)
    stage = name.removeprefix("tree_")
    cfg = TreeViTConfig(num_categories=2, num_classes=N_CLASSES, top_k=1,
                        capacity_factor=1.0, vit=TINY_VIT)
    cls = {"root": "TreeRootTask", "sons": "TreeSonsTask",
           "full": "TreeFullTask"}[stage]
    cmap = _class_to_category()
    return (JaxTree(cfg, compute_dtype="float32"),
            getattr(jtasks, cls)(cfg, cmap), TreeViT,
            getattr(tasks, cls)(port_config(cfg), cmap), cfg, stage)


CONFIGS = ["moe_dense", "moe_sparse_feature", "moe_sparse_image",
           "tree_root", "tree_sons", "tree_full"]


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    """name -> per-step (JAX metrics, port metrics), and the parameters
    (JAX's as a port state dict, the port's) after the first update."""
    cache = {}

    def run(name):
        if name in cache:
            return cache[name]
        jmodel, jtask, cls, ptask, cfg, stage = _pair(name)
        tmp = tmp_path_factory.mktemp(name)
        model_type = "vit-moe" if name.startswith("moe") else "tree-vit"
        tcfg = _train_cfg(tmp, model_type)
        mesh = create_mesh(num_data=1, devices=jax.devices()[:1])
        jt = JaxTrainer(tcfg, model=jmodel, task=jtask, mesh=mesh,
                        param_filter=stage and jtreevit._mask_for_stage(stage))
        jstate = jt.init_state(4)
        step = jt._make_train_step()
        pcfg = port_config(cfg)
        pt = Trainer(port_config(tcfg), model=cls(pcfg, "float32", "cpu",
                                                  param_dtype="float32"),
                     task=ptask, device="cpu",
                     init_params=from_jax_params(
                         jax.device_get(jstate.params), pcfg),
                     param_filter=stage and treevit._mask_for_stage(stage))
        pstate = pt.init_state(4)
        metrics, params = [], None
        k = tcfg.optimizer.grad_accum_steps
        for i, batch in enumerate(_batches(), start=1):
            jstate, jm = step(jstate, jax.device_put(batch,
                                                     data_sharding(mesh)))
            pm = pt.train_step(pstate, pt.stage(batch))
            metrics.append(({k_: float(v) for k_, v in jm.items()}, pm))
            if i == k:
                params = (from_jax_params(jax.device_get(jstate.params), pcfg),
                          {n: p.detach().clone() for n, p in
                           pstate.model.named_parameters()})
        cache[name] = metrics, params
        return cache[name]

    return run


@pytest.mark.parametrize("name", CONFIGS)
def test_steps_match_jax_trainer(trajectories, name):
    """f32 on the CPU: sums in other orders. Steps 1-4 run on the same
    parameters: every scalar within 1e-5 relative (the routing telemetry's
    counts and shares are exact). Step 5 runs after the update, from
    parameters up to 3e-7 apart, which this random tiny model's curvature
    turns into grad_norm up to 2.9e-5 apart (measured): 1e-4 there."""
    metrics, _ = trajectories(name)
    k = PRESETS["resmoe"].optimizer.grad_accum_steps
    for step, (jm, pm) in enumerate(metrics, start=1):
        assert jm.keys() == pm.keys(), (step, jm.keys(), pm.keys())
        for key in jm:
            rtol = 1e-4 if step > k and key == "grad_norm" else 1e-5
            np.testing.assert_allclose(pm[key], jm[key], rtol=rtol,
                                       atol=1e-6, err_msg=f"{key} {step}")
    if name.startswith("moe_sparse"):
        assert {"drop_frac", "expert_load_max", "expert_load_min"} <= \
            metrics[0][1].keys()
        if name == "moe_sparse_feature":
            assert any(pm["drop_frac"] > 0 for _, pm in metrics)


@pytest.mark.parametrize("name", CONFIGS)
def test_parameters_after_the_first_update_match_jax(trajectories, name):
    """After 4 accumulated steps (one SGD update at lr 5e-2): every
    parameter within 1e-5, frozen ones unmoved."""
    _, (jparams, pparams) = trajectories(name)
    assert jparams.keys() == pparams.keys()
    for k in jparams:
        torch.testing.assert_close(pparams[k], jparams[k], atol=1e-5,
                                   rtol=1e-5, msg=k)


@pytest.mark.parametrize("stage", ["root", "sons", "full"])
def test_stage_masks_select_what_jax_selects(stage, tmp_path):
    """JAX's mask over its tree (stacked sons), carried leaf for leaf
    through from_jax_params, is the port Trainer's trainable mask."""
    cfg = TreeViTConfig(num_categories=3, num_classes=N_CLASSES, top_k=1,
                        vit=TINY_VIT)
    params = jax.device_get(JaxTree(cfg, compute_dtype="float32").init(
        jax.random.key(0), np.zeros((1, 16, 16, 3), np.float32)))["params"]
    jmask = jtreevit._mask_for_stage(stage)

    def marked(path, leaf):
        keys = tuple(str(getattr(k, "key", k)) for k in path)
        on = True if jmask is None else bool(jmask(keys))
        return np.full(np.shape(leaf), float(on), np.float32)

    want = from_jax_params(jax.tree_util.tree_map_with_path(marked, params),
                           port_config(cfg))
    trainer = Trainer(port_config(_train_cfg(tmp_path, "tree-vit")),
                      model=TreeViT(port_config(cfg), "float32", "cpu"),
                      device="cpu",
                      param_filter=treevit._mask_for_stage(stage))
    got = trainer._trainable_mask()
    assert got.keys() == want.keys()
    for k, on in got.items():
        assert torch.equal(want[k], torch.full_like(want[k], float(on))), k
    assert any(got.values())


@pytest.mark.parametrize("n_classes,n_cats", [(10, 3), (120, 8), (4, 8),
                                              (7, 7)])
def test_category_maps_equal_jax(n_classes, n_cats, tmp_path):
    classes = [f"c{i:03d}" for i in range(n_classes)][::-1]
    c2i = {c: i for i, c in enumerate(sorted(classes))}
    m = treevit.default_category_map(classes, n_cats)
    assert m == jtreevit.default_category_map(classes, n_cats)
    np.testing.assert_array_equal(treevit.make_class_to_category(m, c2i),
                                  jtreevit.make_class_to_category(m, c2i))
    path = tmp_path / "category.csv"
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["class", "category"])
        writer.writerows(sorted(m.items()))
    assert treevit.load_map_dict(str(path)) == jtreevit.load_map_dict(
        str(path)) == m


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_image_folder(str(tmp_path_factory.mktemp("fam_cli")),
                             num_classes=N_CLASSES, per_class=8, size=40)


def _argv(corpus):
    return ["--tiny", "--data-dir", corpus, "--max-epochs", "1", "--seed",
            "0", "--device", "cpu"]


def _serve_and_compare(model_flag, export, corpus, restored, workdir):
    """serve --full from the export: its CSV equals a Predictor's on the
    restored model, served in the serving dtype."""
    out = workdir / f"{model_flag}.csv"
    serve.main(["--model", model_flag, "--weights", export, "--image",
                corpus, "--data-dir", corpus, "--output", str(out), "--full",
                "--canvas-cache", "off", "--device", "cpu"])
    model = type(restored)(restored.cfg, device="cpu")
    model.load_state_dict(restored.state_dict())
    with open(os.path.join(export, "serving_meta.json")) as f:
        meta = json.load(f)
    pred = serve.Predictor(model=model, class_to_idx=get_class_to_idx(corpus),
                           image_size=input_size(model), mean=meta["mean"],
                           std=meta["std"], device=torch.device("cpu"))
    mem = workdir / f"{model_flag}_memory.csv"
    serve.full_judge(pred, corpus, str(mem), progress=False,
                     canvas_cache="off")
    rows = []
    for path in (out, mem):
        with open(path, newline="") as f:
            rows.append([r[1] for r in csv.reader(f)])
    assert rows[0] == rows[1] and len(rows[0]) == N_CLASSES * 8 + 1
    return meta


@pytest.fixture(scope="module")
def resmoe_run(corpus, tmp_path_factory):
    """``resmoe --tiny --routing sparse --num-experts 3`` for one epoch,
    then ``--transform``: (trainer, export, working directory)."""
    work = tmp_path_factory.mktemp("resmoe_cli")
    argv = [*_argv(corpus), "--routing", "sparse", "--num-experts", "3"]
    with contextlib.chdir(work):
        trainer = resmoe.main([*argv, "--no-resume"])
        export = str(work / "export")
        resmoe.main([*argv, "--transform", export])
    return trainer, export, work


def test_resmoe_cli_fit_and_export(resmoe_run):
    """The epoch's record carries the routing telemetry; the export names
    its config (3 tiny experts), no ViT config."""
    trainer, export, work = resmoe_run
    with open(work / "log" / "ResMoE" / "metrics.jsonl") as f:
        record = json.loads(f.readline())
    assert np.isfinite(record["train_loss"])
    assert {"drop_frac", "expert_load_max", "expert_load_min",
            "balance_loss", "val_acc"} <= record.keys()
    with open(os.path.join(export, "serving_meta.json")) as f:
        meta = json.load(f)
    assert meta["moe_config"]["num_experts"] == 3
    assert meta["moe_config"]["expert_vit"]["hidden_size"] == 32
    assert meta["model_type"] == "vit-moe" and "vit_config" not in meta
    with contextlib.chdir(work), pytest.raises(NotImplementedError,
                                               match="item 12"):
        resmoe.main([*_argv(trainer.cfg.data_dir), "--expert-shards", "2"])


def test_resmoe_export_serves_as_the_trained_model(resmoe_run, corpus,
                                                    tmp_path):
    trainer, export, _ = resmoe_run
    _serve_and_compare("resmoe", export, corpus, trainer.state.model,
                       tmp_path)


def test_resmoe_export_filter_and_acc_row(resmoe_run, corpus, tmp_path):
    """``infer.filter --model resmoe`` keeps the judge's correct rows; the
    accuracy table's ResMoE row scores the export."""
    _, export, _ = resmoe_run
    kept = tmp_path / "kept"
    port_filter.main(["--model", "resmoe", "--weights", export, "--image",
                      corpus, "-od", str(kept), "--csv-file",
                      str(tmp_path / "judge.csv"), "--canvas-cache", "off",
                      "--device", "cpu"])
    with open(tmp_path / "judge.csv", newline="") as f:
        correct = sum(r["correct"] == "True" for r in csv.DictReader(f))
    assert correct == sum(len(files) for _, _, files in os.walk(kept))
    row = next(r for r in acc.MODELS if r[0] == "ResMoE")
    rows = acc.run_sweep([(row[0], row[1], export)], test_dir=corpus,
                         result_dir=str(tmp_path / "result"),
                         data_dir=corpus, canvas_cache="off", device="cpu")
    assert rows[0]["status"] == "ok" and 0 <= rows[0]["acc"] <= 1


def test_web_runtime_serves_a_resmoe_export(resmoe_run, corpus,
                                            monkeypatch):
    """The web daemon on the export: its answers are the Predictor's."""
    _, export, _ = resmoe_run
    from PIL import Image

    monkeypatch.setattr(runtime, "MODEL_TYPE", "resmoe")
    monkeypatch.setattr(runtime, "WEIGHTS_PATH", export)
    monkeypatch.setattr(runtime, "DATA_DIR", corpus)
    monkeypatch.setattr(runtime, "DEVICE", "cpu")
    paths = sorted(os.path.join(root, f) for root, _, files in
                   os.walk(corpus) for f in files if f.endswith(".jpg"))[:5]
    images = [Image.open(p).convert("RGB") for p in paths]
    try:
        answers, cold = runtime.serve_batch(images, target_lang="CN")
        want = serve.init(modelt="resmoe", weights=export, data_dir=corpus,
                          device="cpu").predict_images(images)
    finally:
        runtime.daemon.stop()
    assert cold and [a[0] for a in answers] == [w[0] for w in want]
    np.testing.assert_allclose([a[1] for a in answers],
                               [w[1] for w in want], atol=1e-6)


def test_treevit_cli_stages_transform_serve(corpus, tmp_path):
    with contextlib.chdir(tmp_path):
        trainer = treevit.main([*_argv(corpus), "--no-resume",
                                "--num-categories", "2"])
        for stage in ("root", "sons", "full"):
            with open(os.path.join("log", f"TreeViT_{stage}",
                                   "metrics.jsonl")) as f:
                record = json.loads(f.readline())
            assert np.isfinite(record["train_loss"]), stage
        export = str(tmp_path / "export")
        treevit.main([*_argv(corpus), "--num-categories", "2", "--stage",
                      "full", "--transform", export])
        meta = _serve_and_compare("treevit", export, corpus,
                                  trainer.state.model, tmp_path)
        assert meta["treevit_config"]["num_categories"] == 2
        assert meta["model_type"] == "tree-vit"


def test_treevit_stages_chain_their_parameters(corpus, tmp_path):
    """root trains only the root, sons only the sons, each stage starting
    where the last ended; an explicit --restore seeds the first stage only."""
    seen = []
    original = treevit.run

    def recording(cfg, args, model=None, task=None, param_filter=None,
                  init_params=None):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        seen.append((cfg.train_id, args.restore, init_params is None))
        trainer = original(cfg, args, model=model, task=task,
                           param_filter=param_filter, init_params=init_params)
        after = model.state_dict()
        moved = {k.split(".")[0] for k in before
                 if not torch.equal(before[k], after[k])}
        seen.append(moved)
        return trainer

    with contextlib.chdir(tmp_path):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(treevit, "run", recording)
            treevit.main([*_argv(corpus), "--no-resume", "--num-categories",
                          "2", "--max-epochs", "1"])
            root_ckpt = str(tmp_path / "checkpoint" / "TreeViT_root")
            treevit.main([*_argv(corpus), "--num-categories", "2",
                          "--stage", "all", "--restore", root_ckpt,
                          "--max-epochs", "2"])
    assert seen[:6] == [("TreeViT_root", None, True), {"root"},
                        ("TreeViT_sons", None, False), {"sons"},
                        ("TreeViT_full", None, False), {"root", "sons"}]
    assert [s[:2] for s in seen[6::2]] == [("TreeViT_root", root_ckpt),
                                           ("TreeViT_sons", None),
                                           ("TreeViT_full", None)]
