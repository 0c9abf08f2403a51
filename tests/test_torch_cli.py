"""The port's training CLIs, serving export and pretrained-backbone lookup.

- ``ntrain.main --tiny --device cpu``: one epoch, then ``--test``, then
  ``--transform`` to a serving export, then ``serve.main --weights
  <export>``, whose judge CSV equals the one of a Predictor on the model
  restored in memory; ``serving_meta.json`` equals the JAX package's for
  the same run (its ``ntrain --tiny`` fit and ``--transform``);
- ``finetune``'s warmup horizon, ``pretrain`` from the scratch init, the
  multi-host flags and ``--device cuda`` without a card raising;
- ``load_pretrained_backbone`` on synthetic HF snapshots against the JAX
  package's, and ``_adapt_head`` against its draws.
"""
import contextlib
import csv
import json
import os

import jax
import numpy as np
import pytest
import torch
import transformers

from fixtures import make_image_folder
from touhouimageclassification_tpu.utils import pretrained as jax_pretrained
from touhouimageclassification_tpu_torch.config import (IMAGENET_MEAN,
                                                        IMAGENET_STD, ViTConfig)
from touhouimageclassification_tpu_torch.data import get_class_to_idx
from touhouimageclassification_tpu_torch.infer import serve
from touhouimageclassification_tpu_torch.models.vit import ViT
from touhouimageclassification_tpu_torch.train import finetune, ntrain, pretrain
from touhouimageclassification_tpu_torch.train.checkpoint import (
    CheckpointManager)
from touhouimageclassification_tpu_torch.utils import pretrained
from touhouimageclassification_tpu_torch.utils.convert import (
    from_jax_params, torch_vit_to_flax)
from touhouimageclassification_tpu_torch.utils.profiling import StepTimer

torch.set_num_threads(1)

N_CLASSES = 4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_data")
    return make_image_folder(str(root), num_classes=N_CLASSES, per_class=8,
                             size=48)


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    """The presets' checkpoint/log/cache/test dirs are relative: a CLI run
    from a working directory, as a user launches one."""
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _common(corpus):
    return ["--tiny", "--data-dir", corpus, "--batch-size", "8",
            "--max-epochs", "1", "--seed", "0"]


@pytest.fixture(scope="module")
def jax_export(corpus, tmp_path_factory):
    """The JAX package's ntrain --tiny fit and --transform: its meta."""
    from touhouimageclassification_tpu.train import ntrain as jax_ntrain

    work = tmp_path_factory.mktemp("jax_cli")
    with contextlib.chdir(work):
        jax_ntrain.main([*_common(corpus), "--no-resume", "--no-pretrained"])
        jax_ntrain.main([*_common(corpus), "--no-pretrained", "--transform",
                         str(work / "export")])
    with open(work / "export" / "serving_meta.json") as f:
        return json.load(f)


def test_ntrain_fit_test_transform_serve(workdir, corpus, jax_export):
    base = [*_common(corpus), "--device", "cpu", "--no-pretrained"]
    trainer = ntrain.main([*base, "--no-resume"])
    with open(os.path.join("log", "nViT", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 1 and np.isfinite(records[0]["train_loss"])
    assert {"val_loss", "val_acc", "images_per_second"} <= records[0].keys()

    tested = ntrain.main([*base, "--test"])
    assert 0.0 <= tested.last_test_result["test_acc"] <= 1.0

    export = str(workdir / "export")
    ntrain.main([*base, "--transform", export])
    assert sorted(os.listdir(export)) == ["params.safetensors",
                                          "serving_meta.json"]
    with open(os.path.join(export, "serving_meta.json")) as f:
        meta = json.load(f)
    assert meta == jax_export

    out = workdir / "judge.csv"
    serve.main(["--model", "vit-large", "--weights", export, "--image",
                corpus, "--data-dir", corpus, "--output", str(out), "--full",
                "--canvas-cache", "off", "--device", "cpu"])
    # the in-memory model: the fit's checkpoint restored, served in the
    # serving dtype
    restored = ntrain.main([*base, "--test"]).state.model
    assert all(torch.equal(p, dict(trainer.state.model.named_parameters())[k])
               for k, p in restored.named_parameters())
    model = ViT(restored.cfg, device="cpu")
    model.load_state_dict(restored.state_dict())
    pred = serve.Predictor(model=model, class_to_idx=get_class_to_idx(corpus),
                           image_size=(32, 32), mean=IMAGENET_MEAN,
                           std=IMAGENET_STD, device=torch.device("cpu"))
    mem = workdir / "memory.csv"
    serve.full_judge(pred, corpus, str(mem), progress=False,
                     canvas_cache="off")
    rows = [[r[1] for r in csv.reader(open(p, newline=""))]
            for p in (out, mem)]
    assert rows[0] == rows[1] and len(rows[0]) == N_CLASSES * 8 + 1


def test_finetune_sets_the_warmup_horizon(workdir, corpus):
    trainer = finetune.main([*_common(corpus), "--no-pretrained",
                             "--device", "cpu", "--no-resume"])
    opt = trainer.state.optimizer.cfg
    # finetune_vit_base: train_split 0.9, warmup_linear
    assert opt.schedule == "warmup_linear"
    assert opt.total_steps == int(N_CLASSES * 8 * 0.9) // 8 * 1


def test_pretrain_runs_from_the_scratch_init(workdir, corpus):
    trainer = pretrain.main([*_common(corpus), "--device", "cpu",
                             "--no-resume"])
    assert trainer.state.step > 0
    assert CheckpointManager(trainer.cfg.checkpoint,
                             trainer.cfg.train_id).latest_epoch() == 1


@pytest.mark.parametrize("flag", [
    ["--coordinator", "head:1234", "--device", "cpu"],
    ["--coordinator", "head:1234", "--num-processes", "2", "--process-id",
     "2", "--device", "cpu"],
    ["--coordinator", "head:1234", "--num-processes", "2", "--process-id",
     "0", "--device", "cuda"]])
def test_multi_host_flags_raise(workdir, corpus, flag, monkeypatch):
    """The multi-host flags start a multi-process run (two ranks train in
    ``test_torch_multiprocess.py``); a launch they cannot describe raises
    before it reaches the coordinator: no world size or rank, a rank
    outside the world, a CUDA rank on a machine without a card (never a
    move to the CPU)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    match = {"--device cpu": "world size and rank|outside",
             "--device cuda": "no CUDA device"}[" ".join(flag[-2:])]
    with pytest.raises((ValueError, RuntimeError), match=match):
        ntrain.main([*_common(corpus), *flag])


def test_cuda_without_a_card_raises(workdir, corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ntrain.main([*_common(corpus), "--no-pretrained"])


def test_step_timer_laps():
    timer = StepTimer()
    timer.start()
    for _ in range(3):
        timer.lap(torch.ones(2) * 2)
    summary = timer.summary()
    assert summary["steps"] == 3 and summary["max_s"] >= summary["p50_s"] >= 0


# ---------------------------------------------------------------------------
# pretrained snapshots
# ---------------------------------------------------------------------------

SNAPSHOT = "google--vit-base-patch16-224-in21k"


def _hf_sd(num_labels=7):
    cfg = transformers.ViTConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, image_size=32, patch_size=16,
        num_labels=num_labels)
    torch.manual_seed(0)
    return transformers.ViTForImageClassification(cfg).state_dict()


def _tree_as_port(tree):
    depth = sum(k.startswith("layer_") for k in tree)
    return from_jax_params(jax.device_get(tree), ViTConfig(num_layers=depth))


@pytest.mark.parametrize("filename", ["pytorch_model.bin",
                                      "model.safetensors"])
@pytest.mark.parametrize("num_classes", [7, 11])
def test_snapshot_loads_as_jax_loads_it(tmp_path, filename, num_classes):
    snap = tmp_path / SNAPSHOT
    snap.mkdir()
    sd = _hf_sd()
    if filename.endswith(".bin"):
        torch.save(sd, snap / filename)
    else:
        from safetensors.torch import save_file

        save_file({k: v.contiguous() for k, v in sd.items()}, snap / filename)
    got = pretrained.load_pretrained_backbone("vit-base", num_classes,
                                              cache_dir=str(tmp_path))
    want = _tree_as_port(jax_pretrained.load_pretrained_backbone(
        "vit-base", num_classes, cache_dir=str(tmp_path)))
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert got["head.weight"].shape == (num_classes, 64)


def test_shard_only_snapshot_raises(tmp_path):
    snap = tmp_path / SNAPSHOT
    snap.mkdir()
    sd = _hf_sd()
    torch.save(sd, snap / "pytorch_model-00001-of-00002.bin")
    torch.save(sd, snap / "pytorch_model-00002-of-00002.bin")
    with pytest.raises(ValueError, match="sharded checkpoint"):
        pretrained.load_pretrained_backbone("vit-base", 5,
                                            cache_dir=str(tmp_path))


def test_several_whole_files_warn_and_pick_the_first(tmp_path):
    snap = tmp_path / SNAPSHOT
    (snap / "a").mkdir(parents=True)
    (snap / "b").mkdir()
    torch.save(_hf_sd(), snap / "a" / "pytorch_model.bin")
    other = _hf_sd()
    other["classifier.bias"] = other["classifier.bias"] + 1
    torch.save(other, snap / "b" / "pytorch_model.bin")
    with pytest.warns(UserWarning, match="2 weight files"):
        got = pretrained.load_pretrained_backbone("vit-base", 7,
                                                  cache_dir=str(tmp_path))
    assert torch.equal(got["head.bias"], _hf_sd()["classifier.bias"])


def test_nothing_found_warns_and_returns_none(tmp_path):
    with pytest.warns(UserWarning, match="No pretrained weights"):
        assert pretrained.load_pretrained_backbone(
            "vit-large", 5, cache_dir=str(tmp_path)) is None


@pytest.mark.parametrize("num_classes", [7, 120])
def test_adapted_head_is_jax_draw_transposed(num_classes):
    sd = _tree_as_port(torch_vit_to_flax(_hf_sd(), 7))
    got = pretrained._adapt_head(sd, 64, num_classes)
    tree = {"head": {"kernel": sd["head.weight"].numpy().T,
                     "bias": sd["head.bias"].numpy()}}
    want = jax_pretrained._adapt_head(tree, 64, num_classes)["head"]
    np.testing.assert_array_equal(got["head.weight"].numpy(),
                                  np.asarray(want["kernel"]).T)
    np.testing.assert_array_equal(got["head.bias"].numpy(),
                                  np.asarray(want["bias"]))


def test_ensure_finds_a_cached_snapshot(tmp_path):
    (tmp_path / SNAPSHOT).mkdir()
    assert pretrained.ensure("google/vit-base-patch16-224-in21k",
                             str(tmp_path)) == str(tmp_path / SNAPSHOT)
    with pytest.raises(FileNotFoundError, match="not cached"):
        pretrained.ensure("google/vit-large-patch16-224-in21k", str(tmp_path))
