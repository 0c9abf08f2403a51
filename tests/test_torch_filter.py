"""The port's filter, accuracy sweep and default-checkpoint registry against
the JAX package's, on the CPU.

- ``filter``: the same judge CSV gives the same ImageFolder tree, file for
  file, and the same ``(total, kept)``;
- ``filter --model``: both packages judge the same dataset with the same
  HF ``.pth`` (a tiny f32 ViT on both sides) and keep the same tree; the
  judge CSVs agree on every predicted class, confidences within 2e-4 (f32
  summation order, printed to four decimals);
- ``run_sweep`` over a table of a ViT ``.pth``, a ResNet-18 ``.pth`` and a
  missing checkpoint writes the same ``acc.csv`` rows in both packages;
  the table's ResMoE row scores a port ResMoE export;
- ``init`` without ``--weights`` loads a port export written at the
  registry path, and a registry path with nothing there, or with a JAX
  Orbax export, raises the port's clear errors.
"""
import csv
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from chip_smoke import hf_vit_state_dict
from fixtures import make_image_folder
from test_torch_copies import port_config
from test_torch_resnet import torchvision_resnet18_sd
from touhouimageclassification_tpu.analysis import acc as jax_acc
from touhouimageclassification_tpu.config import ResNetConfig, ViTConfig
from touhouimageclassification_tpu.infer import filter as jax_filter
from touhouimageclassification_tpu.infer import serve as jax_serve
from touhouimageclassification_tpu.models.resnet import ResNet as JaxResNet
from touhouimageclassification_tpu.models.vit import ViT as JaxViT
from touhouimageclassification_tpu_torch.analysis import acc
from touhouimageclassification_tpu_torch.config import MoEConfig
from touhouimageclassification_tpu_torch.data import get_class_to_idx
from touhouimageclassification_tpu_torch.infer import filter as port_filter
from touhouimageclassification_tpu_torch.infer import serve
from touhouimageclassification_tpu_torch.models import MoEClassifier
from touhouimageclassification_tpu_torch.models.resnet import ResNet
from touhouimageclassification_tpu_torch.models.vit import ViT
from touhouimageclassification_tpu_torch.train.checkpoint import save_params

torch.set_num_threads(1)

N_CLASSES = 3
TINY = ViTConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                 num_heads=4, mlp_dim=128, num_classes=N_CLASSES)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_image_folder(str(tmp_path_factory.mktemp("filter_data")),
                             num_classes=N_CLASSES, per_class=6, size=40)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """An HF-layout tiny-ViT .pth and a torchvision-layout ResNet-18 .pth."""
    root = tmp_path_factory.mktemp("filter_weights")
    vit, res = str(root / "vit.pth"), str(root / "resnet18.pth")
    torch.save(hf_vit_state_dict(64, 2, 128, N_CLASSES, image_size=32,
                                 patch=8), vit)
    torch.save(torchvision_resnet18_sd(N_CLASSES), res)
    return vit, res


@pytest.fixture
def f32_models(monkeypatch):
    """Both packages' model factories pinned to f32 models: the tiny ViT for
    'vit-*' (served at 32x32), ResNet-18 for 'resnet18'."""
    def jax_model(mt, num_classes):
        if mt.startswith("resnet"):
            return JaxResNet(ResNetConfig(depth=18, num_classes=num_classes),
                             compute_dtype="float32")
        return JaxViT(dataclasses.replace(TINY, num_classes=num_classes),
                      compute_dtype="float32")

    def port_model(mt, num_classes, device):
        if mt.startswith("resnet"):
            return ResNet(port_config(ResNetConfig(
                depth=18, num_classes=num_classes)), "float32", device)
        return ViT(port_config(dataclasses.replace(
            TINY, num_classes=num_classes)), "float32", device)

    monkeypatch.setattr(jax_serve, "get_model", jax_model)
    monkeypatch.setattr(
        jax_serve, "get_image_size",
        lambda mt: (256, 256) if mt.startswith("resnet") else (32, 32))
    monkeypatch.setattr(serve, "create_model", port_model)


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_filter_builds_the_same_tree(dataset, tmp_path):
    """A judge CSV with every third row wrong: both filters copy the same
    files and count the same."""
    rows = []
    for i, (dirpath, _d, files) in enumerate(sorted(
            (d, None, sorted(f)) for d, _, f in os.walk(dataset) if f)):
        label = os.path.basename(dirpath)
        for j, name in enumerate(files):
            predicted = label if (i + j) % 3 else "class_99"
            rows.append([name, predicted, "0.5000", label,
                         predicted == label, os.path.join(dirpath, name)])
    judge = tmp_path / "judge.csv"
    with open(judge, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(["filename", "predicted_class", "confidence",
                         "actual_class", "correct", "path"])
        writer.writerows(rows)
    got = port_filter.filter(str(judge), str(tmp_path / "port"))
    want = jax_filter.filter(str(judge), str(tmp_path / "jax"))
    assert got == want == (len(rows), sum(r[4] for r in rows))
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert port_filter.FilterReport(*got).keep_rate == pytest.approx(
        jax_filter.FilterReport(*want).keep_rate)


def _judge(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_filter_with_model_matches_jax(dataset, weights, f32_models,
                                       tmp_path):
    vit, _ = weights
    out = {}
    for name, main in (("jax", jax_filter.main), ("port", port_filter.main)):
        args = ["--model", "vit-base", "--weights", vit, "--image", dataset,
                "-od", str(tmp_path / name), "--csv-file",
                str(tmp_path / f"{name}.csv"), "--canvas-cache", "off"]
        main(args + (["--device", "cpu"] if name == "port" else []))
        out[name] = _judge(tmp_path / f"{name}.csv")
    assert len(out["port"]) == len(out["jax"]) == N_CLASSES * 6
    for p, j in zip(out["port"], out["jax"]):
        assert p["path"] == j["path"]
        assert p["predicted_class"] == j["predicted_class"]
        assert abs(float(p["confidence"]) - float(j["confidence"])) <= 2e-4
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def test_filter_temp_csv_and_dp(dataset, weights, f32_models, tmp_path,
                                monkeypatch, capsys):
    """Without --csv-file the judge CSV is temporary and removed. ``--dp 2``
    (two replicas on the host, each bucket split over them) keeps the tree
    ``--dp 1`` keeps and judges every image alike; ``--dp 3`` is adjusted
    to 2 with JAX's message (3 divides no 64-image bucket)."""
    monkeypatch.chdir(tmp_path)
    vit, _ = weights
    base = ["--model", "vit-base", "--weights", vit, "--image", dataset,
            "--device", "cpu"]
    port_filter.main([*base, "-od", str(tmp_path / "kept")])
    assert not (tmp_path / "filter_temp.csv").exists()
    assert _tree(tmp_path / "kept")
    for dp in ("1", "2"):
        port_filter.main([*base, "-od", str(tmp_path / f"kept{dp}"),
                          "--csv-file", str(tmp_path / f"dp{dp}.csv"),
                          "--dp", dp])
    assert _tree(tmp_path / "kept2") == _tree(tmp_path / "kept1") == \
        _tree(tmp_path / "kept")
    one, two = _judge(tmp_path / "dp1.csv"), _judge(tmp_path / "dp2.csv")
    assert [r["predicted_class"] for r in two] == \
        [r["predicted_class"] for r in one]
    assert max(abs(float(a["confidence"]) - float(b["confidence"]))
               for a, b in zip(one, two)) <= 1e-4
    predictor = serve.init(modelt="vit-base", weights=vit, data_dir=dataset,
                           device="cpu", dp=3)
    assert len(predictor.replicas) == 2
    assert "--dp 3 adjusted to 2" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        port_filter.main(["-od", str(tmp_path / "x")])


def test_run_sweep_writes_the_same_acc_csv(dataset, weights, f32_models,
                                           tmp_path):
    vit, res = weights
    table = [("ViT_tiny", "vit-base", vit), ("ResNet18", "resnet18", res),
             ("Missing", "vit-large", str(tmp_path / "nowhere"))]
    rows = {}
    for name, module, kw in (("jax", jax_acc, {}),
                             ("port", acc, {"device": "cpu"})):
        result = tmp_path / name
        rows[name] = module.run_sweep(table, test_dir=dataset,
                                      result_dir=str(result),
                                      data_dir=dataset, canvas_cache="off",
                                      **kw)
        with open(result / "acc.csv", newline="") as f:
            rows[name] = (rows[name], list(csv.reader(f)))
    assert rows["port"] == rows["jax"]
    assert [r["status"] for r in rows["port"][0]] == [
        "ok", "ok", "missing_checkpoint"]
    assert acc.MODELS == jax_acc.MODELS


def test_run_sweep_raises_for_an_unported_family(dataset, tmp_path):
    """The pinned table's ResMoE row, once a family the port lacked: with a
    port ResMoE export at its path (3 tiny experts, its ``moe_config`` in
    the meta) the row loads and is scored, as the Predictor on the same
    model scores it; a checkpoint of another family at that path raises."""
    name, mtype, _ = next(r for r in acc.MODELS if r[0] == "ResMoE")
    cfg = MoEConfig(num_experts=3, top_k=2, num_classes=N_CLASSES,
                    expert_vit=port_config(TINY))
    model = MoEClassifier(cfg, "float32", "cpu", seed=5)
    export = tmp_path / "resmoe"
    export.mkdir()
    save_params(str(export / "params.safetensors"), model.state_dict())
    (export / "serving_meta.json").write_text(json.dumps({
        "model_type": "vit-moe", "epoch": 1, "mean": [0.5] * 3,
        "std": [0.25] * 3, "moe_config": dataclasses.asdict(cfg)}))
    rows = acc.run_sweep([(name, mtype, str(export))], test_dir=dataset,
                         result_dir=str(tmp_path / "moe"), data_dir=dataset,
                         canvas_cache="off", device="cpu")
    pred = serve.Predictor(model=model, class_to_idx=get_class_to_idx(dataset),
                           image_size=(32, 32), mean=np.full(3, 0.5),
                           std=np.full(3, 0.25), device=torch.device("cpu"))
    want = serve.full_judge(pred, dataset, progress=False, canvas_cache="off")
    assert rows == [{"name": "ResMoE", "acc": want, "status": "ok"}]
    (export / "serving_meta.json").write_text(json.dumps({
        "model_type": "vit-moe", "mean": [0.5] * 3, "std": [0.25] * 3}))
    with pytest.raises(ValueError, match="names no model config"):
        acc.run_sweep([(name, mtype, str(export))], test_dir=dataset,
                      result_dir=str(tmp_path / "moe2"), data_dir=dataset,
                      canvas_cache="off", device="cpu")


def test_registry_fallback_loads_a_port_export(dataset, tmp_path,
                                               monkeypatch):
    """init(modelt='nvit', data_dir=...) without weights: the registry path
    holds a port export (its meta names the ViT config), which loads; a
    registry path with nothing there or with a JAX Orbax export raises."""
    monkeypatch.chdir(tmp_path)
    assert serve.model_checkpoints == jax_serve.model_checkpoints
    export = tmp_path / "checkpoint" / "serving" / "nvit"
    export.mkdir(parents=True)
    model = ViT(port_config(TINY), "float32", "cpu", seed=3)
    save_params(str(export / "params.safetensors"), model.state_dict())
    (export / "serving_meta.json").write_text(json.dumps({
        "model_type": "vit-large", "epoch": 1, "mean": [0.5] * 3,
        "std": [0.25] * 3, "vit_config": dataclasses.asdict(TINY)}))
    predictor = serve.init(modelt="nvit", data_dir=dataset, device="cpu")
    assert isinstance(predictor.model, ViT)
    for k, v in predictor.model.state_dict().items():
        assert torch.equal(v, model.state_dict()[k].to(v.dtype)), k
    pred, conf = predictor.predict_array(
        np.zeros((2, 32, 32, 3), np.uint8))
    assert pred.shape == (2,) and np.isfinite(conf).all()

    with pytest.raises(FileNotFoundError, match="default path"):
        serve.init(modelt="vit-large", data_dir=dataset, device="cpu")
    orbax = tmp_path / "checkpoint" / "serving" / "vit_base_finetune"
    (orbax / "params").mkdir(parents=True)
    (orbax / "serving_meta.json").write_text(json.dumps({
        "model_type": "vit-base", "vit_config": dataclasses.asdict(TINY)}))
    with pytest.raises(FileNotFoundError, match="not a serving export"):
        serve.init(modelt="vit-base", data_dir=dataset, device="cpu")
    with pytest.raises(ValueError, match="No default checkpoint"):
        serve.init(modelt="treevit", data_dir=dataset, device="cpu")
