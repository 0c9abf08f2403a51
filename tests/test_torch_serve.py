"""The port's serve path against the JAX serve path on one tiny f32 ViT.

Both Predictors hold the same weights (JAX ``ViT.init`` -> ``from_jax_params``)
and see the same uint8 images; predictions must be identical and confidences
within 1e-5 (f32 summation order).
"""
import csv
import dataclasses

import jax
import numpy as np
import pytest
import torch

from chip_smoke import hf_vit_state_dict
from fixtures import make_image_folder
from test_torch_copies import port_config
from touhouimageclassification_tpu.config import ViTConfig
from touhouimageclassification_tpu.data.folder import scan_image_folder
from touhouimageclassification_tpu.infer import serve as jax_serve
from touhouimageclassification_tpu.models.vit import ViT as JaxViT
from touhouimageclassification_tpu.ops.augment import resize as jax_resize
from touhouimageclassification_tpu_torch.infer import serve
from touhouimageclassification_tpu_torch.models.vit import ViT
from touhouimageclassification_tpu_torch.ops import attention
from touhouimageclassification_tpu_torch.ops.augment import resize
from touhouimageclassification_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)

N_CLASSES = 3
TINY = ViTConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                 num_heads=4, mlp_dim=128, num_classes=N_CLASSES)
MEAN, STD = np.array([0.5, 0.45, 0.4]), np.array([0.25, 0.2, 0.3])


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serve_data")
    return make_image_folder(str(root), num_classes=N_CLASSES, per_class=5,
                             size=32)


@pytest.fixture(scope="module")
def predictors(dataset):
    class_to_idx = scan_image_folder(dataset).class_to_idx
    jax_model = JaxViT(TINY, compute_dtype="float32")
    params = jax_model.init(jax.random.key(0),
                            np.zeros((1, 32, 32, 3), np.float32))["params"]
    ref = jax_serve.Predictor(model=jax_model, params=params, model_state={},
                              class_to_idx=class_to_idx, image_size=(32, 32),
                              mean=MEAN, std=STD)
    model = ViT(port_config(TINY), compute_dtype="float32", device="cpu")
    model.load_state_dict(from_jax_params(params, port_config(TINY)))
    port = serve.Predictor(model=model, class_to_idx=class_to_idx,
                           image_size=(32, 32), mean=MEAN, std=STD,
                           device=torch.device("cpu"))
    return ref, port


@pytest.mark.parametrize("n", [1, 8, 70])
def test_predict_array_matches_jax(predictors, n):
    ref, port = predictors
    imgs = np.random.default_rng(n).integers(0, 256, (n, 32, 32, 3),
                                             dtype=np.uint8)
    before = attention.launches
    pred, conf = port.predict_array(imgs)
    want_pred, want_conf = ref.predict_array(imgs)
    assert attention.launches == before, "CPU tensors never launch the kernel"
    assert pred.shape == (n,) and pred.dtype == np.int64
    np.testing.assert_array_equal(pred, want_pred)
    np.testing.assert_allclose(conf, want_conf, atol=1e-5, rtol=0)


def test_full_judge_csv_matches_jax(predictors, dataset, tmp_path):
    ref, port = predictors
    rows = {}
    for name, judge, pred in (("jax", jax_serve.full_judge, ref),
                              ("port", serve.full_judge, port)):
        out = tmp_path / f"{name}.csv"
        judge(pred, dataset, str(out), batch_size=8, progress=False,
              canvas_cache="off")
        with open(out, newline="") as f:
            rows[name] = list(csv.reader(f))
    assert rows["port"][0] == rows["jax"][0] == [
        "filename", "predicted_class", "confidence", "actual_class", "correct",
        "path"]
    assert len(rows["port"]) == N_CLASSES * 5 + 1
    assert [r[1] for r in rows["port"]] == [r[1] for r in rows["jax"]]


@pytest.mark.parametrize("src", [(48, 40), (20, 24)])
def test_resize_matches_jax(src):
    x = np.random.default_rng(0).random((2, *src, 3), dtype=np.float32)
    got = resize(torch.from_numpy(x), (32, 32)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_resize(x, (32, 32))),
                               atol=1e-5, rtol=0)


def test_canvas_cache_judge_resizes_on_device(predictors, tmp_path):
    """--canvas-cache on judges from 256x256 canvases resized to the model
    size, then a warm 'auto' judge reproduces the same CSV."""
    _, port = predictors
    data = make_image_folder(str(tmp_path / "d"), num_classes=N_CLASSES,
                             per_class=3, size=32)
    on, auto = tmp_path / "on.csv", tmp_path / "auto.csv"
    serve.full_judge(port, data, str(on), batch_size=4, progress=False,
                     canvas_cache="on")
    serve.full_judge(port, data, str(auto), batch_size=4, progress=False,
                     canvas_cache="auto")
    assert on.read_text() == auto.read_text()
    assert len(on.read_text().splitlines()) == N_CLASSES * 3 + 1


@pytest.fixture
def tiny_cli(monkeypatch, dataset, tmp_path):
    """The serve CLI on the tiny architecture: an HF-layout .pth of it, and
    the model factory pinned to it (f32, the requested device)."""
    pth = tmp_path / "tiny.pth"
    torch.save(hf_vit_state_dict(64, 2, 128, N_CLASSES, image_size=32,
                                 patch=8), pth)
    monkeypatch.setattr(
        serve, "create_model",
        lambda mt, num_classes, device: ViT(
            port_config(dataclasses.replace(TINY, num_classes=num_classes)),
            compute_dtype="float32", device=device))
    return str(pth)


def test_cli_runs_on_cpu(tiny_cli, dataset, tmp_path, capsys):
    out = tmp_path / "judge.csv"
    base = ["--model", "vit-base", "--weights", tiny_cli, "--data-dir", dataset,
            "--device", "cpu"]
    serve.main([*base, "--image", dataset, "--output", str(out), "--full",
                "--canvas-cache", "off"])
    assert len(out.read_text().splitlines()) == N_CLASSES * 5 + 1
    image = scan_image_folder(dataset).paths[0]
    serve.main([*base, "--image", image])
    assert "Prediction: class_" in capsys.readouterr().out


def test_init_never_falls_back_to_cpu(tiny_cli, dataset, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.init(modelt="vit-base", weights=tiny_cli, data_dir=dataset,
                   device="cuda")


def test_init_rejects_what_the_port_cannot_load(tiny_cli, dataset, tmp_path):
    """A directory is a serving export only with its serving_meta.json
    (``test_torch_cli.py`` serves a real one). ``--dp 2``, which the port
    once refused, now loads two replicas (on the CPU both on the host) and
    splits each judge bucket over them: the judge CSV predicts what
    ``--dp 1``'s does."""
    with pytest.raises(FileNotFoundError, match="serving_meta.json"):
        serve.init(modelt="vit-base", weights=str(tmp_path), data_dir=dataset,
                   device="cpu")
    rows = {}
    for dp in ("1", "2"):
        out = tmp_path / f"dp{dp}.csv"
        serve.main(["--model", "vit-base", "--image", dataset, "--weights",
                    tiny_cli, "--data-dir", dataset, "--device", "cpu",
                    "--full", "--canvas-cache", "off", "--output", str(out),
                    "--dp", dp])
        with open(out, newline="") as f:
            rows[dp] = list(csv.DictReader(f))
    assert len(rows["2"]) == len(rows["1"]) == N_CLASSES * 5
    for a, b in zip(rows["1"], rows["2"]):
        assert (a["path"], a["predicted_class"]) == \
            (b["path"], b["predicted_class"])
        assert abs(float(a["confidence"]) - float(b["confidence"])) <= 1e-4
