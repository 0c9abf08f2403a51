"""The port's web demo (``touhouimageclassification_tpu_torch.web``) against
the repository's JAX demo (``web/runtime.py``), on the CPU.

Both runtimes load the same torchvision-layout ResNet-18 ``.pth`` for the
same dataset (class folders named by the CN labels of
``web/th_name_lang_map.csv``), with their model factories pinned to f32:
``serve_batch`` gives the same labels after the CN -> JP/EN remap and
confidences within 1e-5 (f32 summation order). Then the port's daemon
alone: concurrent single-image requests coalesce into fewer device calls,
the idle timer unloads the model, and the WSGI app renders a result card
per uploaded image with the banner naming the daemon's device.
"""
import io
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_copies import port_config
from test_torch_resnet import torchvision_resnet18_sd
from test_webapps import _multipart, _wsgi_call
from touhouimageclassification_tpu.config import ResNetConfig
from touhouimageclassification_tpu.infer import serve as jax_serve
from touhouimageclassification_tpu.models.resnet import ResNet as JaxResNet
from touhouimageclassification_tpu_torch.infer import serve
from touhouimageclassification_tpu_torch.models.resnet import ResNet
from touhouimageclassification_tpu_torch.web import app as port_app
from touhouimageclassification_tpu_torch.web import runtime
from web import runtime as jax_runtime

torch.set_num_threads(1)

LABELS = ["博丽灵梦", "雾雨魔理沙", "十六夜咲夜"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("web_data")
    rng = np.random.default_rng(0)
    for c, label in enumerate(LABELS):
        (root / label).mkdir()
        for i in range(2):
            img = np.clip(rng.normal(80 * c + 40, 30, (40, 40, 3)), 0, 255)
            Image.fromarray(img.astype(np.uint8)).save(root / label / f"{i}.jpg")
    return str(root)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    path = tmp_path_factory.mktemp("web_weights") / "resnet18.pth"
    sd = torchvision_resnet18_sd(len(LABELS))
    sd["fc.weight"] = sd["fc.weight"] * 40   # decisive logits
    torch.save(sd, path)
    return str(path)


def _images(n, seed=1):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 256, (48 + 8 * i, 40, 3),
                                         dtype=np.uint8)) for i in range(n)]


def _stop(module):
    daemon = module.daemon
    with daemon.lock:
        if daemon.timer:
            daemon.timer.cancel()
            daemon.timer = None
        daemon.predictor = None


@pytest.fixture
def port_daemon(dataset, pth, monkeypatch):
    """The port's runtime on the .pth, f32 ResNet-18, on the CPU."""
    monkeypatch.setattr(runtime, "MODEL_TYPE", "resnet18")
    monkeypatch.setattr(runtime, "WEIGHTS_PATH", pth)
    monkeypatch.setattr(runtime, "DATA_DIR", dataset)
    monkeypatch.setattr(runtime, "DEVICE", "cpu")
    monkeypatch.setattr(serve, "create_model", lambda mt, num_classes, device:
                        ResNet(port_config(ResNetConfig(
                            depth=18, num_classes=num_classes)),
                            "float32", device))
    _stop(runtime)
    yield runtime
    _stop(runtime)


def test_serve_batch_matches_jax_runtime(port_daemon, dataset, pth,
                                         monkeypatch):
    monkeypatch.setattr(jax_runtime, "MODEL_TYPE", "resnet18")
    monkeypatch.setattr(jax_runtime, "WEIGHTS_PATH", pth)
    monkeypatch.setattr(jax_runtime, "DATA_DIR", dataset)
    monkeypatch.setattr(jax_serve, "get_model", lambda mt, num_classes:
                        JaxResNet(ResNetConfig(depth=18,
                                               num_classes=num_classes),
                                  compute_dtype="float32"))
    _stop(jax_runtime)
    images = _images(5)
    try:
        for lang in ("JP", "EN", "CN"):
            want, want_cold = jax_runtime.serve_batch(images, lang)
            got, got_cold = runtime.serve_batch(images, lang)
            assert got_cold == want_cold == (lang == "JP")
            assert [g[0] for g in got] == [w[0] for w in want]
            np.testing.assert_allclose([g[1] for g in got],
                                       [w[1] for w in want], atol=1e-5)
            if lang != "CN":
                assert not set(g[0] for g in got) & set(LABELS)
    finally:
        _stop(jax_runtime)
    assert runtime.is_daemon_running() and not runtime.is_daemon_accelerated()


def test_concurrent_requests_coalesce(port_daemon):
    """8 threads, one image each: every answer arrives and equals a
    single-request answer, in fewer device calls than requests (the first
    call is held 0.3 s so the rest queue behind it)."""
    images = _images(8, seed=2)
    solo = [runtime.daemon.predict([im])[0] for im in images]
    predictor = runtime.daemon.predictor
    calls = []
    original = predictor.predict_images

    def slow(batch):
        calls.append(len(batch))
        time.sleep(0.3 if len(calls) == 1 else 0.0)
        return original(batch)

    predictor.predict_images = slow
    results = [None] * len(images)

    def ask(i):
        results[i] = runtime.daemon.predict([images[i]])[0]

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert [r[0] for r in results] == [s[0] for s in solo]
    np.testing.assert_allclose([r[1] for r in results],
                               [s[1] for s in solo], atol=1e-5)
    assert sum(calls) == 8 and len(calls) < 8


def test_serve_batch_chunks_past_max_batch(port_daemon, monkeypatch):
    monkeypatch.setattr(runtime, "MAX_BATCH_SIZE", 4)
    got, cold = runtime.serve_batch(_images(9), "EN")
    assert cold and len(got) == 9


def test_idle_unload(port_daemon, monkeypatch):
    monkeypatch.setattr(runtime, "INACTIVITY_TIMEOUT", 0.2)
    runtime.serve_batch(_images(1), "EN")
    assert runtime.is_daemon_running()
    deadline = time.time() + 10
    while runtime.is_daemon_running() and time.time() < deadline:
        time.sleep(0.05)
    assert not runtime.is_daemon_running()
    got, cold = runtime.serve_batch(_images(1), "EN")
    assert cold and len(got) == 1


def test_wsgi_app_renders_result_cards(port_daemon):
    status, _h, out = _wsgi_call(port_app.app)
    assert status == "200 OK" and b"Inactive" in out
    files = []
    for i, im in enumerate(_images(3)):
        buf = io.BytesIO()
        im.save(buf, format="JPEG")
        files.append(("files[]", f"{i}.jpg", buf.getvalue()))
    files.append(("files[]", "broken.jpg", b"not a jpeg"))
    body, ctype = _multipart({"lang": "EN", "urls": ""}, files)
    status, _h, out = _wsgi_call(port_app.app, "POST", "/", body, ctype)
    assert status == "200 OK"
    html = out.decode()
    assert html.count('<div class="card">') == 3
    assert "Classification complete for 3 image(s)!" in html
    assert "Error reading broken.jpg" in html
    assert "Model daemon: CPU" in html
    labels = {"Hakurei Reimu", "Kirisame Marisa", "Izayoi Sakuya"}
    assert any(label in html for label in labels)
