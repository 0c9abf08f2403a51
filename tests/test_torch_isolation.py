"""The PyTorch port stands apart from JAX and from the JAX package.

Importing every module of the port, running a CPU predict and CPU train
steps (the default model, ``attention_impl='flash'`` with
``patch_embed_impl='pallas'``, and a ResNet), an extract and load of bare
params and the augmentation grids must leave ``jax``, ``flax``
and every module of ``touhouimageclassification_tpu`` unimported: the port keeps its own
copies of the numpy modules it needs. The port's sources hold no import of
either, no library attention, no ``torch.compile``, and no ``try`` or
environment switch near a kernel launch or a device choice (a launch that
fails must raise, not fall back).
"""
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "touhouimageclassification_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py"))

_CHILD = r"""
import importlib, pkgutil, sys
import numpy as np, torch
torch.set_num_threads(1)
import touhouimageclassification_tpu_torch as port
mods = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in mods:
    importlib.import_module(name)
from touhouimageclassification_tpu_torch.config import (
    PRESETS, OptimizerConfig, TrainConfig, ViTConfig)
from touhouimageclassification_tpu_torch.infer.serve import Predictor
from touhouimageclassification_tpu_torch.models.vit import ViT
cfg = ViTConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                num_heads=4, mlp_dim=128, num_classes=3)
p = Predictor(model=ViT(cfg, compute_dtype="float32", device="cpu"),
              class_to_idx={"a": 0, "b": 1, "c": 2}, image_size=(32, 32),
              mean=np.full(3, 0.5), std=np.full(3, 0.25),
              device=torch.device("cpu"))
pred, conf = p.predict_array(np.zeros((2, 48, 48, 3), np.uint8))
assert pred.shape == (2,) and np.isfinite(conf).all()
import dataclasses
from touhouimageclassification_tpu_torch.train.trainer import Trainer
batch = {"image": np.full((4, 36, 36, 3), 128, np.uint8),
         "label": np.arange(4, dtype=np.int32) % 3, "mask": np.ones(4, bool)}
knobs = dataclasses.replace(cfg, attention_impl="flash",
                            patch_embed_impl="pallas")
for model_cfg, train_cfg in (
        (cfg, TrainConfig(optimizer=OptimizerConfig(learning_rate=1e-3))),
        (knobs, dataclasses.replace(PRESETS["nvit"], global_batch_size=4))):
    t = Trainer(train_cfg, model=ViT(model_cfg, compute_dtype="float32",
                                     device="cpu", param_dtype="float32"),
                device="cpu")
    state = t.init_state()
    m = t.train_step(state, t.stage(batch))
    assert np.isfinite(m["loss"]) and state.step == 1
from touhouimageclassification_tpu_torch.models import create_model
rn = create_model("resnet18", num_classes=3, compute_dtype="float32",
                  param_dtype="float32", device="cpu")
p = Predictor(model=rn, class_to_idx={"a": 0, "b": 1, "c": 2},
              image_size=(32, 32), mean=np.full(3, 0.5),
              std=np.full(3, 0.25), device=torch.device("cpu"))
pred, conf = p.predict_array(np.zeros((2, 48, 48, 3), np.uint8))
assert pred.shape == (2,) and np.isfinite(conf).all()
t = Trainer(dataclasses.replace(PRESETS["resnet152"], global_batch_size=4),
            model=rn.train(), device="cpu")
state = t.init_state()
m = t.train_step(state, t.stage(batch))
assert np.isfinite(m["loss"]) and state.step == 1
import os, tempfile
from PIL import Image
from touhouimageclassification_tpu_torch.analysis import aug
from touhouimageclassification_tpu_torch.infer.serve import load_weights
from touhouimageclassification_tpu_torch.train.checkpoint import save_params
from touhouimageclassification_tpu_torch.utils.extract_ckpt import extract
with tempfile.TemporaryDirectory() as tmp:
    save_params(os.path.join(tmp, "params.safetensors"), rn.state_dict())
    out = extract(tmp, os.path.join(tmp, "out"))
    assert load_weights(out).keys() == rn.state_dict().keys()
    Image.fromarray(np.zeros((20, 20, 3), np.uint8)).save(
        os.path.join(tmp, "x.png"))
    assert len(aug.visualize(os.path.join(tmp, "x.png"),
                             os.path.join(tmp, "grids"), out_size=(16, 16),
                             device="cpu")) == 4
loaded = sorted(m for m in sys.modules if m in ("jax", "flax")
                or m.split(".")[0] == "touhouimageclassification_tpu")
print(len(mods), loaded)
"""


def test_port_never_imports_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_mods, loaded = out.stdout.split(maxsplit=1)
    assert int(n_mods) >= 10
    assert loaded.strip() == "[]"


@pytest.mark.parametrize("pattern", [
    r"^\s*(import|from)\s+(jax|flax)\b",
    r"^\s*(import|from)\s+touhouimageclassification_tpu(\.|\s|$)",
    r"scaled_dot_product_attention",
    r"torch\.compile",
])
def test_port_sources_avoid(pattern):
    hits = [f"{p.relative_to(ROOT)}:{i}" for p in SOURCES
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if re.search(pattern, line)]
    assert not hits, hits


def test_chip_smoke_imports_only_the_port():
    """The GPU smoke run reaches the configs and the loader through the port:
    it imports neither JAX nor the JAX package."""
    src = (ROOT / "chip_smoke.py").read_text()
    hits = re.findall(
        r"^\s*(?:import|from)\s+(jax|flax|touhouimageclassification_tpu)\b",
        src, re.M)
    assert not hits, hits


NO_FALLBACK = ("ops/attention.py", "ops/patch_embed.py", "ops/_build.py",
               "device.py", "train/trainer.py", "train/optim.py",
               "train/losses.py", "ops/augment.py", "ops/mixup.py",
               "models/resnet.py", "web/runtime.py", "ops/moe_dispatch.py",
               "models/resmoe.py", "models/treevit.py", "train/tasks.py",
               "parallel/dist.py", "parallel/mesh.py",
               "parallel/collectives.py", "analysis/aug.py",
               "utils/extract_ckpt.py", "infer/serve.py",
               "ops/batchnorm.py", "ops/adamw.py", "ops/layernorm.py")


def test_kernel_wrapper_has_no_fallback():
    """The kernel wrappers (K1-K5, U1, N1), the build, the device choice,
    the train modules that place tensors, the ResNet and its BatchNorm
    variants, the mixtures' dispatch, models
    and tasks, the web daemon, and the multi-process start-up, grid and
    collectives, the augmentation grids, the extractor and serve's loading
    route (from ``get_model`` to the export's loader; the judge's canvas
    cache, which may find no folder, is not on it): no try/except to fall
    back with and no environment switch near a device. (The build reads
    CUDA_HOME to find nvcc; the web daemon reads the TIC_WEB_* names of its
    model, weights and dataset, never its device; the start-up reads only
    its launch variables, ``LAUNCH_VARS``, on a line that names no
    device.)"""
    for module in NO_FALLBACK:
        src = (PORT / module).read_text()
        environ = [line for line in src.splitlines() if "environ" in line]
        if module == "web/runtime.py":
            assert all("TIC_WEB_" in line and "DEVICE" not in line
                       for line in environ), environ
            src = src[src.index("def _worker_loop"):]
            src = src[:src.index("daemon = ModelDaemon()")]
            # the worker hands a failed batch's error to its waiters
            assert src.count("except Exception as e:") == 1
            src = src.replace("try:", "").replace(
                "except Exception as e:", "")
        elif module == "infer/serve.py":
            src = src[src.index("def get_model"):]
            src = src[:src.index("def _judge_canvas_cache")]
            assert not environ, environ
        elif module == "parallel/dist.py":
            assert environ and all("LAUNCH_VARS" in line
                                   and "device" not in line
                                   for line in environ), environ
        elif module == "train/trainer.py":
            # a step whose CUDA graph cannot be captured trains eagerly, on
            # the same device and kernels, counted and logged: one except,
            # in _capture, and nothing else
            assert not environ, environ
            capture = src[src.index("    def _capture("):
                          src.index("    def _replay(")]
            assert src.count("try:") == src.count("except") == 1
            assert capture.count("except RuntimeError as exc:") == 1
            assert "self.graph_fallbacks += 1" in capture
            src = src.replace("try:", "").replace(
                "except RuntimeError as exc:", "")
        else:
            assert all("CUDA_HOME" in line for line in environ), (module,
                                                                   environ)
        assert "try:" not in src and "except" not in src, module
