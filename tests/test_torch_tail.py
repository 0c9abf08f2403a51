"""The port's last modules against the JAX package's, on the CPU.

- ``utils/convert.py``'s CLI (``main`` -> ``convert_and_save``) on a tiny
  reference ``.pth`` of each family (ViT, ResNet-18, ResMoE and TreeViT of
  three members), served meta-less through ``infer.serve.init``, against
  JAX's ``convert_and_save`` served by JAX's ``init``: the class map, the
  mean and std equal, the logits of a judge batch within 1e-5
  (``test_torch_serve.py``'s bound: f32 summation order; for the ResNet
  1e-5 of the largest |logit|, ``test_torch_resnet.py``'s bound, as its
  logits reach ~60 through 512-channel sums). The port infers
  the mixtures' member count from the tensor names; the JAX factory is
  given it, as JAX's ``init`` cannot read it from an Orbax directory;
- ``utils/extract_ckpt.py``: a port training checkpoint (AdamW state and an
  open accumulation window, so ``opt/*`` and ``acc/*`` are in the save)
  gives the model's tensors exactly; a two-shard expert save (the files
  ``CheckpointManager`` writes under expert parallelism, split by the same
  owner rule) gives every member, and serves strictly: without a shard or
  a key it raises; a bare params directory passes through; a ``.pth``
  without ``--model`` raises ``SystemExit``;
- ``infer.serve.init`` on the extracted params directory and on the
  training checkpoint itself against JAX's ``init`` on JAX's extract output
  and on JAX's Orbax training checkpoint of the same parameters (the port's
  steps run at learning rate 0, so AdamW's and the window's state exist and
  the parameters stay JAX's); an empty directory still raises;
- ``analysis/aug.py``: the ``original`` grid bit for bit, and each recipe's
  tiles (floats, before the uint8 rounding) within 1e-5 of JAX's recipe run
  on the port's draws (``augment_replay.ReplayAugment``); CUDA without a GPU
  raises;
- ``models/treevit.py::make_tree_vit`` builds the config JAX's builds.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from augment_replay import ReplayAugment
from chip_smoke import hf_vit_state_dict
from fixtures import make_image_folder
from test_torch_copies import port_config
from test_torch_moe import _reference_sd
from test_torch_resnet import torchvision_resnet18_sd
from touhouimageclassification_tpu import models as jmodels
from touhouimageclassification_tpu.analysis import aug as jaug_vis
from touhouimageclassification_tpu.config import (MoEConfig, ResNetConfig,
                                                  TreeViTConfig, ViTConfig)
from touhouimageclassification_tpu.infer import serve as jserve
from touhouimageclassification_tpu.models.resmoe import MoEClassifier as JaxMoE
from touhouimageclassification_tpu.models.resnet import ResNet as JaxResNet
from touhouimageclassification_tpu.models.treevit import TreeViT as JaxTree
from touhouimageclassification_tpu.models.treevit import \
    make_tree_vit as jax_make_tree_vit
from touhouimageclassification_tpu.models.vit import ViT as JaxViT
from touhouimageclassification_tpu.ops import augment as jaug
from touhouimageclassification_tpu.train import checkpoint as jckpt
from touhouimageclassification_tpu.utils import convert as jconvert
from touhouimageclassification_tpu.utils import extract_ckpt as jextract
from touhouimageclassification_tpu_torch import config as pcfg
from touhouimageclassification_tpu_torch import models as pmodels
from touhouimageclassification_tpu_torch.analysis import aug
from touhouimageclassification_tpu_torch.infer import serve
from touhouimageclassification_tpu_torch.models import MoEClassifier, treevit
from touhouimageclassification_tpu_torch.models.treevit import make_tree_vit
from touhouimageclassification_tpu_torch.models.vit import ViT
from touhouimageclassification_tpu_torch.ops import augment as paug
from touhouimageclassification_tpu_torch.parallel import sharding
from touhouimageclassification_tpu_torch.train import checkpoint as ck
from touhouimageclassification_tpu_torch.train.tasks import MoETask
from touhouimageclassification_tpu_torch.train.trainer import Trainer
from touhouimageclassification_tpu_torch.utils import convert, extract_ckpt
from touhouimageclassification_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)

N_CLASSES = 3
LOGIT_ATOL = 1e-5
TINY = ViTConfig(image_size=16, patch_size=8, hidden_size=16, num_layers=1,
                 num_heads=2, mlp_dim=32, num_classes=N_CLASSES)
RESNET = ResNetConfig(depth=18, num_classes=N_CLASSES, image_size=32)
MEMBERS = 3
# serve's --model flag and the model type handed to convert, by family
FAMILIES = {"vit": ("vit-base", "vit-base"), "resnet": ("resnet", "resnet"),
            "resmoe": ("resmoe", "resmoe"), "treevit": ("treevit", "treevit")}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("tail_data")
    return make_image_folder(str(root), num_classes=N_CLASSES, per_class=2,
                             size=20)


def _reference_pth(family, path):
    if family == "vit":
        sd = hf_vit_state_dict(16, 1, 32, N_CLASSES, image_size=16, patch=8)
    elif family == "resnet":
        sd = {"model": torchvision_resnet18_sd(N_CLASSES)}
    else:
        sd = _reference_sd(family, MEMBERS, N_CLASSES)
    torch.save(sd, path)
    return str(path)


def _tiny_factories(family, monkeypatch):
    """Pin both packages' model factories to the tiny f32 model of
    ``family``: the port's ``create_model`` (convert's and serve's), and
    JAX's (convert's, and serve's with its image size)."""
    real = pmodels.create_model
    port_over = {"vit": dict(image_size=16, patch_size=8, hidden_size=16,
                             num_layers=1, num_heads=2, mlp_dim=32),
                 "resnet": dict(image_size=32),
                 "resmoe": dict(expert_vit=port_config(TINY)),
                 "treevit": dict(vit=port_config(TINY))}[family]
    port_type = {"resnet": "resnet18"}.get(family, FAMILIES[family][1])

    def port_factory(model_type, num_classes, **kw):
        return real(port_type, num_classes=num_classes,
                    compute_dtype="float32", **port_over, **kw)

    def jax_factory(model_type, num_classes, **over):
        if family == "vit":
            return JaxViT(dataclasses.replace(TINY, num_classes=num_classes),
                          compute_dtype="float32")
        if family == "resnet":
            return JaxResNet(dataclasses.replace(RESNET,
                                                 num_classes=num_classes),
                             compute_dtype="float32")
        if family == "resmoe":
            return JaxMoE(MoEConfig(**{"num_experts": MEMBERS, **over},
                                    num_classes=num_classes, expert_vit=TINY),
                          compute_dtype="float32")
        return JaxTree(TreeViTConfig(**{"num_categories": MEMBERS, **over},
                                     num_classes=num_classes, vit=TINY),
                       compute_dtype="float32")

    size = RESNET.image_size if family == "resnet" else TINY.image_size
    monkeypatch.setattr(pmodels, "create_model", port_factory)
    monkeypatch.setattr(serve, "create_model", port_factory)
    monkeypatch.setattr(jmodels, "create_model", jax_factory)
    monkeypatch.setattr(jserve, "create_model", jax_factory)
    monkeypatch.setattr(jserve, "get_image_size", lambda mt: (size, size))


def _judge_images(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (4, 20, 20, 3),
                                                dtype=np.uint8)


def _port_logits(predictor, imgs):
    with torch.no_grad():
        return predictor._logits(predictor.model,
                                 torch.from_numpy(imgs)).float().numpy()


def _jax_logits(predictor, imgs):
    """JAX's Predictor's forward up to the softmax (its ``_predict``)."""
    x = jnp.asarray(imgs, jnp.float32) / 255.0
    if x.shape[1:3] != tuple(predictor.image_size):
        x = jaug.resize(x, predictor.image_size)
    x = jaug.normalize(x, tuple(np.asarray(predictor.mean).reshape(-1)),
                       tuple(np.asarray(predictor.std).reshape(-1)))
    out, _ = jmodels.apply_model(
        predictor.model, {"params": predictor.params,
                          **predictor.model_state}, x, train=False)
    return np.asarray(out[0] if isinstance(out, tuple) else out)


def _assert_serves_as_jax(port, ref, relative=False):
    """The same class map, image size, mean and std, and logits within
    LOGIT_ATOL (of the largest |logit| when ``relative``)."""
    assert port.class_to_idx == ref.class_to_idx
    assert tuple(port.image_size) == tuple(ref.image_size)
    np.testing.assert_array_equal(np.asarray(port.mean), np.asarray(ref.mean))
    np.testing.assert_array_equal(np.asarray(port.std), np.asarray(ref.std))
    imgs = _judge_images()
    want = _jax_logits(ref, imgs)
    scale = np.abs(want).max() if relative else 1.0
    np.testing.assert_allclose(_port_logits(port, imgs), want,
                               atol=LOGIT_ATOL * scale, rtol=0)


# ---------------------------------------------------------------------------
# the convert CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_convert_cli_serves_as_jax(family, dataset, tmp_path, monkeypatch,
                                   capsys):
    flag, model_type = FAMILIES[family]
    _tiny_factories(family, monkeypatch)
    pth = _reference_pth(family, tmp_path / f"{family}.pth")
    out = tmp_path / "port"
    convert.main(["--input", pth, "--model", model_type, "--num-classes",
                  str(N_CLASSES), "--output", str(out)])
    assert f"Saved converted params to {out}" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == [ck.SERVING_PARAMS]
    port = serve.init(modelt=flag, weights=str(out), data_dir=dataset,
                      device="cpu")
    jout = jconvert.convert_and_save(pth, model_type, N_CLASSES,
                                     str(tmp_path / "jax"))
    ref = jserve.init(modelt=flag, weights=jout, data_dir=dataset)
    if family in ("resmoe", "treevit"):
        members = port.model.experts if family == "resmoe" else port.model.sons
        assert len(members) == MEMBERS
    _assert_serves_as_jax(port, ref, relative=family == "resnet")
    # the .pth served directly holds the same weights
    direct = serve.init(modelt=flag, weights=pth, data_dir=dataset,
                        device="cpu")
    for k, v in direct.model.state_dict().items():
        assert torch.equal(v, port.model.state_dict()[k]), k


# ---------------------------------------------------------------------------
# extract_ckpt and the meta-less serve route
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    model = JaxViT(TINY, compute_dtype="float32")
    return jax.device_get(model.init(
        jax.random.key(0), np.zeros((1, 16, 16, 3), np.float32))["params"])


def _train_cfg(tmp, lr, model_type="vit-base"):
    return pcfg.TrainConfig(
        train_id="tail", model_type=model_type, global_batch_size=4, seed=0,
        optimizer=pcfg.OptimizerConfig(name="adamw", learning_rate=lr,
                                       weight_decay=0.01, grad_accum_steps=2),
        augment=pcfg.AugmentConfig(enable_augmentation=False),
        mix=pcfg.MixConfig(enable_mixup=False),
        checkpoint=pcfg.CheckpointConfig(directory=str(tmp / "c"),
                                         async_save=False),
        log_dir=str(tmp / "l"))


def _steps(trainer, n=3):
    """``n`` steps: with 2-step accumulation the window is open after 3."""
    state = trainer.init_state()
    rng = np.random.default_rng(1)
    for _ in range(n):
        trainer.train_step(state, trainer.stage({
            "image": rng.integers(0, 256, (4, 16, 16, 3)).astype(np.uint8),
            "label": rng.integers(0, N_CLASSES, 4).astype(np.int32),
            "mask": np.ones(4, bool)}))
    return state


def _port_checkpoint(tmp, params, lr):
    """A port training checkpoint of the tiny ViT started from JAX's
    ``params``: 3 AdamW steps at ``lr``, accumulated over 2. Returns the
    epoch directory and the state."""
    cfg = _train_cfg(tmp, lr)
    trainer = Trainer(cfg, model=ViT(port_config(TINY), "float32", "cpu",
                                     param_dtype="float32"), device="cpu",
                      init_params=from_jax_params(params, port_config(TINY)))
    state = _steps(trainer)
    mgr = ck.CheckpointManager(cfg.checkpoint, cfg.train_id)
    assert mgr.save(1, state, {"val_acc": 0.5})
    saved = ck.read_state_files(os.path.join(mgr.directory, "1"))
    assert any(k.startswith("opt/") for k in saved)
    assert any(k.startswith("acc/") for k in saved)
    return os.path.join(mgr.directory, "1"), state


def test_extract_training_checkpoint_keeps_the_model_tensors(jax_params,
                                                             tmp_path):
    ckpt_dir, state = _port_checkpoint(tmp_path, jax_params, lr=1e-2)
    out = extract_ckpt.extract(ckpt_dir, str(tmp_path / "out"))
    assert sorted(os.listdir(out)) == [ck.SERVING_PARAMS]
    got = ck.load_params(os.path.join(out, ck.SERVING_PARAMS))
    want = state.model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    start = from_jax_params(jax_params, port_config(TINY))
    assert not all(torch.equal(got[k], start[k]) for k in start), \
        "the steps moved the parameters"


def test_extract_passes_bare_params_through(tmp_path, capsys):
    """Into another directory and onto itself (the file it reads from is
    replaced, never overwritten in place)."""
    params = ViT(port_config(TINY), "float32", "cpu", seed=3).state_dict()
    src = tmp_path / "bare"
    src.mkdir()
    ck.save_params(str(src / ck.SERVING_PARAMS), params)
    for out in (tmp_path / "out", src):
        extract_ckpt.main(["--input", str(src), "--output", str(out)])
        assert capsys.readouterr().out == f"Extracted to {out}\n"
        got = ck.load_params(str(out / ck.SERVING_PARAMS))
        assert got.keys() == params.keys()
        assert all(torch.equal(got[k], params[k]) for k in params)


@pytest.mark.parametrize("module", [extract_ckpt, jextract])
def test_extract_pth_requires_model_type(module, tmp_path):
    pth = tmp_path / "weights.pth"
    pth.write_bytes(b"not really torch")
    with pytest.raises(SystemExit, match="--model is required"):
        module.extract(str(pth), str(tmp_path / "out"))


def test_extract_pth_converts(dataset, tmp_path, monkeypatch):
    """``extract --model`` on a .pth is ``convert``: the same file."""
    _tiny_factories("vit", monkeypatch)
    pth = _reference_pth("vit", tmp_path / "vit.pth")
    a = extract_ckpt.extract(pth, str(tmp_path / "a"), "vit-base", N_CLASSES)
    b = convert.convert_and_save(pth, "vit-base", N_CLASSES,
                                 str(tmp_path / "b"))
    ta, tb = (ck.load_params(os.path.join(d, ck.SERVING_PARAMS))
              for d in (a, b))
    assert ta.keys() == tb.keys()
    assert all(torch.equal(ta[k], tb[k]) for k in ta)


@pytest.mark.parametrize("kind", ["params", "checkpoint"])
def test_metaless_serve_matches_jax(kind, jax_params, dataset, tmp_path,
                                    monkeypatch):
    """The port's training checkpoint (and its extract) against JAX's Orbax
    training checkpoint of the same parameters (and its extract)."""
    _tiny_factories("vit", monkeypatch)
    ckpt_dir, state = _port_checkpoint(tmp_path, jax_params, lr=0.0)
    start = from_jax_params(jax_params, port_config(TINY))
    assert all(torch.equal(v, start[k])
               for k, v in state.model.state_dict().items())
    jax_ckpt = str(tmp_path / "jax_ckpt")
    jckpt.save_params(jax_ckpt, {
        "params": jax_params,
        "opt_state": jax.tree_util.tree_map(np.zeros_like, jax_params),
        "step": np.asarray(3)})
    if kind == "params":
        weights = extract_ckpt.extract(ckpt_dir, str(tmp_path / "port_out"))
        jweights = jextract.extract(jax_ckpt, str(tmp_path / "jax_out"))
    else:
        weights, jweights = ckpt_dir, jax_ckpt
    assert ck.weights_kind(weights) == kind
    port = serve.init(modelt="vit-base", weights=weights, data_dir=dataset,
                      device="cpu")
    ref = jserve.init(modelt="vit-base", weights=jweights, data_dir=dataset)
    _assert_serves_as_jax(port, ref)
    loaded = serve.load_weights(weights)
    assert loaded.keys() == start.keys()
    assert all(torch.equal(loaded[k], start[k]) for k in start)


def test_load_weights_converts_a_pth_for_the_model(tmp_path):
    pth = _reference_pth("vit", tmp_path / "vit.pth")
    model = ViT(port_config(dataclasses.replace(TINY, num_classes=5)),
                "float32", "cpu")
    got = serve.load_weights(pth, model)
    assert got["head.weight"].shape == (5, 16)
    assert serve.load_weights(pth, model, N_CLASSES)["head.weight"].shape \
        == (N_CLASSES, 16)
    with pytest.raises(ValueError, match="pass model="):
        serve.load_weights(pth)


def test_get_model_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.get_model("vit-base", N_CLASSES, device="cuda")


MOE = pcfg.MoEConfig(num_experts=4, top_k=2, num_classes=N_CLASSES,
                     expert_vit=port_config(TINY))


@pytest.fixture
def sharded_save(tmp_path):
    """One step of a 4-expert tiny ResMoE, saved as two expert shards: the
    files (``state.safetensors`` with the gate and experts 0-1,
    ``state.expert1.safetensors`` with experts 2-3, each with its members'
    AdamW state) and the ``meta.json`` that ``CheckpointManager`` writes
    under a 2-shard expert mesh, split by its owner rule."""
    model = MoEClassifier(MOE, "float32", "cpu", param_dtype="float32",
                          seed=2)
    trainer = Trainer(_train_cfg(tmp_path, 1e-2, "resmoe"), model=model,
                      task=MoETask(MOE), device="cpu")
    state = _steps(trainer, n=2)
    sizes = sharding.stack_sizes(model)
    epoch = tmp_path / "ep" / "1"
    epoch.mkdir(parents=True)
    for e in range(2):
        def keep(name, e=e):
            owner = sharding.owner(name, sizes, 2)
            return owner == e or (owner is None and e == 0)

        tensors, meta = ck.state_tensors(state, keep)
        ck.save_safetensors(tensors, str(epoch / ck.shard_file(e)))
        if e == 0:
            (epoch / ck.META_FILE).write_text(json.dumps(meta))
    assert sorted(os.listdir(epoch)) == [
        "meta.json", "state.expert1.safetensors", "state.safetensors"]
    return str(epoch), {k: v.clone() for k, v in model.state_dict().items()}


def _moe_factory(monkeypatch):
    real = pmodels.create_model

    def tiny(model_type, num_classes, **kw):
        return real(model_type, num_classes=num_classes,
                    compute_dtype="float32", expert_vit=MOE.expert_vit, **kw)

    monkeypatch.setattr(serve, "create_model", tiny)


def test_extract_gathers_every_expert_shard(sharded_save, dataset, tmp_path,
                                            monkeypatch):
    epoch, want = sharded_save
    out = extract_ckpt.extract(epoch, str(tmp_path / "out"))
    got = ck.load_params(os.path.join(out, ck.SERVING_PARAMS))
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    _moe_factory(monkeypatch)
    imgs = _judge_images(1)
    logits = []
    for weights in (epoch, out):
        predictor = serve.init(modelt="resmoe", weights=weights,
                               data_dir=dataset, device="cpu")
        assert len(predictor.model.experts) == MOE.num_experts
        logits.append(_port_logits(predictor, imgs))
    model = MoEClassifier(MOE, "float32", "cpu")
    model.load_state_dict(want)
    ref = serve.Predictor(model=model, class_to_idx=predictor.class_to_idx,
                          image_size=predictor.image_size,
                          mean=predictor.mean, std=predictor.std,
                          device=torch.device("cpu"))
    np.testing.assert_array_equal(logits[0], _port_logits(ref, imgs))
    np.testing.assert_array_equal(logits[1], logits[0])


def test_a_missing_shard_or_key_raises(sharded_save, dataset, monkeypatch):
    epoch, _ = sharded_save
    _moe_factory(monkeypatch)
    shard = os.path.join(epoch, "state.expert1.safetensors")
    tensors = {k: v.clone() for k, v in ck.load_params(shard).items()
               if not k.startswith("experts.3.layer.0.mlp.fc1.")}
    ck.save_safetensors(tensors, shard)
    with pytest.raises(RuntimeError, match="Missing key"):
        serve.init(modelt="resmoe", weights=epoch, data_dir=dataset,
                   device="cpu")
    os.remove(shard)
    # the gate still scores 4 experts: a 2-expert model does not load it
    with pytest.raises(RuntimeError, match="size mismatch"):
        serve.init(modelt="resmoe", weights=epoch, data_dir=dataset,
                   device="cpu")


def test_what_is_no_weights_directory_raises(dataset, tmp_path):
    for names in ([], [ck.META_FILE], [ck.SERVING_META]):
        d = tmp_path / f"d{len(names)}{''.join(names)}"
        d.mkdir()
        for name in names:
            (d / name).write_text("{}")
        with pytest.raises(FileNotFoundError, match="serving_meta.json"):
            serve.init(modelt="vit-base", weights=str(d), data_dir=dataset,
                       device="cpu")
        with pytest.raises(FileNotFoundError, match="state\\*.safetensors"):
            extract_ckpt.extract(str(d), str(tmp_path / "out"))


# ---------------------------------------------------------------------------
# analysis/aug.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def image(tmp_path_factory):
    path = tmp_path_factory.mktemp("aug") / "x.jpg"
    Image.fromarray(np.random.default_rng(0).integers(
        0, 256, (64, 48, 3)).astype(np.uint8)).save(path)
    return str(path)


def test_aug_grids_and_original_equal_jax(image, tmp_path):
    port = aug.visualize(image, str(tmp_path / "port"), out_size=(32, 32),
                         device="cpu")
    ref = jaug_vis.visualize(image, str(tmp_path / "jax"), out_size=(32, 32))
    assert [os.path.basename(p) for p in port] == \
        [os.path.basename(p) for p in ref]
    assert [(n, r) for n, _, r in aug.AUGS] == \
        [(n, r) for n, _, r in jaug_vis.AUGS]
    for (_, cfg, _), (_, jcfg, _) in zip(aug.AUGS, jaug_vis.AUGS):
        assert cfg == (None if jcfg is None else port_config(jcfg))
    for p, r, (_, _, repeats) in zip(port, ref, aug.AUGS):
        with Image.open(p) as a, Image.open(r) as b:
            assert a.size == b.size
            if p.endswith("original.png"):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    cols = int(np.ceil(np.sqrt(16)))
    with Image.open(port[-1]) as full:
        assert full.size == (cols * 32, cols * 32)


@pytest.mark.parametrize("recipe", ["grey", "colorjitter", "full"])
def test_aug_tiles_equal_jax_on_the_same_draws(recipe, image, monkeypatch):
    """Each tile of the port (``augment_tiles``, seed ``seed + i``) against
    JAX's recipe run on the draws the port made for that tile."""
    name, cfg, repeats = next(a for a in aug.AUGS if a[0] == recipe)
    jcfg = next(c for n, c, _ in jaug_vis.AUGS if n == recipe)
    base = aug.load_base(image)
    rand = paug._rand
    for i in range(repeats):
        draws = []

        def logged_rand(*args):
            draws.append(rand(*args))
            return draws[-1]

        with monkeypatch.context() as mp:
            mp.setattr(paug, "_rand", logged_rand)
            got = aug.augment_tiles(base, cfg, 1, (32, 32), 7 + i,
                                    torch.device("cpu"))
        replay = ReplayAugment(draws)
        with monkeypatch.context() as mp:
            mp.setattr(jaug, "jax", replay)
            out = np.asarray(jaug.build_augment_fn(jcfg, (32, 32))(
                None, jnp.asarray(base[None])))
        assert replay.done(), "JAX drew fewer numbers than the port"
        want = np.clip(out * np.asarray(jcfg.std) + np.asarray(jcfg.mean),
                       0, 1)
        assert got.shape == want.shape == (1, 32, 32, 3)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                   err_msg=f"{recipe} tile {i}")


def test_aug_never_falls_back_to_cpu(image, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        aug.visualize(image, str(tmp_path / "g"))
    assert not os.path.exists(tmp_path / "g")


# ---------------------------------------------------------------------------
# make_tree_vit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("categories,top", [(2, 1), (3, 2)])
def test_make_tree_vit_builds_what_jax_builds(categories, top, monkeypatch):
    """The same config (members ViT-B, ``vit=None``); the members are built
    at the tiny width here to keep the test short."""
    ref = jax_make_tree_vit(categories, 7, top_k=top)
    monkeypatch.setattr(treevit, "VIT_BASE", port_config(TINY))
    model = make_tree_vit(categories, 7, top_k=top, device="cpu")
    assert model.cfg == port_config(ref.cfg)
    assert len(model.sons) == categories
    assert model.root.cfg.num_classes == categories
    assert all(son.cfg.num_classes == 7 for son in model.sons)
