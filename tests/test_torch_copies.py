"""The port's copies of the JAX package's numpy modules give what the
originals give.

The port imports nothing of the JAX package: it keeps its own ``config.py``,
``data/{folder,loader,native_loader,canvas_cache}.py``,
``utils/mean_std.py``, ``utils/logging.py``, ``utils/httpkit.py``,
``utils/check_sha.py``, ``utils/sample_dataset.py`` and the HF and
torchvision checkpoint converters of ``utils/convert.py``. Here both sides
run on the same inputs and must agree exactly: every preset and model
config field for field, the ImageFolder scan, the seeded split, the
loader's batches, the dataset statistics, the converted parameter tree, the
run logger, the duplicate check, the sampled files and reference images,
and what each of the two small CLIs prints.

:func:`port_config` is the one bridge the other ``test_torch_*`` files use to
hand a JAX-package config to the port: the port's dataclass of the same name,
built from the same fields.
"""
import dataclasses
import os
import runpy
import shutil
import sys

import numpy as np
import pytest
import torch

import touhouimageclassification_tpu.config as jcfg
import touhouimageclassification_tpu_torch.config as pcfg
from chip_smoke import hf_vit_state_dict
from fixtures import make_image_folder
from touhouimageclassification_tpu.data import canvas_cache as jcache
from touhouimageclassification_tpu.data import folder as jfolder
from touhouimageclassification_tpu.data import loader as jloader
from touhouimageclassification_tpu.utils import check_sha as jsha
from touhouimageclassification_tpu.utils import convert as jconvert
from touhouimageclassification_tpu.utils import httpkit as jhttpkit
from touhouimageclassification_tpu.utils import logging as jlogging
from touhouimageclassification_tpu.utils import mean_std as jstats
from touhouimageclassification_tpu.utils import sample_dataset as jsample
from touhouimageclassification_tpu_torch.data import canvas_cache as pcache
from touhouimageclassification_tpu_torch.data import folder as pfolder
from touhouimageclassification_tpu_torch.data import image_loader
from touhouimageclassification_tpu_torch.data import loader as ploader
from touhouimageclassification_tpu_torch.utils import check_sha as psha
from touhouimageclassification_tpu_torch.utils import convert as pconvert
from touhouimageclassification_tpu_torch.utils import httpkit as phttpkit
from touhouimageclassification_tpu_torch.utils import logging as plogging
from touhouimageclassification_tpu_torch.utils import mean_std as pstats
from touhouimageclassification_tpu_torch.utils import sample_dataset as psample

torch.set_num_threads(1)


def port_config(cfg):
    """A JAX-package config dataclass -> the port's dataclass of the same
    name with the same field values (nested configs converted too)."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return getattr(pcfg, type(cfg).__name__)(**{
        k: port_config(v) if dataclasses.is_dataclass(v) else v
        for k, v in fields.items()})


def _dataclasses(module):
    return sorted(name for name, obj in vars(module).items()
                  if isinstance(obj, type) and dataclasses.is_dataclass(obj))


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_same_presets_and_dataclasses():
    assert set(pcfg.PRESETS) == set(jcfg.PRESETS)
    assert _dataclasses(pcfg) == _dataclasses(jcfg)


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_preset_equals_jax(name):
    port, ref = pcfg.PRESETS[name], jcfg.PRESETS[name]
    assert type(port).__module__ == pcfg.__name__
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("name", ["ViTConfig", "VIT_BASE", "VIT_LARGE"])
def test_vit_config_equals_jax(name):
    port, ref = getattr(pcfg, name), getattr(jcfg, name)
    if name == "ViTConfig":
        port, ref = port(), ref()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.num_patches, port.seq_len) == (ref.num_patches, ref.seq_len)


@pytest.mark.parametrize("name", _dataclasses(jcfg))
def test_config_defaults_and_bridge_equal_jax(name):
    """Default instances agree field for field, and port_config carries a
    JAX instance over unchanged."""
    ref = getattr(jcfg, name)()
    port = port_config(ref)
    assert type(port) is getattr(pcfg, name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(getattr(pcfg, name)()) == dataclasses.asdict(ref)


def test_constants_and_lookups_equal_jax():
    names = [k for k, v in vars(jcfg).items()
             if k.isupper() and isinstance(v, (int, str, tuple))]
    assert {k: getattr(pcfg, k) for k in names} == {
        k: getattr(jcfg, k) for k in names}
    for model in ("vit-large", "resnet152", "vit-moe", "tree-vit"):
        assert pcfg.get_image_size(model) == jcfg.get_image_size(model)
    for name in ("vit-base", "vit-large", "google/vit-base-patch16-224"):
        assert dataclasses.asdict(pcfg.vit_config(name, num_classes=7)) == \
            dataclasses.asdict(jcfg.vit_config(name, num_classes=7))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_image_folder(str(tmp_path_factory.mktemp("copies_data")),
                             num_classes=3, per_class=7, size=40)


def test_scan_image_folder_equals_jax(dataset):
    port = pfolder.scan_image_folder(dataset, persist_class_map=False)
    ref = jfolder.scan_image_folder(dataset, persist_class_map=False)
    assert (port.root, port.classes, port.class_to_idx, port.paths) == (
        ref.root, ref.classes, ref.class_to_idx, ref.paths)
    np.testing.assert_array_equal(port.labels, ref.labels)
    assert port.labels.dtype == ref.labels.dtype
    assert pfolder.get_class_to_idx(dataset) == jfolder.get_class_to_idx(dataset)


@pytest.mark.parametrize("n,fraction,seed", [(21, 0.8, 42), (100, 0.9, 0),
                                             (7, 0.5, 3)])
def test_random_split_equals_jax(n, fraction, seed):
    for port, ref in zip(pfolder.random_split(n, fraction, seed),
                         jfolder.random_split(n, fraction, seed)):
        np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_loader_batches_equal_jax(dataset, kind):
    """Same index, subset, seed and canvas: the same batches, byte for byte
    (a shuffled drop-last train epoch, and a padded, masked eval tail)."""
    index = pfolder.scan_image_folder(dataset, persist_class_map=False)
    subset = np.arange(len(index))[::-1].copy()
    kw = (dict(batch_size=4, canvas=(32, 32), shuffle=True, seed=5,
               drop_last=True) if kind == "train" else
          dict(batch_size=8, canvas=(24, 24), shuffle=False, drop_last=False))
    port = list(image_loader(index, subset, **kw))
    ref = list(jloader.HostImageLoader(index, subset, **kw))
    assert len(port) == len(ref) == len(image_loader(index, subset, **kw))
    for p, r in zip(port, ref):
        assert p.keys() == r.keys()
        for key in r:
            np.testing.assert_array_equal(p[key], r[key], err_msg=key)
            assert p[key].dtype == r[key].dtype


def test_loader_takes_only_a_pinned_process_view(dataset):
    """A pinned (pid, count) view loads what the JAX loader's does and keeps
    it over a mesh-derived ``set_process_view``; the 'auto' view is the
    whole batch without a process group and takes a set view as JAX's
    does."""
    index = pfolder.scan_image_folder(dataset, persist_class_map=False)
    auto = ploader.HostImageLoader(index, batch_size=4, process_shard="auto")
    jauto = jloader.HostImageLoader(index, batch_size=4, process_shard="auto")
    assert (auto._pid, auto._pcount) == (jauto._pid, jauto._pcount) == (0, 1)
    auto.set_process_view(1, 2)
    jauto.set_process_view(1, 2)
    np.testing.assert_array_equal(next(iter(auto))["image"],
                                  next(iter(jauto))["image"])
    with pytest.raises(ValueError, match="not divisible"):
        auto.set_process_view(0, 3)
    pinned = ploader.HostImageLoader(index, batch_size=4,
                                     process_shard=(1, 2))
    pinned.set_process_view(0, 1)
    half = list(pinned)
    ref = list(jloader.HostImageLoader(index, batch_size=4,
                                       process_shard=(1, 2)))
    assert len(half) == len(ref) and half[0]["image"].shape[0] == 2
    np.testing.assert_array_equal(half[0]["image"], ref[0]["image"])


def test_mean_std_equals_jax(dataset, tmp_path):
    port = pstats.calculate_mean_std(dataset, (32, 32), cache=False)
    ref = jstats.calculate_mean_std(dataset, (32, 32), cache=False)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    copies = [shutil.copytree(dataset, tmp_path / name) for name in ("p", "j")]
    got = pstats.get_mean_std(str(copies[0]), (32, 32))
    want = jstats.get_mean_std(str(copies[1]), (32, 32))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_canvas_cache_is_shared_with_jax(tmp_path):
    """The port's cache keeps the JAX package's layout: a cache one fills,
    the other finds and reads back."""
    data = make_image_folder(str(tmp_path / "d"), num_classes=2, per_class=3,
                             size=24)
    index = pfolder.scan_image_folder(data, persist_class_map=False)
    images = np.random.default_rng(0).integers(0, 256, (6, 16, 16, 3),
                                               dtype=np.uint8)
    port = pcache.CanvasCache(index, (16, 16))
    port.store(np.arange(6), images)
    port.flush()
    assert jcache.find_existing_canvas(index) == (16, 16)
    assert pcache._fingerprint(index) == jcache._fingerprint(index)
    out = np.zeros_like(images)
    assert jcache.CanvasCache(index, (16, 16)).fetch(np.arange(6), out).all()
    np.testing.assert_array_equal(out, images)


# ---------------------------------------------------------------------------
# HF checkpoint converter
# ---------------------------------------------------------------------------

def _assert_same_tree(port, ref, path=""):
    assert port.keys() == ref.keys(), path
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_same_tree(port[k], ref[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(port[k], ref[k], err_msg=path + k)
            assert port[k].dtype == ref[k].dtype, path + k


@pytest.mark.parametrize("wrap,classes", [("", 10), ("model.", 10),
                                          ("lightning", 7)])
def test_torch_vit_to_flax_equals_jax(tmp_path, wrap, classes):
    """Bare, ``model.``-wrapped and Lightning-style (``vit.vit.*``) HF
    checkpoints, saved as tuples as the reference does, and a head of
    another class count: the same tree, leaf for leaf."""
    sd = hf_vit_state_dict(64, 2, 128, 10, image_size=32, patch=8)
    prefix = "vit." if wrap == "lightning" else wrap
    sd = {prefix + k: v for k, v in sd.items()}
    path = str(tmp_path / "ckpt.pth")
    torch.save((sd, {"optimizer": 0}), path)
    port_sd = pconvert._normalize_ckpt(path)
    ref_sd = jconvert._normalize_ckpt(path)
    assert pconvert._strip_prefixes(port_sd).keys() == \
        jconvert._strip_prefixes(ref_sd).keys()
    _assert_same_tree(pconvert.torch_vit_to_flax(port_sd, classes),
                      jconvert.torch_vit_to_flax(ref_sd, classes))


def test_run_logger_equals_jax(tmp_path):
    """utils/logging.py: the same handlers, levels and format, writing
    <log_dir>/<name>.log (one process: no per-process suffix)."""
    loggers = [module.get_logger(f"copy_{tag}", str(tmp_path / tag))
               for module, tag in ((jlogging, "jax"), (plogging, "port"))]
    shape = [[(type(h).__name__, h.level, h.formatter._fmt)
              for h in logger.handlers] for logger in loggers]
    assert shape[0] == shape[1]
    for logger, tag in zip(loggers, ("jax", "port")):
        logger.info("line")
        assert (tmp_path / tag / f"copy_{tag}.log").read_text().endswith(
            f"copy_{tag} - INFO - line\n")


@pytest.mark.parametrize("classes", [5, 9])
def test_torch_resnet_to_flax_equals_jax(tmp_path, classes):
    """A torchvision-layout ResNet-18 checkpoint (with num_batches_tracked),
    ``module.``-wrapped, its head of 5 classes kept or drawn afresh for 9:
    the same (params, batch_stats), leaf for leaf."""
    from test_torch_resnet import torchvision_resnet18_sd

    sd = {"module." + k: v for k, v in torchvision_resnet18_sd(5).items()}
    path = str(tmp_path / "resnet.pth")
    torch.save({"state_dict": sd}, path)
    port = pconvert.torch_resnet_to_flax(pconvert._normalize_ckpt(path),
                                         classes)
    ref = jconvert.torch_resnet_to_flax(jconvert._normalize_ckpt(path),
                                        classes)
    for p, r in zip(port, ref):
        _assert_same_tree(p, r)


def _source_without_docstring(module):
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(module))
    tree.body = [n for n in tree.body if not (
        isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant))]
    return ast.dump(tree)


def test_httpkit_equals_jax():
    """utils/httpkit.py: the same code (module docstring aside), and the
    same parse of a multipart body, a cookie header and a query string."""
    assert _source_without_docstring(phttpkit) == \
        _source_without_docstring(jhttpkit)
    body = (b"--b\r\nContent-Disposition: form-data; name=\"lang\"\r\n\r\nEN"
            b"\r\n--b\r\nContent-Disposition: form-data; name=\"files[]\"; "
            b"filename=\"a.jpg\"\r\nContent-Type: image/jpeg\r\n\r\nxyz\r\n"
            b"--b--\r\n")
    import io

    parsed = []
    for kit in (phttpkit, jhttpkit):
        req = kit.Request({"REQUEST_METHOD": "POST", "QUERY_STRING": "a=1",
                           "CONTENT_TYPE": "multipart/form-data; boundary=b",
                           "CONTENT_LENGTH": str(len(body)),
                           "HTTP_COOKIE": "session_uid=u1",
                           "wsgi.input": io.BytesIO(body)})
        parsed.append((req.form_value("lang"), req.files, req.cookies,
                       req.query))
    assert parsed[0] == parsed[1]
    assert parsed[0] == ("EN", [("files[]", "a.jpg", b"xyz")],
                         {"session_uid": "u1"}, {"a": ["1"]})


# ---------------------------------------------------------------------------
# the small utilities: check_sha and sample_dataset
# ---------------------------------------------------------------------------

@pytest.fixture
def sha_folders(tmp_path):
    """A train folder and a test folder holding two copies of one train
    file, one of another, and two files of their own."""
    train, test = tmp_path / "train" / "a", tmp_path / "test" / "a"
    train.mkdir(parents=True)
    (test / "b").mkdir(parents=True)
    for name, data in (("x.jpg", b"x"), ("y.jpg", b"y"), ("z.jpg", b"z")):
        (train / name).write_bytes(data)
    for name, data in (("x1.jpg", b"x"), ("b/x2.jpg", b"x"), ("y.jpg", b"y"),
                       ("u.jpg", b"u"), ("b/v.jpg", b"v")):
        (test / name).write_bytes(data)
    return str(tmp_path / "train"), str(tmp_path / "test")


def test_check_sha_equals_jax(sha_folders):
    src, dst = sha_folders
    assert psha.load_folder(dst) == jsha.load_folder(dst)
    port, ref = psha.check_folder(src, dst), jsha.check_folder(src, dst)
    assert port == ref
    assert (len(port[0]), len(port[1])) == (3, 2)
    path = os.path.join(dst, "a", "u.jpg")
    assert psha.sha512_file(path) == jsha.sha512_file(path)


@pytest.mark.parametrize("p,seed", [(0.1, 0), (0.5, 0), (0.5, 3), (0.9, 7)])
def test_sample_dataset_copies_what_jax_copies(dataset, tmp_path, p, seed):
    copied = {}
    for name, module in (("port", psample), ("jax", jsample)):
        dst = tmp_path / name
        n = module.sample_dataset(dataset, str(dst), p, seed=seed)
        copied[name] = (n, sorted(os.path.relpath(os.path.join(r, f), dst)
                                  for r, _, fs in os.walk(dst) for f in fs))
    assert copied["port"] == copied["jax"]
    assert copied["port"][0] == len(copied["port"][1])


def test_references_equal_jax(dataset, tmp_path):
    """add_reference puts each label's first file as <label>/0.jpg (a label
    with no files and a stray file are skipped); del_reference removes
    them."""
    ref_dir = tmp_path / "ref"
    shutil.copytree(dataset, ref_dir)
    (ref_dir / "class_empty").mkdir()
    (ref_dir / "stray.txt").write_text("not a label")
    trees = {}
    for name, module in (("port", psample), ("jax", jsample)):
        target = tmp_path / name
        module.sample_dataset(dataset, str(target), 0.5, seed=1)
        added = module.add_reference(str(ref_dir), str(target))
        refs = sorted((p.parent.name, p.read_bytes())
                      for p in target.glob("*/0.jpg"))
        removed = module.del_reference(str(target))
        trees[name] = (added, refs, removed,
                       sorted(str(p.relative_to(target))
                              for p in target.rglob("*")))
    assert trees["port"] == trees["jax"]
    assert trees["port"][0] == trees["port"][2] == 3


def _jax_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.rsplit(".", 1)[-1], *argv])
    runpy.run_module(module, run_name="__main__")


@pytest.mark.parametrize("cli,argv", [
    ("check_sha", ["--src", "{train}", "--dst", "{test}"]),
    ("sample_dataset", ["--src", "{data}", "--dst", "{out}", "-p", "0.4"]),
    ("sample_dataset", ["--src", "{data}", "--dst", "{out}",
                        "--add-reference"]),
    ("sample_dataset", ["--src", "{data}", "--dst", "{data_copy}",
                        "--del-reference"]),
])
def test_cli_output_equals_jax(cli, argv, dataset, sha_folders, tmp_path,
                               monkeypatch, capsys):
    """Each CLI's ``main`` prints what the JAX module's ``__main__`` prints
    on the same arguments (each side on its own output folder)."""
    printed = []
    for name, run in (
            ("port", lambda a: getattr({"check_sha": psha,
                                        "sample_dataset": psample}[cli],
                                       "main")(a)),
            ("jax", lambda a: _jax_main(
                f"touhouimageclassification_tpu.utils.{cli}", a,
                monkeypatch))):
        data_copy = tmp_path / name / "data"
        shutil.copytree(dataset, data_copy)
        psample.add_reference(dataset, str(data_copy))
        fields = dict(train=sha_folders[0], test=sha_folders[1], data=dataset,
                      out=str(tmp_path / name / "out"),
                      data_copy=str(data_copy))
        run([a.format(**fields) for a in argv])
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    assert printed[0]
