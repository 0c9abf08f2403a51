"""The port's ViT forward and gradients against the JAX ViT on the same
weights and images.

JAX ``ViT.init`` makes the parameters, :func:`from_jax_params` carries them
into the port, and both run in f32 on the CPU (the JAX ``'fused'`` and
``'flash'`` attentions and the ``'pallas'`` patch embedding through their
Pallas kernels in interpret mode). Tolerance 1e-4 on the logits: f32
summation order through two encoder layers. The ``'flash'`` cases run the
whole slice of that name: ``attention_impl='flash'`` (K4) with
``patch_embed_impl='pallas'`` (K5).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from chip_smoke import hf_vit_state_dict
from touhouimageclassification_tpu.config import ViTConfig
from touhouimageclassification_tpu.models.vit import ViT as JaxViT
from touhouimageclassification_tpu.ops.gelu import gelu_fast
from touhouimageclassification_tpu.utils.convert import load_torch_checkpoint
from touhouimageclassification_tpu_torch.models import create_model
from touhouimageclassification_tpu_torch.models import vit as port_vit
from touhouimageclassification_tpu_torch.models.vit import ViT
from touhouimageclassification_tpu_torch.ops.gelu import gelu
from touhouimageclassification_tpu_torch.utils.convert import (from_jax_params,
                                                               load_vit_weights)
from test_torch_copies import port_config

torch.set_num_threads(1)

TINY = ViTConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                 num_heads=4, mlp_dim=128, num_classes=10)
ATOL = 1e-4


def _vit(cfg, **kwargs):
    """The port's ViT for a JAX-package config (through port_config)."""
    return ViT(port_config(cfg), **kwargs)


def _knobs(attention_impl):
    """The config overrides of one attention case: 'flash' comes with the
    'pallas' patch embedding, as the slice runs them."""
    return dict(attention_impl=attention_impl,
                patch_embed_impl="pallas" if attention_impl == "flash" else "xla")


def _images(n=3, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


def _port_logits(cfg, state_dict, x):
    model = _vit(cfg, compute_dtype="float32", device="cpu")
    model.load_state_dict(state_dict)
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("attention_impl", ["fused", "xla", "flash"])
@pytest.mark.parametrize("gelu_variant", ["exact", "fast"])
def test_logits_match_jax(monkeypatch, attention_impl, gelu_variant):
    monkeypatch.setenv("TIC_PALLAS_INTERPRET", "1")
    cfg = dataclasses.replace(TINY, **_knobs(attention_impl),
                              gelu=gelu_variant)
    x = _images()
    jax_model = JaxViT(cfg, compute_dtype="float32")
    params = jax_model.init(jax.random.key(0), x)
    want = np.asarray(jax_model.apply(params, x))
    got = _port_logits(cfg, from_jax_params(params, port_config(cfg)), x)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("attention_impl", ["fused", "xla", "flash"])
def test_bf16_logits_within_jax_bf16_rounding(attention_impl):
    """bf16 rounds at other places in the two frameworks, so the port's bf16
    logits may differ from JAX's bf16 logits, but by no more than JAX's own
    bf16 logits differ from its f32 logits on the same inputs."""
    cfg = dataclasses.replace(TINY, **_knobs(attention_impl))
    x = _images(4)
    params = JaxViT(cfg, compute_dtype="float32").init(jax.random.key(0), x)
    want = np.asarray(JaxViT(cfg, compute_dtype="bfloat16").apply(params, x))
    want32 = np.asarray(JaxViT(cfg, compute_dtype="float32").apply(params, x))
    model = _vit(cfg, compute_dtype="bfloat16", device="cpu")
    model.load_state_dict(from_jax_params(params, port_config(cfg)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= np.abs(want - want32).max()


def test_erf_gelu_within_fast_gelu_bound():
    """The port computes erf GELU for 'fast'; the JAX fit stays within
    0.12 x the tanh approximation's 4.7e-4 of it."""
    x = np.linspace(-8, 8, 20001, dtype=np.float32)
    ours = gelu(torch.from_numpy(x), "fast").numpy()
    assert np.abs(ours - np.asarray(gelu_fast(x))).max() < 6e-5


def test_from_jax_params_rejects_depth_mismatch():
    x = _images(1)
    params = JaxViT(TINY, compute_dtype="float32").init(jax.random.key(0), x)
    with pytest.raises(ValueError, match="2 encoder layers"):
        from_jax_params(params,
                        port_config(dataclasses.replace(TINY, num_layers=3)))


@pytest.mark.parametrize("ext", [".pth", ".safetensors"])
@pytest.mark.parametrize("ckpt_classes", [10, 7])
def test_hf_checkpoint_matches_jax_loader(tmp_path, ext, ckpt_classes):
    """HF-layout checkpoint -> both loaders -> the same logits; a head of
    another class count is re-initialised the same way on both sides."""
    sd = hf_vit_state_dict(64, 2, 128, ckpt_classes, image_size=32, patch=8)
    path = str(tmp_path / f"vit{ext}")
    if ext == ".pth":
        torch.save(sd, path)
    else:
        from safetensors.torch import save_file

        save_file(sd, path)
    x = _images()
    jax_model = JaxViT(TINY, compute_dtype="float32")
    if ext == ".pth":
        params, _ = load_torch_checkpoint(path, jax_model, TINY.num_classes)
    else:
        params, _ = load_torch_checkpoint(dict(sd), jax_model,
                                          TINY.num_classes)
    want = np.asarray(jax_model.apply({"params": params}, x))
    got = _port_logits(TINY, load_vit_weights(path, port_config(TINY)), x)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_unported_options_raise():
    """What the port refuses: 'flash' with attention dropout (as JAX,
    vit.py:127-131), unknown implementations, unknown model types and a
    wrong input size. Every family of the JAX registry builds, the mixtures
    (ResMoE, TreeViT) included."""
    with pytest.raises(ValueError, match="attention_dropout_rate"):
        _vit(dataclasses.replace(TINY, attention_impl="flash",
                                 attention_dropout_rate=0.1), device="cpu")
    with pytest.raises(ValueError, match="patch_embed_impl"):
        _vit(dataclasses.replace(TINY, patch_embed_impl="conv"), device="cpu")
    with pytest.raises(ValueError, match="Unknown model type"):
        create_model("resmoe-xl", num_classes=10)
    member = port_config(TINY)
    for mt, over, members in (("resmoe", {"expert_vit": member}, "experts"),
                              ("vit-moe", {"expert_vit": member}, "experts"),
                              ("tree-vit", {"vit": member}, "sons"),
                              ("treevit", {"vit": member}, "sons")):
        model = create_model(mt, num_classes=10, compute_dtype="float32",
                             device="cpu", **over)
        assert len(getattr(model, members)) == 8, mt
        assert model.eval()(torch.zeros(2, 32, 32, 3))[0].shape == (2, 10)
    with pytest.raises(ValueError, match="Input spatial size"):
        _vit(TINY, device="cpu")(torch.zeros(1, 16, 16, 3))


@pytest.mark.parametrize("attention_impl", ["fused", "xla", "flash"])
def test_gradients_match_jax(monkeypatch, attention_impl):
    """Gradients of sum(logits * w) w.r.t. every parameter against
    jax.grad of the JAX ViT, mapped through from_jax_params. f32; the bound
    covers summation order through the backward of two layers."""
    monkeypatch.setenv("TIC_PALLAS_INTERPRET", "1")
    cfg = dataclasses.replace(TINY, **_knobs(attention_impl), gelu="exact")
    x = _images()
    w = np.random.default_rng(1).standard_normal((3, 10)).astype(np.float32)
    jax_model = JaxViT(cfg, compute_dtype="float32")
    params = jax_model.init(jax.random.key(0), x)
    grads = jax.grad(lambda p: (jax_model.apply(p, x) * w).sum())(params)
    want = from_jax_params(grads, port_config(cfg))

    model = _vit(cfg, compute_dtype="float32", device="cpu",
                 param_dtype="float32")
    model.load_state_dict(from_jax_params(params, port_config(cfg)))
    (model(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=1e-4, rtol=1e-4,
                                   msg=k)


def test_f32_params_bf16_compute_give_f32_gradients():
    """Training holds f32 master parameters and computes in bf16 (the JAX
    model's param_dtype=float32): gradients land in f32, and the forward
    rounds each weight to bf16 as the bf16-stored serve model does."""
    x = torch.from_numpy(_images(2))
    params = JaxViT(TINY, compute_dtype="float32").init(
        jax.random.key(0), x.numpy())
    train = _vit(TINY, compute_dtype="bfloat16", device="cpu",
                 param_dtype="float32")
    serve = _vit(TINY, compute_dtype="bfloat16", device="cpu")
    sd = from_jax_params(params, port_config(TINY))
    train.load_state_dict(sd)
    serve.load_state_dict(sd)
    assert train.layer[0].attn.qkv.weight.dtype == torch.float32
    assert serve.layer[0].attn.qkv.weight.dtype == torch.bfloat16
    train(x).sum().backward()
    assert all(p.grad.dtype == torch.float32 for p in train.parameters())
    with torch.no_grad():
        torch.testing.assert_close(train(x), serve(x), atol=0, rtol=0)


@pytest.mark.parametrize("plain,recomputed", [
    (dict(remat=False), dict(remat=True)),
    (dict(attention_impl="xla"), dict(attention_impl="xla_remat"))])
def test_remat_gives_the_same_gradients(plain, recomputed):
    """Layer remat and 'xla_remat' recompute in the backward what they do not
    save: the gradients are the same, bit for bit."""
    x = torch.from_numpy(_images(2))
    sd = from_jax_params(JaxViT(TINY, compute_dtype="float32").init(
        jax.random.key(0), x.numpy()), port_config(TINY))
    grads = []
    for over in (plain, recomputed):
        model = _vit(dataclasses.replace(TINY, **over),
                     compute_dtype="float32", device="cpu").train()
        model.load_state_dict(sd)
        model(x).sum().backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_remat_dots_policy_is_not_ported():
    with pytest.raises(NotImplementedError, match="dots"):
        _vit(dataclasses.replace(TINY, remat=True, remat_policy="dots"),
             device="cpu")


def test_fused_with_attention_dropout_takes_plain_attention(monkeypatch):
    """The JAX rule (models/vit.py:107): 'fused' with attention dropout runs
    the plain attention, so a train() forward launches no slab kernel; in
    eval() it is the rate-0 model, bit for bit."""
    calls = []
    real = port_vit.slab_attention

    def counting(qkv, heads):
        calls.append(qkv.shape)
        return real(qkv, heads)

    monkeypatch.setattr(port_vit, "slab_attention", counting)
    x = torch.from_numpy(_images(2))
    sd = from_jax_params(JaxViT(TINY, compute_dtype="float32").init(
        jax.random.key(0), x.numpy()), port_config(TINY))
    drop = _vit(dataclasses.replace(TINY, attention_dropout_rate=0.5),
                compute_dtype="float32", device="cpu")
    plain = _vit(TINY, compute_dtype="float32", device="cpu")
    drop.load_state_dict(sd)
    plain.load_state_dict(sd)

    torch.manual_seed(0)
    dropped = drop.train()(x)
    assert calls == []
    with torch.no_grad():
        assert not torch.equal(dropped, plain.eval()(x))
        assert calls == [(2, 17, 192)] * TINY.num_layers
        torch.testing.assert_close(drop.eval()(x), plain(x), atol=0, rtol=0)
    assert len(calls) == 2 * TINY.num_layers


def test_dropout_only_in_train_mode():
    """Embedding and MLP dropout run in train() mode only."""
    cfg = dataclasses.replace(TINY, dropout_rate=0.3)
    x = torch.from_numpy(_images(2))
    sd = from_jax_params(JaxViT(TINY, compute_dtype="float32").init(
        jax.random.key(0), x.numpy()), port_config(TINY))
    model = _vit(cfg, compute_dtype="float32", device="cpu")
    ref = _vit(TINY, compute_dtype="float32", device="cpu")
    model.load_state_dict(sd)
    ref.load_state_dict(sd)
    with torch.no_grad():
        torch.testing.assert_close(model.eval()(x), ref(x), atol=0, rtol=0)
        torch.manual_seed(0)
        assert not torch.equal(model.train()(x), ref(x))


def test_flash_and_pallas_route_through_their_wrappers(monkeypatch):
    """A 'flash' + 'pallas' forward hands the attention wrapper the q, k, v
    views of the QKV projection (no copy: row stride 3C) once per layer and
    the patch-embed wrapper the images, the compute-dtype weight and bias
    once; with f32 compute it equals the 'fused' + 'xla' model."""
    calls = {"flash": [], "patch": []}
    real_flash, real_patch = port_vit.flash_attention, port_vit.patch_embed

    def flash(q, k, v):
        calls["flash"].append((q.shape, q.stride(), k.data_ptr() - q.data_ptr()))
        return real_flash(q, k, v)

    def patch(images, weight, bias, p):
        calls["patch"].append((weight.dtype, bias.dtype, p))
        return real_patch(images, weight, bias, p)

    monkeypatch.setattr(port_vit, "flash_attention", flash)
    monkeypatch.setattr(port_vit, "patch_embed", patch)
    x = torch.from_numpy(_images(2))
    sd = from_jax_params(JaxViT(TINY, compute_dtype="float32").init(
        jax.random.key(0), x.numpy()), port_config(TINY))
    knobs = _vit(dataclasses.replace(TINY, **_knobs("flash")),
                 compute_dtype="float32", device="cpu")
    plain = _vit(TINY, compute_dtype="float32", device="cpu")
    knobs.load_state_dict(sd)
    plain.load_state_dict(sd)
    with torch.no_grad():
        torch.testing.assert_close(knobs(x), plain(x), atol=1e-5, rtol=1e-5)
    c = TINY.hidden_size
    assert calls["flash"] == [((2, 17, 4, 16), (17 * 3 * c, 3 * c, 16, 1),
                               c * 4)] * TINY.num_layers
    assert calls["patch"] == [(torch.float32, torch.float32, 8)]
