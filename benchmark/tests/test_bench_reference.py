"""The plain reference against the port on the CPU at a tiny width and
depth: the same seeded state dict in both, the same inputs."""
import numpy as np
import pytest
import torch

from bench_tiny import TINY_CONFIG
from reference import augment_plain, vit_plain
from reference.train_plain import leaf_parts, part_norms
from weights import make_weights, vit_shape


def _port_vit(cfg, weights):
    from programs import vit_config
    from touhouimageclassification_tpu_torch.models.vit import ViT
    model = ViT(vit_config(cfg), compute_dtype="float32",
                param_dtype="float32", device="cpu")
    model.load_state_dict(weights)
    return model.eval()


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7])
def test_plain_vit_matches_port(seed):
    shape = vit_shape(TINY_CONFIG)
    w = make_weights(shape, seed, "cpu")
    images = torch.randn(3, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        port = _port_vit(TINY_CONFIG, w)(images)
        plain = vit_plain.PlainViT(w, shape).logits(images)
    torch.testing.assert_close(plain, port, rtol=1e-5, atol=1e-5)


def test_plain_vit_gradients_match_port():
    shape = vit_shape(TINY_CONFIG)
    w = make_weights(shape, 5, "cpu")
    images = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    model = _port_vit(TINY_CONFIG, w)
    model(images).square().sum().backward()
    params = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    vit_plain.PlainViT(params, shape).logits(images).square().sum().backward()
    for name, p in model.named_parameters():
        torch.testing.assert_close(params[name].grad, p.grad, rtol=1e-4,
                                   atol=1e-5)


def test_fp8_control_departs_from_fp32():
    shape = vit_shape(TINY_CONFIG)
    w = make_weights(shape, 3, "cpu")
    images = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        exact = vit_plain.PlainViT(w, shape).logits(images)
        low = vit_plain.PlainViT(w, shape, "fp8").logits(images)
    gap = (exact - low).abs().max()
    assert 1e-3 < gap < 10.0


@pytest.mark.parametrize("step", [0, 1, 5])
def test_frozen_recipe_matches_port(step):
    """The frozen augmentation + mix reproduces the port's step inputs,
    draw for draw."""
    from touhouimageclassification_tpu_torch.config import AugmentConfig
    from touhouimageclassification_tpu_torch.ops.augment import \
        build_augment_fn
    from touhouimageclassification_tpu_torch.ops.mixup import cutmix_or_mixup
    seed = 987654321
    rng0 = np.random.default_rng(step)
    images = torch.from_numpy(rng0.integers(0, 256, (6, 40, 40, 3),
                                            dtype=np.uint8))
    labels = torch.from_numpy(rng0.integers(0, 120, 6))
    rng = np.random.default_rng([seed, step])
    gen = torch.Generator().manual_seed(int(rng.integers(2 ** 63)))
    x = build_augment_fn(AugmentConfig(), (32, 32))(gen, images.float() / 255)
    y = torch.nn.functional.one_hot(labels, 120).float()
    x, y = cutmix_or_mixup(rng, x, y, 1.0, 1.0)
    fx, fy = augment_plain.step_inputs(seed, step, images, labels, 120,
                                       (32, 32))
    torch.testing.assert_close(fx, x, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fy, y)


def test_resize_matches_port():
    from touhouimageclassification_tpu_torch.ops.augment import resize
    x = torch.rand(2, 256, 256, 3, generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(augment_plain.resize(x, (224, 224)),
                               resize(x, (224, 224)))


def test_leaf_parts_split_the_fused_qkv_bias():
    t = torch.arange(6.0)
    parts = dict(leaf_parts("layer.0.attn.qkv.bias", t))
    assert list(parts) == ["layer.0.attn.qkv.bias[q]",
                           "layer.0.attn.qkv.bias[k]",
                           "layer.0.attn.qkv.bias[v]"]
    norms = part_norms({"a": torch.ones(4), "layer.1.attn.qkv.bias": t})
    assert norms["a"] == pytest.approx(2.0)
    assert norms["layer.1.attn.qkv.bias[k]"] == pytest.approx(float(
        torch.tensor([2.0, 3.0]).norm()))
