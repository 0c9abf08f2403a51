"""The port's scratch initialisation against flax's, leaf by leaf.

The JAX package initialises its ViT from ``jax.random.key(cfg.seed)``; the
port draws from a ``torch.Generator``, so the two agree in distribution,
not bit for bit. For every leaf of a tiny ViT, the JAX ``ViT.init`` leaf
and the port's must both be zero where flax puts zeros (biases, the class
token) and one where it puts ones (LayerNorm scales); elsewhere the port's
mean lies within 3 sigma/sqrt(n) of 0, the standard deviations of both lie
within 10% of flax's (lecun_normal: 1/sqrt(fan_in); the position
embedding: 0.02), and every lecun value within the +-2 sigma/0.8796
truncation.
"""
import jax
import numpy as np
import pytest
import torch

from test_torch_copies import port_config
from touhouimageclassification_tpu.config import TrainConfig, ViTConfig
from touhouimageclassification_tpu.models.vit import ViT as JaxViT
from touhouimageclassification_tpu_torch.models import create_model
from touhouimageclassification_tpu_torch.models.vit import ViT
from touhouimageclassification_tpu_torch.train import trainer as trainer_mod
from touhouimageclassification_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)

# widths large enough that every leaf's standard deviation is estimated to
# a few percent (the smallest weight, the head, has 16 x 64 values)
TINY = ViTConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                 num_heads=4, mlp_dim=128, num_classes=16)
NAMES = list(ViT(port_config(TINY), "float32", "cpu").state_dict())
TRUNCATION = 2 / 0.87962566103423978


@pytest.fixture(scope="module")
def leaves():
    """(JAX ViT.init leaves in the port's layout, port leaves), seed 0."""
    params = JaxViT(TINY, compute_dtype="float32").init(
        jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32))
    jax_sd = from_jax_params(jax.device_get(params), port_config(TINY))
    port_sd = ViT(port_config(TINY), "float32", "cpu", seed=0).state_dict()
    return jax_sd, port_sd


def _flax_std(name: str, value: torch.Tensor) -> float | None:
    """flax's standard deviation for a random leaf (None for a constant)."""
    if name == "pos_embed":
        return 0.02
    if name.endswith(".weight") and value.dim() == 2:
        return value.shape[1] ** -0.5   # nn.Linear (out, in): fan_in = in
    return None


@pytest.mark.parametrize("name", NAMES)
def test_leaf_follows_flax(leaves, name):
    jax_sd, port_sd = leaves
    want, got = jax_sd[name], port_sd[name]
    assert got.shape == want.shape and got.dtype == torch.float32
    std = _flax_std(name, want)
    if std is None:
        constant = want.flatten()[0].item()
        assert constant in (0.0, 1.0), name
        assert torch.equal(want, torch.full_like(want, constant)), name
        assert torch.equal(got, torch.full_like(got, constant)), name
        return
    n = got.numel()
    assert abs(got.mean().item()) <= 3 * std / n ** 0.5, name
    for leaf in (got, want):
        assert abs(leaf.std().item() / std - 1) <= 0.10, (name, leaf.std())
    if name != "pos_embed":
        for leaf in (got, want):
            assert leaf.abs().max().item() <= TRUNCATION * std, name


def test_position_embedding_is_drawn_not_zero(leaves):
    """The fault this repairs: torch's constructor left pos_embed zero."""
    _, port_sd = leaves
    assert abs(port_sd["pos_embed"].std().item() / 0.02 - 1) <= 0.10


def test_same_seed_same_weights_other_seed_differs():
    a = ViT(port_config(TINY), "float32", "cpu", seed=3).state_dict()
    b = create_model("vit-base", compute_dtype="float32", device="cpu",
                     seed=3, **{k: getattr(TINY, k) for k in (
                         "image_size", "patch_size", "hidden_size",
                         "num_layers", "num_heads", "mlp_dim")},
                     num_classes=TINY.num_classes).state_dict()
    c = ViT(port_config(TINY), "float32", "cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    drawn = [k for k in a if _flax_std(k, a[k]) is not None]
    assert drawn and not any(torch.equal(a[k], c[k]) for k in drawn)


def test_trainer_default_model_is_seeded_by_the_config(tmp_path, monkeypatch):
    """Trainer builds its default model from cfg.seed; a model handed to it
    keeps its weights."""
    seen = {}

    def factory(model_type, seed=0, **kwargs):
        seen.update(model_type=model_type, seed=seed)
        return ViT(port_config(TINY), "float32", kwargs.get("device"),
                   param_dtype="float32", seed=seed)

    monkeypatch.setattr(trainer_mod, "create_model", factory)
    cfg = port_config(TrainConfig(seed=7, log_dir=str(tmp_path)))
    trainer = trainer_mod.Trainer(cfg, device="cpu")
    assert seen == {"model_type": "vit-large", "seed": 7}
    want = ViT(port_config(TINY), "float32", "cpu", seed=7).state_dict()
    assert all(torch.equal(trainer.model.state_dict()[k], want[k])
               for k in want)
    given = ViT(port_config(TINY), "float32", "cpu", seed=1)
    before = {k: v.clone() for k, v in given.state_dict().items()}
    trainer_mod.Trainer(cfg, model=given, device="cpu").init_state()
    assert all(torch.equal(given.state_dict()[k], before[k]) for k in before)
