"""``TrainConfig.nan_guard`` in the port's Trainer, against the JAX
package's (``tests/test_nan_guard.py``).

With ``nan_guard=False`` a poisoned step commits: the parameters, the
optimizer state and a ResNet's BatchNorm statistics take their non-finite
values, and ``step`` advances, as the JAX step does when it skips its
``lax.cond``. The default ``True`` still skips the update
(``test_torch_train.py``, ``test_torch_resnet.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_copies import port_config
from touhouimageclassification_tpu.config import (AugmentConfig,
                                                  CheckpointConfig, MixConfig,
                                                  OptimizerConfig,
                                                  ResNetConfig, TrainConfig,
                                                  ViTConfig)
from touhouimageclassification_tpu.models.resnet import ResNet as JaxResNet
from touhouimageclassification_tpu.models.vit import ViT as JaxViT
from touhouimageclassification_tpu.parallel.mesh import (create_mesh,
                                                         data_sharding)
from touhouimageclassification_tpu.train.trainer import Trainer as JaxTrainer
from touhouimageclassification_tpu_torch.models.resnet import ResNet
from touhouimageclassification_tpu_torch.models.vit import ViT
from touhouimageclassification_tpu_torch.train.trainer import Trainer
from touhouimageclassification_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)

TINY = ViTConfig(image_size=16, patch_size=8, hidden_size=16, num_layers=1,
                 num_heads=2, mlp_dim=32, num_classes=4)
TINY_RESNET = ResNetConfig(depth=18, num_classes=4, image_size=16)


def _cfg(tmp, model_type, nan_guard):
    return TrainConfig(
        train_id="nan_run", model_type=model_type, global_batch_size=8,
        seed=0, nan_guard=nan_guard,
        optimizer=OptimizerConfig(name="adamw", learning_rate=1e-2),
        augment=AugmentConfig(enable_augmentation=False),
        mix=MixConfig(enable_mixup=False),
        checkpoint=CheckpointConfig(directory=str(tmp / "c"),
                                    async_save=False),
        log_dir=str(tmp / "l"))


BAD = {"image": np.full((8, 16, 16, 3), 255, np.uint8),
       "label": np.zeros((8,), np.int32), "mask": np.ones((8,), bool)}


def _finite(tree) -> dict[str, bool]:
    return {k: bool(torch.isfinite(v).all()) for k, v in tree.items()}


@pytest.mark.parametrize("family", ["vit", "resnet"])
@pytest.mark.parametrize("nan_guard", [False, True])
def test_poisoned_step_commits_only_without_the_guard(tmp_path, family,
                                                      nan_guard):
    """Both Trainers from the same poisoned parameters (every matrix or
    kernel x 1e38) take one AdamW step on a white batch: the loss or the
    grad norm is not finite in both. Without the guard both commit
    non-finite parameters, BN statistics and Adam moments (for the ViT the
    same leaves), and every parameter moved; with it nothing moved.
    ``step`` is 1."""
    model_type = "vit-base" if family == "vit" else "resnet18"
    mcfg = TINY if family == "vit" else TINY_RESNET
    jmodel = (JaxViT(mcfg, compute_dtype="float32") if family == "vit"
              else JaxResNet(mcfg, compute_dtype="float32"))
    mesh = create_mesh(num_data=1, devices=jax.devices()[:1])
    jt = JaxTrainer(_cfg(tmp_path, model_type, nan_guard), model=jmodel,
                    mesh=mesh)
    jstate = jt.init_state(4)
    jstate = jstate.replace(params=jax.tree_util.tree_map(
        lambda x: jnp.where(jnp.isfinite(x), x * 1e38, x) if x.ndim >= 2
        else x, jstate.params))
    poisoned = jax.device_get({"params": jstate.params,
                               **jstate.model_state})
    jnew, jm = jt._make_train_step()(jstate, jax.device_put(
        BAD, data_sharding(mesh)))
    assert not (np.isfinite(float(jm["loss"]))
                and np.isfinite(float(jm["grad_norm"])))
    assert int(jnew.step) == 1
    pcfg = port_config(mcfg)
    model = (ViT(pcfg, "float32", "cpu", param_dtype="float32")
             if family == "vit" else
             ResNet(pcfg, "float32", "cpu", param_dtype="float32"))
    pt = Trainer(port_config(_cfg(tmp_path, model_type, nan_guard)),
                 model=model, device="cpu",
                 init_params=from_jax_params(poisoned, pcfg))
    pstate = pt.init_state(4)
    before = {k: v.clone() for k, v in pstate.model.state_dict().items()}
    pm = pt.train_step(pstate, pt.stage(BAD))
    assert not (np.isfinite(pm["loss"]) and np.isfinite(pm["grad_norm"]))
    assert pstate.step == 1

    jafter = from_jax_params(jax.device_get(
        {"params": jnew.params, **jnew.model_state}), pcfg)
    after = pstate.model.state_dict()
    if family == "vit" or nan_guard:
        assert _finite(after) == _finite(jafter)
    else:
        # which BN leaf an inf turns into a NaN depends on the order of the
        # sums: both commit non-finite parameters and statistics
        assert not any(all(_finite({k: v for k, v in tree.items()
                                    if "running" in k}).values())
                       for tree in (after, jafter))
    names = {id(p): n for n, p in pstate.model.named_parameters()}
    adam = next(x for x in jax.tree_util.tree_leaves(
        jax.device_get(jnew.opt_state), is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(x, "mu"))
    jmu = ({str(i): torch.from_numpy(np.array(leaf)) for i, leaf in
            enumerate(jax.tree_util.tree_leaves(adam.mu))}
           if family == "resnet" else from_jax_params(adam.mu, pcfg))
    mu = {names[id(p)]: s["exp_avg"]
          for p, s in pstate.optimizer.inner.state.items()}
    if nan_guard:
        for k in after:
            assert torch.equal(after[k], before[k]), k
        assert pstate.optimizer.count == 0 and int(adam.count) == 0
        assert not mu
        assert all(torch.equal(v, torch.zeros_like(v)) for v in jmu.values())
        return
    assert not all(_finite(after).values())
    for k, p in pstate.model.named_parameters():
        assert not torch.equal(p, before[k]), k
    if family == "resnet":
        stats = [k for k in after if "running" in k]
        assert stats and not all(_finite({k: after[k] for k in stats})
                                 .values())
    assert pstate.optimizer.count == 1 and int(adam.count) == 1
    assert len(mu) == len(jmu)
    if family == "vit":
        assert _finite(mu) == _finite(jmu)
    assert not all(_finite(mu).values()) and not all(_finite(jmu).values())
