"""The V-MoE system under test, built from a configuration file: the port's
``VMoE`` at the file's sizes, holding the file's share of the experts,
loaded with the benchmark's weights, as a ``Trainer`` with ``VMoETask``.
Nothing here is imported before the harness has checked the card."""
from __future__ import annotations

import dataclasses
from pathlib import Path

from programs import vit_config


def vmoe_config(cfg: dict):
    """The port's ``VMoEConfig`` of a configuration file: the experts of
    rank 0 of ``num_experts / num_experts_held`` expert shards."""
    from touhouimageclassification_tpu_torch.models.vmoe import VMoEConfig
    return VMoEConfig(
        vit=vit_config(cfg), moe_layers=tuple(cfg["moe_layers"]),
        num_experts=cfg["num_experts"], top_k=cfg["num_selected_experts"],
        capacity_factor=cfg["capacity_factor"],
        noise_std=cfg["router_noise_std"],
        importance_weight=cfg["importance_loss_weight"],
        load_weight=cfg["load_loss_weight"],
        group_images=cfg["group_size_images"],
        num_expert_shards=cfg["num_experts"] // cfg["num_experts_held"],
        expert_index=0)


def build_vmoe_trainer(cfg: dict, preset: str, batch: int, seed: int,
                       weights: dict, device, scratch: Path):
    """The port's ``Trainer`` for ``preset`` at ``batch`` over ``VMoE`` with
    ``VMoETask``, its step randomness seeded by ``seed``, its model holding
    ``weights``."""
    from touhouimageclassification_tpu_torch.config import PRESETS
    from touhouimageclassification_tpu_torch.models.vmoe import VMoE
    from touhouimageclassification_tpu_torch.train.tasks import VMoETask
    from touhouimageclassification_tpu_torch.train.trainer import Trainer
    base = PRESETS[preset]
    tcfg = dataclasses.replace(
        base, global_batch_size=batch, seed=seed, log_dir=str(scratch / "log"),
        checkpoint=dataclasses.replace(base.checkpoint,
                                       directory=str(scratch / "ckpt")))
    port = cfg["port"]
    model = VMoE(vmoe_config(cfg), compute_dtype=port["compute_dtype"],
                 param_dtype=port["train_param_dtype"], device=device)
    trainer = Trainer(tcfg, model=model, task=VMoETask(), device=device,
                      init_params=weights)
    return trainer, trainer.init_state()
