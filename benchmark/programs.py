"""The system under test, built from a configuration file: the port's ViT
at the file's sizes and settings, loaded with the benchmark's weights, as a
``Trainer`` or a ``Predictor``. Nothing here is imported before the
harness has checked the card."""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from weights import vit_shape

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def vit_config(cfg: dict):
    from touhouimageclassification_tpu_torch.config import ViTConfig
    port = cfg["port"]
    return ViTConfig(image_size=cfg["image_size"], patch_size=cfg["patch_size"],
                     hidden_size=cfg["hidden_size"],
                     num_layers=cfg["num_hidden_layers"],
                     num_heads=cfg["num_attention_heads"],
                     mlp_dim=cfg["intermediate_size"],
                     num_classes=port["num_labels"],
                     dropout_rate=cfg["hidden_dropout_prob"],
                     attention_dropout_rate=cfg["attention_probs_dropout_prob"],
                     layer_norm_eps=cfg["layer_norm_eps"],
                     attention_impl=port["attention_impl"],
                     patch_embed_impl=port["patch_embed_impl"],
                     gelu=port["gelu"], remat=port["remat"])


def class_names(classes: int) -> list[str]:
    return [f"c{i:03d}" for i in range(classes)]


def build_trainer(cfg: dict, preset: str, batch: int, seed: int,
                  weights: dict, device, scratch: Path):
    """The port's ``Trainer`` for ``preset`` at ``batch``, its step
    randomness seeded by ``seed``, its model holding ``weights``."""
    from touhouimageclassification_tpu_torch.config import PRESETS
    from touhouimageclassification_tpu_torch.models.vit import ViT
    from touhouimageclassification_tpu_torch.train.trainer import Trainer
    base = PRESETS[preset]
    tcfg = dataclasses.replace(
        base, global_batch_size=batch, seed=seed, log_dir=str(scratch / "log"),
        checkpoint=dataclasses.replace(base.checkpoint,
                                       directory=str(scratch / "ckpt")))
    port = cfg["port"]
    model = ViT(vit_config(cfg), compute_dtype=port["compute_dtype"],
                param_dtype=port["train_param_dtype"], device=device)
    trainer = Trainer(tcfg, model=model, device=device, init_params=weights)
    return trainer, trainer.init_state()


def build_predictor(cfg: dict, weights: dict, device):
    """The port's ``Predictor`` over the ViT with ``weights`` in the
    configuration's serving dtype."""
    from touhouimageclassification_tpu_torch.infer.serve import Predictor
    from touhouimageclassification_tpu_torch.models.vit import ViT
    port = cfg["port"]
    model = ViT(vit_config(cfg), compute_dtype=port["compute_dtype"],
                param_dtype=port["serve_param_dtype"], device=device)
    model.load_state_dict(weights)
    size = vit_shape(cfg)["image"]
    names = class_names(port["num_labels"])
    return Predictor(model=model, class_to_idx={n: i for i, n in enumerate(names)},
                     image_size=(size, size), mean=np.asarray(MEAN),
                     std=np.asarray(STD), device=torch.device(device))
