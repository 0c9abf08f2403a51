"""Shared training-CLI plumbing (counterpart of the JAX package's
``train/cli.py``): dataset assembly, the run flow and the serving export.

Every trainer entry point takes ``--restore`` (checkpoint path / resume),
``--test`` (evaluate on the test set), ``--transform`` (export a training
checkpoint to serving weights) and ``--device`` (``cuda`` by default; CUDA
without a GPU raises). Several processes train together through the
multi-host flags (``--coordinator host:port --num-processes N --process-id
i``, one launch a process), a torchrun launch (its variables, no flags), or
the JAX package's ``JAX_COORDINATOR_ADDRESS``; each rank runs on
``cuda:<LOCAL_RANK>`` (``--device cpu``: the CPU, over gloo).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os

from ..config import TrainConfig, get_image_size
from ..data import (get_class_to_idx, image_loader, random_split,
                    scan_image_folder)
from ..models import model_config_key
from ..parallel.dist import initialize_distributed, world
from ..utils.mean_std import get_mean_std
from .checkpoint import (SERVING_META, SERVING_PARAMS, CheckpointManager,
                         load_state, save_params)
from .trainer import Trainer


def resolve_normalize_stats(cfg: TrainConfig) -> TrainConfig:
    """``normalize_stats='dataset'`` -> fill cfg.augment.mean/std with the
    cached per-dataset statistics; 'imagenet' keeps the defaults."""
    if cfg.normalize_stats != "dataset":
        return cfg
    mean, std = get_mean_std(cfg.data_dir, get_image_size(cfg.model_type))
    aug = dataclasses.replace(
        cfg.augment, mean=tuple(float(m) for m in mean),
        std=tuple(float(s) for s in std))
    return dataclasses.replace(cfg, augment=aug)


# dims for --tiny CI/CPU smoke runs, shared by the training CLIs
TINY_VIT_DIMS = dict(image_size=32, patch_size=16, hidden_size=32,
                     num_layers=1, num_heads=2, mlp_dim=64)

# dims for --small runs: a DeiT-Tiny-class ViT at the full 224 input
SMALL_VIT_DIMS = dict(image_size=224, patch_size=16, hidden_size=192,
                      num_layers=6, num_heads=3, mlp_dim=768)


def dataset_num_classes(cfg: TrainConfig) -> int:
    """Class count from the training data's class map (what serving will
    use; the model head must match it)."""
    return len(get_class_to_idx(cfg.data_dir))


def canvas_for(cfg: TrainConfig, out_size: tuple[int, int]) -> tuple[int, int]:
    """Host decode canvas: RandomResizedCrop recipes keep ~8/7 headroom
    (224 -> 256) so zoom-out crops retain detail; other recipes decode
    straight to the model size."""
    aug = cfg.augment
    rrc = (aug.enable_augmentation and not aug.only_grey_augmentation
           and aug.enable_generalization)
    if not rrc:
        return out_size
    return tuple(int(math.ceil(s * 8 / 7 / 8) * 8) for s in out_size)


def build_loaders(cfg: TrainConfig, out_size: tuple[int, int]):
    """train/val from cfg.data_dir (random split, seed cfg.seed); test from
    cfg.test_dir when it exists. ``train_split=1.0`` leaves no val loader
    (train loss then ranks the checkpoints)."""
    index = scan_image_folder(cfg.data_dir)
    tr_idx, va_idx = random_split(len(index), cfg.train_split, cfg.seed)
    train = image_loader(index, tr_idx, batch_size=cfg.global_batch_size,
                         canvas=canvas_for(cfg, out_size), shuffle=True,
                         seed=cfg.seed, drop_last=True,
                         canvas_cache=cfg.canvas_cache)
    val = None
    if len(va_idx):
        val = image_loader(index, va_idx, batch_size=cfg.global_batch_size,
                           canvas=out_size, shuffle=False, drop_last=False,
                           canvas_cache=cfg.canvas_cache)
    test = None
    if cfg.test_dir and os.path.isdir(cfg.test_dir):
        t_index = scan_image_folder(cfg.test_dir)
        test = image_loader(t_index, None, batch_size=cfg.global_batch_size,
                            canvas=out_size, shuffle=False, drop_last=False)
    return train, val, test, index


def export_for_serving(cfg: TrainConfig, trainer: Trainer, out_path: str,
                       epoch: int | None = None) -> str:
    """--transform: training checkpoint -> ``<out_path>/params.safetensors``
    (the model's state dict: parameters, and a ResNet's BatchNorm
    statistics) and ``serving_meta.json`` (model type, epoch, the
    training-time normalisation, the model's config under its family's
    key of ``models.EXPORT_CONFIGS``, and the class map), from
    the best epoch by the monitored metric, or the latest, unless ``epoch``
    is given. The port's serve loads the directory."""
    ckpt = CheckpointManager(cfg.checkpoint, cfg.train_id)
    epoch = epoch if epoch is not None else (ckpt.best_epoch()
                                             or ckpt.latest_epoch())
    tensors, saved = ckpt.read(epoch)
    load_state(trainer.init_state(), tensors, saved)
    if world()[0] != 0:
        return out_path  # rank 0 writes the export of a multi-process run
    os.makedirs(out_path, exist_ok=True)
    # from the save's files: under expert parallelism they hold the members
    # the other ranks trained
    save_params(os.path.join(out_path, SERVING_PARAMS),
                {k: tensors[k] for k in trainer.model.state_dict()})
    meta = {
        "model_type": cfg.model_type,
        "epoch": int(epoch),
        "mean": list(cfg.augment.mean),
        "std": list(cfg.augment.std),
        "normalize_stats": cfg.normalize_stats,
    }
    key = model_config_key(trainer.model)
    if key is not None:
        meta[key] = dataclasses.asdict(trainer.model.cfg)
    try:
        meta["class_to_idx"] = get_class_to_idx(cfg.data_dir)
    except OSError:
        pass
    with open(os.path.join(out_path, SERVING_META), "w") as f:
        json.dump(meta, f, indent=1)
    print(f"Exported epoch {epoch} serving params to {out_path}")
    return out_path


def standard_argparser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--restore", type=str, default=None,
                   help="resume from checkpoint dir (default: auto-resume)")
    p.add_argument("--no-resume", action="store_true",
                   help="start fresh even if checkpoints exist")
    p.add_argument("--test", action="store_true", help="evaluate on the test set")
    p.add_argument("--transform", type=str, default=None,
                   help="export best checkpoint to serving params at PATH and exit")
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--canvas-cache", action="store_true",
                   help="decode each image once into the dataset's canvas "
                        "memmap (<data>/.tic_canvas_cache) and feed epochs "
                        "from it — pays decode once, not per epoch")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=None,
                   help="override the preset seed (split/shuffle/init/"
                        "augmentation streams — multi-seed A/Bs)")
    p.add_argument("--train-id", type=str, default=None,
                   help="override the preset train_id (checkpoint/log "
                        "lineage)")
    p.add_argument("--schedule", type=str, default=None,
                   choices=["constant", "warmup_linear", "step"])
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    # multi-process launch, as for the JAX package (torchrun needs none)
    p.add_argument("--coordinator", type=str, default=None,
                   help="coordinator host:port for multi-process training")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def init_distributed_from_args(args) -> bool:
    """Join the process group from the multi-host flags or the launch
    variables (``parallel.dist.initialize_distributed``; a no-op for one
    process); the rank's device follows ``--device``. Idempotent: the CLIs
    that build their model before :func:`run` call it first, and ``run``
    calls it again."""
    device = getattr(args, "device", "cuda")
    return initialize_distributed(
        getattr(args, "coordinator", None),
        getattr(args, "num_processes", None),
        getattr(args, "process_id", None),
        device=None if device == "cuda" else device)


def apply_overrides(cfg: TrainConfig, args) -> TrainConfig:
    over = {}
    if args.data_dir:
        over["data_dir"] = args.data_dir
    if args.max_epochs:
        over["max_epochs"] = args.max_epochs
    if args.batch_size:
        over["global_batch_size"] = args.batch_size
    if getattr(args, "canvas_cache", False):
        over["canvas_cache"] = True
    if getattr(args, "seed", None) is not None:
        over["seed"] = args.seed
    if getattr(args, "train_id", None):
        over["train_id"] = args.train_id
    opt_over = {}
    if getattr(args, "lr", None):
        opt_over["learning_rate"] = args.lr
    if getattr(args, "schedule", None):
        opt_over["schedule"] = args.schedule
    if opt_over:
        over["optimizer"] = dataclasses.replace(cfg.optimizer, **opt_over)
    return dataclasses.replace(cfg, **over) if over else cfg


def run(cfg: TrainConfig, args, model=None, task=None, param_filter=None,
        init_params=None) -> Trainer:
    """The common --transform / --test / fit flow on ``args.device``."""
    init_distributed_from_args(args)
    cfg = resolve_normalize_stats(cfg)
    trainer = Trainer(cfg, model=model, task=task,
                      device=getattr(args, "device", "cuda"),
                      param_filter=param_filter, init_params=init_params)

    if args.transform:
        export_for_serving(cfg, trainer, args.transform)
        return trainer

    train, val, test, _ = build_loaders(cfg, trainer.out_size)
    if args.test:
        # test-only mode against the latest checkpoint
        ckpt = CheckpointManager(cfg.checkpoint, cfg.train_id)
        state = trainer.init_state(train.steps_per_epoch())
        if ckpt.latest_epoch() is None:
            # a scratch init would print a chance-level score as if it were
            # the trained model's
            raise FileNotFoundError(
                f"--test: no checkpoint for run {cfg.train_id!r} under "
                f"{cfg.checkpoint}")
        ckpt.restore(state)
        if test is None:
            if val is None:
                raise ValueError(
                    f"--test: test_dir {cfg.test_dir!r} not found and "
                    "train_split leaves no validation data to fall back on")
            print(f"--test: test_dir {cfg.test_dir!r} not found; evaluating "
                  "the VALIDATION split instead")
        result = trainer.test(test if test is not None else val)
        print(result)
        trainer.last_test_result = result  # machine-readable for tools
        return trainer

    trainer.fit(train, val, resume=(args.restore or not args.no_resume))
    return trainer
