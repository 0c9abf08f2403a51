"""Main-result ViT training (counterpart of the JAX package's
``train/ntrain.py``, the ``TIC.ViT.ntrain`` equivalent).

``python -m touhouimageclassification_tpu_torch.train.ntrain [--preset nvit]
--data-dir <dir> --device cuda``

Presets map one-to-one to the reference launchers (``TIC/ViT/ntrain*.py``):
nvit (main result: ViT-Large, filtered data, full augmentation +
CutMix/MixUp, LR 1e-5, wd 0.01, 20 epochs) and its ablations; see
``config.PRESETS``. The model starts from the local pretrained backbone
(``utils/pretrained.py``) or, without one or with ``--no-pretrained``, from
the seeded scratch initialisation.
"""
from __future__ import annotations

import dataclasses

from ..config import PRESETS, vit_config
from ..device import resolve_device
from ..models.vit import ViT
from ..utils.pretrained import load_pretrained_backbone
from .cli import (SMALL_VIT_DIMS, TINY_VIT_DIMS, apply_overrides,
                  init_distributed_from_args, dataset_num_classes, run,
                  standard_argparser)


def add_size_flags(parser) -> None:
    parser.add_argument("--tiny", action="store_true",
                        help="tiny ViT dims (CI/CPU smoke runs)")
    parser.add_argument("--small", action="store_true",
                        help="DeiT-Tiny-class dims at the full 224 input")


def build_vit(cfg, args, remat: bool = False) -> tuple[ViT, dict | None]:
    """The run's ViT (f32 parameters, ``cfg.compute_dtype`` compute, on
    ``args.device``, initialised from ``cfg.seed``) for the data's class
    count, and the pretrained backbone to load into it, if any."""
    device = resolve_device(args.device)
    vcfg = vit_config(cfg.model_type, num_classes=dataset_num_classes(cfg))
    if args.tiny:
        vcfg = dataclasses.replace(vcfg, **TINY_VIT_DIMS)
    elif args.small:
        vcfg = dataclasses.replace(vcfg, **SMALL_VIT_DIMS)
    if remat:
        vcfg = dataclasses.replace(vcfg, remat=True)
    model = ViT(vcfg, compute_dtype=cfg.compute_dtype, param_dtype="float32",
                device=device, seed=cfg.seed)
    init_params = None
    if cfg.pretrained and not args.no_pretrained:
        init_params = load_pretrained_backbone(cfg.model_type,
                                               vcfg.num_classes)
    return model, init_params


def main(argv=None, preset: str = "nvit"):
    parser = standard_argparser("Train ViT with the ntrain recipe")
    parser.add_argument("--preset", type=str, default=preset,
                        choices=[k for k in PRESETS if k.startswith("nvit")])
    parser.add_argument("--no-pretrained", action="store_true",
                        help="scratch init instead of pretrained backbone")
    parser.add_argument("--remat", action="store_true",
                        help="rematerialize encoder layers (larger batches)")
    parser.add_argument("--freeze-backbone", action="store_true",
                        help="train the classifier head only "
                             "(full_finetune=False, ntrain.py:34-36)")
    add_size_flags(parser)
    args = parser.parse_args(argv)
    init_distributed_from_args(args)

    cfg = apply_overrides(PRESETS[args.preset], args)
    if args.freeze_backbone:
        cfg = dataclasses.replace(cfg, full_finetune=False)
    model, init_params = build_vit(cfg, args, remat=args.remat)
    return run(cfg, args, model=model, init_params=init_params)


if __name__ == "__main__":
    main()
