"""Hand-rolled-style ViT finetune (counterpart of the JAX package's
``train/finetune.py``, the ``TIC.ViT.finetune`` equivalent).

Reference recipe (``TIC/ViT/finetune.py:271-342``): ViT-Base on unfiltered
data, AdamW LR 1e-5 wd 0.01, per-step linear warmup (500 steps), batch 30,
up to 40 epochs, val-loss window early exit, per-epoch checkpoints with
auto-resume. This produces the dataset-filter judge model. The Trainer
supplies the loop; this module wires the preset and the warmup schedule's
horizon.
"""
from __future__ import annotations

import dataclasses

from ..config import PRESETS
from ..data import scan_image_folder
from .cli import apply_overrides, init_distributed_from_args, run, standard_argparser
from .ntrain import add_size_flags, build_vit


def main(argv=None, preset: str = "finetune_vit_base"):
    parser = standard_argparser("ViT finetune (hand-rolled recipe)")
    parser.add_argument("--no-pretrained", action="store_true")
    add_size_flags(parser)
    args = parser.parse_args(argv)
    init_distributed_from_args(args)

    cfg = apply_overrides(PRESETS[preset], args)
    model, init_params = build_vit(cfg, args)
    if cfg.optimizer.schedule == "warmup_linear" and not args.transform:
        # warmup_linear needs the horizon (transformers
        # get_linear_schedule_with_warmup analogue, finetune.py:318-328)
        n = len(scan_image_folder(cfg.data_dir))
        steps = int(n * cfg.train_split) // cfg.global_batch_size
        cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(
            cfg.optimizer, total_steps=steps * cfg.max_epochs))
    return run(cfg, args, model=model, init_params=init_params)


if __name__ == "__main__":
    main()
