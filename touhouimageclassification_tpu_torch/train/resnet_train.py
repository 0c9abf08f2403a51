"""ResNet training (counterpart of the JAX package's
``train/resnet_train.py``, the ``TIC.ResNet.train`` equivalent).

``python -m touhouimageclassification_tpu_torch.train.resnet_train
--data-dir <dir> --device cuda [--depth 152]``

The ``resnet152`` preset (``TIC/ResNet/train.py:213-241``): from-scratch
ResNet (the seeded flax initialisation), SGD LR 5e-2 with the ``step``
schedule (StepLR(5 epochs, 0.25)), batch 80, 25 epochs, 256x256 inputs
normalised by the dataset's statistics, per-epoch checkpoints with resume.
``--bn-variant`` takes only ``flax``: the JAX package's BN-cost variants
are not ported (ROADMAP.md "Not ported").
"""
from __future__ import annotations

from ..config import PRESETS
from ..device import resolve_device
from ..models.resnet import BN_VARIANTS, resnet
from .cli import (apply_overrides, check_single_process, dataset_num_classes,
                  run, standard_argparser)


def main(argv=None):
    parser = standard_argparser("Train ResNet-152 from scratch")
    parser.add_argument("--depth", type=int, default=152,
                        choices=[18, 34, 50, 101, 152])
    parser.add_argument("--bn-variant", default="flax", choices=BN_VARIANTS,
                        help="BatchNorm statistics: 'flax' (nn.BatchNorm; "
                             "the only one ported)")
    args = parser.parse_args(argv)
    check_single_process(args)
    cfg = apply_overrides(PRESETS["resnet152"], args)
    model = resnet(args.depth, num_classes=dataset_num_classes(cfg),
                   compute_dtype=cfg.compute_dtype, param_dtype="float32",
                   device=resolve_device(args.device), seed=cfg.seed,
                   bn_variant=args.bn_variant)
    return run(cfg, args, model=model)


if __name__ == "__main__":
    main()
