"""ResMoE training (counterpart of the JAX package's ``train/resmoe.py``,
the ``TIC.ResMoE.train`` equivalent).

``python -m touhouimageclassification_tpu_torch.train.resmoe --data-dir
<dir> --device cuda [--routing sparse] [--tiny | --small]``

The reference recipe (the ``resmoe`` preset, ``TIC/ResMoE/train.py`` +
``parameter.py``): 8 ViT-Base experts and a top-2 ViT-Base gate from the
seeded scratch initialisation, SGD 5e-2, batch 4 x grad-accum 4, 10 epochs
of at most 500/100 train/val batches, symmetric CE + 0.5 x the balance
penalty. ``--routing sparse`` dispatches by capacity. ``--expert-shards
S`` splits the experts over S ranks of a multi-process run (expert
parallelism, ``parallel/``; the other axis is data parallel).
"""
from __future__ import annotations

import dataclasses

from ..config import PRESETS, MeshConfig, MoEConfig, ViTConfig
from ..device import resolve_device
from ..models.resmoe import MoEClassifier
from .cli import (SMALL_VIT_DIMS, TINY_VIT_DIMS, apply_overrides,
                  init_distributed_from_args, dataset_num_classes, run,
                  standard_argparser)
from .ntrain import add_size_flags
from .tasks import MoETask


def main(argv=None):
    parser = standard_argparser("Train the ResMoE mixture of ViT experts")
    parser.add_argument("--routing", type=str, default="dense",
                        choices=["dense", "sparse"])
    parser.add_argument("--dispatch-level", type=str, default="feature",
                        choices=["feature", "image"],
                        help="sparse-mode granularity: gather routed token "
                             "sequences after per-expert patch embed "
                             "(feature) or gather raw images (image)")
    parser.add_argument("--num-experts", type=int, default=8)
    parser.add_argument("--top-k", type=int, default=2)
    parser.add_argument("--expert-shards", type=int, default=1,
                        help="shard experts over this many devices (EP)")
    parser.add_argument("--balance-loss", type=str, default="quadratic",
                        choices=["quadratic", "switch"],
                        help="gate balance penalty: reference quadratic "
                             "usage penalty, or the Switch-Transformer aux "
                             "loss")
    parser.add_argument("--balance-alpha", type=float, default=None,
                        help="balance-loss mix weight (default: preset's "
                             "0.5)")
    parser.add_argument("--gateway-t", type=float, default=None,
                        help="training-time gate logit noise scale "
                             "(reference default 0.01)")
    add_size_flags(parser)
    args = parser.parse_args(argv)
    init_distributed_from_args(args)

    cfg = dataclasses.replace(
        apply_overrides(PRESETS["resmoe"], args),
        mesh=MeshConfig(num_expert_shards=args.expert_shards))
    expert_vit = None
    if args.tiny:
        expert_vit = ViTConfig(**TINY_VIT_DIMS)
    elif args.small:
        expert_vit = ViTConfig(**SMALL_VIT_DIMS)
    moe_cfg = MoEConfig(num_experts=args.num_experts, top_k=args.top_k,
                        routing=args.routing,
                        dispatch_level=args.dispatch_level,
                        expert_vit=expert_vit,
                        balance_loss=args.balance_loss,
                        num_classes=dataset_num_classes(cfg))
    if args.balance_alpha is not None:
        moe_cfg = dataclasses.replace(moe_cfg,
                                      balance_loss_alpha=args.balance_alpha)
    if args.gateway_t is not None:
        moe_cfg = dataclasses.replace(moe_cfg, gateway_t=args.gateway_t)
    model = MoEClassifier(moe_cfg, compute_dtype=cfg.compute_dtype,
                          param_dtype="float32",
                          device=resolve_device(args.device), seed=cfg.seed)
    return run(cfg, args, model=model, task=MoETask(moe_cfg))


if __name__ == "__main__":
    main()
