"""TreeViT staged-curriculum training (counterpart of the JAX package's
``train/treevit.py``, the ``TIC.TreeViT.train`` equivalent).

``python -m touhouimageclassification_tpu_torch.train.treevit --data-dir
<dir> --device cuda [--stage all|root|sons|full] [--tiny | --small]``

The reference's flow (``TIC/TreeViT/train.py:139-179``) with the JAX
package's repairs: stage ``root`` trains only the root (SCE on category
labels), ``sons`` the sons, teacher-routed to their own categories in one
step, ``full`` everything end to end. Each stage starts from the previous
stage's parameters; an explicit ``--restore`` seeds only the first.

The category map is ``category.csv`` (columns ``class,category``,
``load_map_dict``); without one the sorted classes are cut into
``--num-categories`` contiguous categories (the reference ships none).
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import os

import numpy as np

from ..config import PRESETS, TreeViTConfig, ViTConfig
from ..data.folder import scan_image_folder
from ..device import resolve_device
from ..models.treevit import TreeViT
from .cli import (SMALL_VIT_DIMS, TINY_VIT_DIMS, apply_overrides,
                  init_distributed_from_args, run, standard_argparser)
from .ntrain import add_size_flags
from .tasks import TreeFullTask, TreeRootTask, TreeSonsTask


def load_map_dict(filename: str) -> dict[str, str]:
    """class name -> category name (``train.py:80-89``)."""
    with open(filename) as f:
        return {row["class"]: row["category"] for row in csv.DictReader(f)}


def make_class_to_category(
    map_dict: dict[str, str], class_to_idx: dict[str, int]
) -> np.ndarray:
    """int class idx -> int category idx; categories indexed by sorted name
    (the sklearn LabelEncoder equivalence, ``train.py:71-74,91-95``)."""
    categories = sorted(set(map_dict.values()))
    cat_to_idx = {c: i for i, c in enumerate(categories)}
    arr = np.zeros(len(class_to_idx), np.int32)
    for cls, idx in class_to_idx.items():
        arr[idx] = cat_to_idx[map_dict[cls]]
    return arr


def default_category_map(classes: list[str], num_categories: int) -> dict[str, str]:
    """Contiguous partition of sorted classes into N categories."""
    per = -(-len(classes) // num_categories)
    return {
        c: f"category_{i // per:02d}" for i, c in enumerate(sorted(classes))
    }


def _mask_for_stage(stage: str):
    """The stage's ``param_filter`` over a parameter's dotted name parts
    (None: everything trains)."""
    if stage == "root":
        return lambda path: "root" in path
    if stage == "sons":
        return lambda path: "sons" in path
    return None


def main(argv=None):
    parser = standard_argparser("Train TreeViT with the staged curriculum")
    parser.add_argument("--stage", type=str, default="all",
                        choices=["root", "sons", "full", "all"])
    parser.add_argument("--map-file", type=str, default=None)
    parser.add_argument("--num-categories", type=int, default=8)
    parser.add_argument("--top-k", type=int, default=2)
    add_size_flags(parser)
    args = parser.parse_args(argv)
    init_distributed_from_args(args)

    base_cfg = apply_overrides(PRESETS["treevit"], args)
    index = scan_image_folder(base_cfg.data_dir)
    map_file = args.map_file or TreeViTConfig().map_file
    if map_file and os.path.exists(map_file):
        map_dict = load_map_dict(map_file)
    else:
        map_dict = default_category_map(index.classes, args.num_categories)
    class_to_category = make_class_to_category(map_dict, index.class_to_idx)
    num_categories = int(class_to_category.max()) + 1

    node_vit = None
    if args.tiny:
        node_vit = ViTConfig(**TINY_VIT_DIMS)
    elif args.small:
        node_vit = ViTConfig(**SMALL_VIT_DIMS)
    tree_cfg = TreeViTConfig(num_categories=num_categories,
                             num_classes=len(index.classes), top_k=args.top_k,
                             vit=node_vit)
    model = TreeViT(tree_cfg, compute_dtype=base_cfg.compute_dtype,
                    param_dtype="float32", device=resolve_device(args.device),
                    seed=base_cfg.seed)

    stages = ["root", "sons", "full"] if args.stage == "all" else [args.stage]
    task_cls = {"root": TreeRootTask, "sons": TreeSonsTask,
                "full": TreeFullTask}
    prev_params = None
    for i, stage in enumerate(stages):
        cfg = dataclasses.replace(base_cfg,
                                  train_id=f"{base_cfg.train_id}_{stage}")
        stage_args = args
        if i > 0 and args.restore:
            # an explicit --restore seeds only the first stage: restoring it
            # again would train stages 2+ from the wrong parameters
            stage_args = argparse.Namespace(**vars(args))
            stage_args.restore = None
        print(f"=== TreeViT stage: {stage} ===")
        trainer = run(cfg, stage_args, model=model,
                      task=task_cls[stage](tree_cfg, class_to_category),
                      param_filter=_mask_for_stage(stage),
                      init_params=prev_params)
        if trainer.state is not None:
            # the stages share one model: the next stage's init_state loads
            # these (its live tensors) back, as JAX hands params along
            prev_params = trainer.state.model.state_dict()
    return trainer


if __name__ == "__main__":
    main()
