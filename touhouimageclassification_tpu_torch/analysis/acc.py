"""Multi-checkpoint accuracy sweep (counterpart of the JAX package's
``analysis/acc.py``).

The same pinned table of named checkpoints (:data:`MODELS`), a judge CSV
per model cached under ``result/<name>.csv`` and the aggregate
``result/acc.csv`` (``name,acc,status``). A row whose checkpoint is missing
is recorded as ``missing_checkpoint`` and the sweep goes on; every family
of the table (ViT, ResNet, ResMoE) loads through ``infer.serve.init``.
Each model is judged by
the port's ``full_judge`` on ``--device`` (``cuda`` by default), in
process, and dropped before the next.

CLI: ``python -m touhouimageclassification_tpu_torch.analysis.acc
[--recompute] [--device cuda]``
"""
from __future__ import annotations

import csv
import os

from ..config import RESULT_DIR, TEST_DIR

# (model_name, model_type, checkpoint): the JAX package's table
MODELS: list[tuple[str, str, str]] = [
    ("ResNet", "resnet", "checkpoint/serving/resnet152"),
    ("ResMoE", "resmoe", "checkpoint/serving/resmoe"),
    ("ViT_base", "vit-base", "checkpoint/serving/vit_base_finetune"),
    ("ViT_large", "vit-large", "checkpoint/serving/vit_large_finetune"),
    ("ViT_large_filtered", "vit-large", "checkpoint/serving/vit_large_filtered"),
    ("ViT_large_filtered_full_mixed", "vit-large", "checkpoint/serving/nvit"),
    ("ViT_large_filtered_grey_mixed", "vit-large", "checkpoint/serving/nvit_grey"),
    ("ViT_large_filtered_grey", "vit-large", "checkpoint/serving/nvit_grey_unmix"),
    ("ViT_large_full_mixed", "vit-large", "checkpoint/serving/nvit_unfiltered"),
    ("ViT_large_n", "vit-large", "checkpoint/serving/nvit_unfiltered_unaug"),
    ("ViT_large_full", "vit-large", "checkpoint/serving/nvit_unfiltered_unmix"),
]


def get_acc(name: str, result_dir: str = RESULT_DIR) -> dict:
    path = os.path.join(result_dir, f"{name}.csv")
    total = correct = 0
    with open(path) as f:
        for row in csv.DictReader(f):
            total += 1
            correct += row["correct"].strip() == "True"
    return {"name": name, "acc": correct / total if total else 0.0}


def run_sweep(
    models=None,
    test_dir: str = TEST_DIR,
    result_dir: str = RESULT_DIR,
    recompute: bool = False,
    data_dir: str | None = None,
    dp: int = 0,
    canvas_cache: str = "on",
    device: str = "cuda",
) -> list[dict]:
    from ..infer import serve as serve_mod

    if dp > 1:
        raise NotImplementedError(
            "--dp > 1 needs multi-GPU serving, not ported yet "
            "(ROADMAP.md queue 1, item 12)")
    models = models if models is not None else MODELS
    os.makedirs(result_dir, exist_ok=True)
    rows: list[dict] = []
    for name, mtype, checkpoint in models:
        out_csv = os.path.join(result_dir, f"{name}.csv")
        if recompute or not os.path.exists(out_csv):
            # a missing artifact skips its row (recorded), not the sweep
            if not os.path.exists(checkpoint):
                print(f"{name}: checkpoint missing ({checkpoint}) — skipped")
                rows.append({"name": name, "acc": "",
                             "status": "missing_checkpoint"})
                continue
            predictor = serve_mod.init(
                modelt=mtype, weights=checkpoint,
                data_dir=data_dir or serve_mod.FILTERED_DATA_DIR,
                device=device)
            # one test set scored by every model: the first judge fills the
            # decoded-canvas cache, the others stream it
            serve_mod.full_judge(predictor, test_dir, out_csv,
                                 canvas_cache=canvas_cache)
            del predictor
        rows.append({**get_acc(name, result_dir), "status": "ok"})
    with open(os.path.join(result_dir, "acc.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["name", "acc", "status"])
        writer.writeheader()
        writer.writerows(rows)
    return rows


def main(argv=None) -> list[dict]:
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--recompute", "-r", action="store_true")
    parser.add_argument("--dp", type=int, default=0,
                        help="shard judging over this many devices (more "
                             "than 1 is not ported yet)")
    parser.add_argument("--canvas-cache", choices=["auto", "on", "off"],
                        default="on",
                        help="build/reuse the test set's decoded-canvas "
                             "cache across the sweep (default on: decode "
                             "once, stream the rest)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)
    rows = run_sweep(recompute=args.recompute, dp=args.dp,
                     canvas_cache=args.canvas_cache, device=args.device)
    for row in rows:
        if row.get("status") == "missing_checkpoint":
            print(f"{row['name']}: (checkpoint missing)")
        else:
            print(f"{row['name']}: {row['acc']:.4f}")
    return rows


if __name__ == "__main__":
    main()
