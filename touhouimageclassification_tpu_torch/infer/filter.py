"""Dataset self-filtering: keep only images the judge model gets right
(counterpart of the JAX package's ``infer/filter.py``).

Consumes a ``full_judge`` CSV (schema
``filename,predicted_class,confidence,actual_class,correct,path``) and
builds an ImageFolder tree of the rows whose prediction matches the label,
the stage that produced ``data/data_filtered_vit_base`` (the reference's
``TIC/utils/filter.py:8-55``). With ``--model`` the port's judge
(``infer/serve.py``) runs first, on ``--device`` (``cuda`` by default;
CUDA without a GPU raises). The same CSV schema, report, tree and flags as
the JAX package's; ``--dp > 1`` is not ported.

CLI: ``python -m touhouimageclassification_tpu_torch.infer.filter --model
vit-large --weights <ckpt> --image <dataset> -od <filtered>``
"""
from __future__ import annotations

import csv
import os
import shutil
from collections import defaultdict
from dataclasses import dataclass


@dataclass(frozen=True)
class FilterReport:
    total: int
    kept: int

    @property
    def keep_rate(self) -> float:
        return self.kept / self.total if self.total else 0.0


def _kept_rows(csv_file: str) -> tuple[dict[str, list[str]], int]:
    """(label -> source paths of correctly-predicted rows, total rows)."""
    by_label: dict[str, list[str]] = defaultdict(list)
    total = 0
    with open(csv_file, newline="") as f:
        for row in csv.DictReader(f):
            total += 1
            label = row["actual_class"].strip()
            if row["predicted_class"].strip() == label:
                by_label[label].append(row["path"].strip())
    return by_label, total


def filter(csv_file: str, output_directory: str) -> tuple[int, int]:
    """Build ``<output_directory>/<label>/`` from the judge CSV's correct
    rows. Returns ``(total_rows, kept_rows)``."""
    by_label, total = _kept_rows(csv_file)
    kept = 0
    for label, paths in sorted(by_label.items()):
        dest_dir = os.path.join(output_directory, label)
        os.makedirs(dest_dir, exist_ok=True)
        for src in paths:
            shutil.copy(src, os.path.join(dest_dir, os.path.basename(src)))
            kept += 1
    report = FilterReport(total=total, kept=kept)
    print(
        f"kept {report.kept}/{report.total} images "
        f"({report.keep_rate:.1%}) -> {output_directory}"
    )
    return report.total, report.kept


def main(argv=None):
    import argparse

    from . import serve as serve_mod

    parser = argparse.ArgumentParser(
        description="Build a filtered ImageFolder from a judge CSV "
                    "(optionally running the judge first)."
    )
    parser.add_argument("--csv-file", type=str, default=None,
                        help="Existing full_judge CSV to filter from.")
    parser.add_argument("--output-directory", "-od", type=str, required=True,
                        help="Root of the filtered ImageFolder to create.")
    parser.add_argument("--model", type=str, default=None,
                        choices=serve_mod.MODEL_CHOICES,
                        help="Run this judge over --image before filtering.")
    parser.add_argument("--weights", type=str, default=None)
    parser.add_argument("--image", type=str, default=None,
                        help="Dataset folder the judge scores (with --model).")
    parser.add_argument("--dp", type=int, default=0,
                        help="shard judge batches over this many devices "
                             "(0/1 = single device; more is not ported yet)")
    parser.add_argument("--canvas-cache", choices=["auto", "on", "off"],
                        default="auto",
                        help="reuse (auto) or build (on) the dataset's "
                             "decoded-canvas cache for the judge pass")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the judge: cuda (default) or "
                             "cpu")
    args = parser.parse_args(argv)

    if args.model is None:
        if not args.csv_file:
            raise SystemExit("Provide --csv-file, or --model to run the judge")
        filter(args.csv_file, args.output_directory)
        return

    if not args.image:
        raise SystemExit("--image is required with --model")
    judge_csv = args.csv_file or "filter_temp.csv"
    predictor = serve_mod.init(args, data_dir=args.image)
    serve_mod.full_judge(predictor, args.image, judge_csv,
                         canvas_cache=args.canvas_cache)
    try:
        filter(judge_csv, args.output_directory)
    finally:
        # exists-guard: a filter() failure must surface, not be masked by a
        # FileNotFoundError from removing a temp CSV that was never written
        if not args.csv_file and os.path.exists(judge_csv):
            os.remove(judge_csv)


if __name__ == "__main__":
    main()
