"""The control of a cell's correctness check: the plain reference put in
the program's place, computed one precision below the configuration's
bfloat16 (float8 e4m3, ``reference/vit_plain.py``), on the cell's own
inputs at its own size. It has to come out as not correct.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13

prints one JSON line a seed with the numbers the cell compares, their
limits and whether the control fails them. Training: three steps of the
float8 reference against three of the float32 one. Serving: for each
image the class the float8 forward puts first and its confidence, judged
against the float32 logits as the cell judges the program's answers.
With ``--fault half_batch`` (training cells) a fault takes the float8
control's place: the float32 reference whose loss is the mean over the
first half of the batch only.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
for _p in (str(BENCH_DIR), str(BENCH_DIR.parent)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import harness  # noqa: E402
from compare import (leaf_norm_gap, moved_leaves, relative_gap,  # noqa: E402
                     served_gaps)
from reference.serve_plain import (decode_canvas, pil_canvas,  # noqa: E402
                                   serve_logits)
from reference.train_plain import train_steps  # noqa: E402
from weights import make_weights, vit_shape  # noqa: E402


def train_numbers(cell, seed: int, device, fault: str = "") -> dict:
    p = cell.params
    shape = vit_shape(cell.config)
    pool = harness.driver_module("train_step").make_pool(
        p, shape["classes"], seed, device)
    batches = [(torch.from_numpy(b["image"]).to(device),
                torch.from_numpy(b["label"]).to(device))
               for b in pool[:p["check_steps"]]]
    w0 = make_weights(shape, seed, device)
    ref = train_steps(w0, shape, seed, batches, 1e-5, 0.01, "fp32",
                      block=p["ref_block"])
    if fault == "half_batch":
        low = train_steps(w0, shape, seed, batches, 1e-5, 0.01, "fp32",
                          block=p["ref_block"], loss_rows=p["batch"] // 2)
    else:
        low = train_steps(w0, shape, seed, batches, 1e-5, 0.01, "fp8",
                          block=p["ref_block"])
    return {"loss_rel_gap": relative_gap(low["loss"], ref["loss"]),
            "grad1_leaf_gap": leaf_norm_gap(low["grad1"], ref["grad1"])[0],
            "change_leaf_gap": leaf_norm_gap(
                low["delta"], ref["delta"], moved_leaves(ref["grad1"]))[0]}


def serve_numbers(cell, seed: int, device, scratch: Path) -> dict:
    p = cell.params
    shape = vit_shape(cell.config)
    rng = np.random.default_rng([seed, 3])
    if cell.driver == "judge_sweep":
        from images import write_folder
        from programs import class_names
        paths = write_folder(str(scratch / "judge_data"), p["images"],
                             class_names(shape["classes"]), p["side_min"],
                             p["side_max"], p["quality"], seed)
        picks = rng.choice(len(paths), p["check_images"], replace=False)
        canvases = np.stack([decode_canvas(paths[i], (256, 256))
                             for i in picks])
        decimals = 4   # the judge's CSV writes 4 decimals
    else:
        from images import make_pictures
        pool = make_pictures(p["pool_images"], p["side_min"], p["side_max"],
                             seed, p["schedule_seed"])
        size = (shape["image"], shape["image"])
        picks = rng.integers(0, len(pool), p["check_images"])
        canvases = np.stack([pil_canvas(pool[i], size) for i in picks])
        decimals = None
    w0 = make_weights(shape, seed, device)
    ref = serve_logits(w0, shape, canvases, device)
    low = serve_logits(w0, shape, canvases, device, precision="fp8")
    conf, served = torch.softmax(low, dim=-1).max(dim=-1)
    if decimals is not None:
        conf = torch.round(conf, decimals=decimals)
    gap, err = served_gaps(ref, served, conf)
    return {"logit_gap": gap, "confidence_gap": err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=("", "half_batch"), default="",
                    help="training cells: the float32 reference with this "
                         "fault planted in the float8 control's place")
    args = ap.parse_args(argv)
    cell = harness.resolve_cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        scratch = harness.scratch_dir(cell.name + "_control")
        if cell.driver == "train_step":
            numbers = train_numbers(cell, seed, device, args.fault)
        else:
            numbers = serve_numbers(cell, seed, device, scratch)
        fails = not harness.verdict([(k, v, cell.limits[k])
                                     for k, v in numbers.items()])
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "fault": args.fault,
                          "numbers": numbers, "limits": cell.limits,
                          "control_fails": fails,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
