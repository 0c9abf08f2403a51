"""The control and the planted faults of the V-MoE cell and of the loader
cell, as ``control.py`` makes them for the other cells: the plain
reference with a fault, or one precision below the configuration's
bfloat16 (float8 e4m3), against the float32 reference, on the cell's own
inputs at its own size. Each has to come out as not correct.

    python3 benchmark/control_train.py --workload <cell> --seeds 11 12 \\
        --faults fp8 capacity_half k1 no_noise half_batch

prints one JSON line a seed and fault with the numbers the cell compares,
their limits and whether they fail them. Faults: ``fp8`` (the control),
``half_batch`` (the loss over the first half of the batch only) and, for
V-MoE, ``capacity_half`` (half the capacity factor), ``k1`` (one expert a
token), ``no_noise`` (no router noise). The loader cell's reference reads
the folder the cell writes, so its ``canvas_gap`` is the reference's
against itself: 0.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
for _p in (str(BENCH_DIR), str(BENCH_DIR.parent)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

import harness  # noqa: E402
from compare import leaf_norm_gap, moved_leaves, relative_gap  # noqa: E402

FAULTS = ("fp8", "half_batch", "capacity_half", "k1", "no_noise")


def _gaps(low: dict, ref: dict, moe: bool) -> dict:
    out = {"loss_rel_gap": relative_gap(low["loss"], ref["loss"]),
           "grad1_leaf_gap": leaf_norm_gap(low["grad1"], ref["grad1"])[0],
           "change_leaf_gap": leaf_norm_gap(
               low["delta"], ref["delta"], moved_leaves(ref["grad1"]))[0]}
    if moe:
        from reference.train_moe_plain import route_flip_share
        out["route_flip_share"] = route_flip_share(low["routes"],
                                                   ref["routes"])
    return out


def moe_numbers(cell, seed: int, device, faults) -> dict:
    from moe_weights import make_vmoe_weights, moe_spec, vmoe_shape
    from reference.train_moe_plain import train_steps
    p = cell.params
    shape = vmoe_shape(cell.config)
    pool = harness.driver_module("train_step").make_pool(
        p, shape["classes"], seed, device)
    batches = [(torch.from_numpy(b["image"]).to(device),
                torch.from_numpy(b["label"]).to(device))
               for b in pool[:p["check_steps"]]]
    w0 = make_vmoe_weights(shape, seed, device)
    spec = moe_spec(shape)

    def steps(precision="fp32", loss_rows=None, **change):
        out = train_steps(w0, shape, dict(spec, **change), seed, batches,
                          1e-5, 0.01, precision, loss_rows=loss_rows)
        gc.collect()
        torch.cuda.empty_cache()
        return out

    ref = steps()
    made = {"fp8": lambda: steps("fp8"),
            "half_batch": lambda: steps(loss_rows=p["batch"] // 2),
            "capacity_half": lambda: steps(
                capacity_factor=spec["capacity_factor"] / 2),
            "k1": lambda: steps(top_k=1),
            "no_noise": lambda: steps(noise_std=0.0)}
    return {f: _gaps(made[f](), ref, True) for f in faults}


def loader_numbers(cell, seed: int, device, faults, scratch: Path) -> dict:
    from images import write_folder
    from programs import class_names
    from reference.train_plain import train_steps
    from weights import make_weights, vit_shape
    loader = harness.driver_module("train_loader")
    p = cell.params
    shape = vit_shape(cell.config)
    root = str(scratch / "train_data")
    write_folder(root, p["images"], class_names(shape["classes"]),
                 p["side_min"], p["side_max"], p["quality"], seed)
    canvas = (p["canvas"], p["canvas"])
    ref_batches = loader.reference_batches(root, seed, p["batch"],
                                           p["check_steps"], canvas)
    batches = [(torch.from_numpy(b["image"]).to(device),
                torch.from_numpy(b["label"]).to(device)) for b in ref_batches]
    w0 = make_weights(shape, seed, device)
    ref = train_steps(w0, shape, seed, batches, 1e-5, 0.01, "fp32",
                      block=p["ref_block"])
    out = {}
    for f in faults:
        low = train_steps(w0, shape, seed, batches, 1e-5, 0.01,
                          "fp8" if f == "fp8" else "fp32",
                          block=p["ref_block"],
                          loss_rows=p["batch"] // 2 if f == "half_batch"
                          else None)
        out[f] = dict(_gaps(low, ref, False), canvas_gap=0.0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="+", choices=FAULTS, default=["fp8"])
    args = ap.parse_args(argv)
    cell = harness.resolve_cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        scratch = harness.scratch_dir(cell.name + "_control")
        if cell.driver == "train_step_moe":
            numbers = moe_numbers(cell, seed, device, args.faults)
        else:
            numbers = loader_numbers(cell, seed, device,
                                     [f for f in args.faults
                                      if f in ("fp8", "half_batch")], scratch)
        for fault, got in numbers.items():
            fails = not harness.verdict([(k, v, cell.limits[k])
                                         for k, v in got.items()])
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "fault": fault, "numbers": got,
                              "limits": cell.limits, "control_fails": fails,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
