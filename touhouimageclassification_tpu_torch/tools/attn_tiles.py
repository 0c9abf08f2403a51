"""Measurements of the tile studies S1-S4 on one GPU, shared by
``bench_attn4`` (S1), ``bench_attn6`` (S2), ``bench_attn7`` (S3) and
``bench_attn8`` (S4).

Every key of a study runs on its tile (``ops/attention_study.py``:
``STUDY_TILES``; S2's keys are the softmax variants on K1's kernel) on
the (B, N, 3C) slab of ViT-L (N 197, C 1024, 16 heads of D 64) in bf16, made
from a seeded generator on the card. One record per key and batch, under the
TPU tool's own key (``block_b``, ``exp2`` and ``post_mul``, ``variant``,
``splits``):

- ``fwd_ms_per_app`` (``bwd_ms_per_app`` where the TPU study times a
  backward): device milliseconds, 20 launches back to back behind a spin
  kernel, median of 10 (``fwd_device_ms``); the TPU study's per-application
  time of a chained loop;
- ``fwd_ms``: one launch between two CUDA events, median of ``reps`` after 5
  warm-ups, the host's launch time included where it is the longer;
- ``fwd_device_ms_one_stage``: the same tile with one ring stage (three
  blocks an SM fit its shared memory, where two stages leave one), device
  time;
- the grid's blocks, the ring's stages and a block's shared memory;
- max |diff| and relative difference in norm against the plain version, and
  whether the output equals K1's (K2's) bit for bit;
- the bound (bytes: the slab, and g, read once, the output written once, at
  3.35 TB/s; the products come in under it) and the device time's share.

Per batch one ``baseline`` record: K1 and K2 (the model's launches) one
launch and device time; the tile kernels on K1's own tile
(``SHIPPED_TILE``), device time, which is what the tile machinery costs
against K1; and the plain versions' time. The library yardstick (PyTorch's
fused attention, forward and backward) is timed by ``chip_smoke.py``, as
for K1 and K2: the port's sources never call it. A tile that two keys or
studies share (S1 ``block_b`` 1 = S3 ``loop`` = S4 ``splits`` 1, S1
``block_b`` 2 = S3 ``loop-i2``, S3 ``batched`` = ``loop``) is measured once a
process and printed under every key; ``same_kernel_as`` names the study's
first key of that tile.
"""
from __future__ import annotations

import argparse
import json
import sys

from .roofline_attn import floors
from .timing import card_line, cuda_ms

N, C, HEADS = 197, 1024, 16
# The TPU tools' JSON key of each study.
KEY_NAMES = {"S1": "block_b", "S2": ("exp2", "post_mul"), "S3": "variant",
             "S4": "splits"}
_cache: dict = {}


def _once(key, make):
    if key not in _cache:
        _cache[key] = make()
    return _cache[key]


def _inputs(torch, b: int):
    def make():
        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev).manual_seed(b)
        qkv = torch.randn(b, N, 3 * C, generator=gen, device=dev).to(
            torch.bfloat16)
        g = torch.randn(b, N, C, generator=gen, device=dev).to(torch.bfloat16)
        return qkv, g

    return _once(("inputs", b), make)


def _diff(out, ref) -> dict:
    d = out.float() - ref.float()
    return {"max_abs_err": d.abs().max().item(),
            "rel_err": (d.norm() / ref.float().norm()).item()}


def baseline(b: int, reps: int) -> dict:
    """K1, K2, the tiles on K1's grid and the plain versions at batch ``b``
    (see the module docstring), with the outputs the tiles are held to."""
    import torch

    from ..ops import attention as attn
    from ..ops import attention_study as study

    def make():
        qkv, g = _inputs(torch, b)
        shipped = study.SHIPPED_TILE
        k1 = attn.slab_attention_forward(qkv, HEADS)
        k2 = attn.slab_attention_backward(qkv, g, HEADS)
        bound = floors(b)
        return {
            "outputs": (k1, k2),
            "record": {
                "batch": b, "baseline": {
                    "k1_ms": cuda_ms(torch, lambda: attn.slab_attention_forward(
                        qkv, HEADS), reps),
                    "k1_device_ms": cuda_ms(
                        torch, lambda: attn.slab_attention_forward(qkv, HEADS),
                        10, calls=20),
                    "k2_ms": cuda_ms(torch, lambda: attn.slab_attention_backward(
                        qkv, g, HEADS), reps),
                    "k2_device_ms": cuda_ms(
                        torch, lambda: attn.slab_attention_backward(
                            qkv, g, HEADS), 10, calls=20),
                    "tile_on_k1_grid_fwd_device_ms": cuda_ms(
                        torch, lambda: study.slab_attention_tile_forward(
                            qkv, HEADS, shipped), 10, calls=20),
                    "tile_on_k1_grid_bwd_device_ms": cuda_ms(
                        torch, lambda: study.slab_attention_tile_backward(
                            qkv, g, HEADS, shipped), 10, calls=20),
                    "plain_fwd_ms": cuda_ms(
                        torch, lambda: attn.slab_attention_reference(
                            qkv, HEADS), reps),
                    "plain_bwd_ms": cuda_ms(
                        torch, lambda: attn.slab_attention_backward_reference(
                            qkv, g, HEADS), reps),
                    "fwd_bound_ms": bound["fwd_bound_ms"],
                    "bwd_bound_ms": bound["bwd_bound_ms"]}}}

    return _once(("baseline", b), make)


def _timed(torch, run, reps: int, prefix: str, bound_ms: float) -> dict:
    device = cuda_ms(torch, run, 10, calls=20)
    return {f"{prefix}_ms_per_app": device, f"{prefix}_ms": cuda_ms(
        torch, run, reps), f"{prefix}_device_ms": device,
        f"{prefix}_bound_ms": bound_ms, f"{prefix}_share": bound_ms / device}


def tile_forward(tile, b: int, reps: int) -> dict:
    """The forward on ``tile`` at batch ``b`` (keys ``fwd_*``)."""
    import torch

    from ..ops import attention_study as study

    def make():
        qkv, _ = _inputs(torch, b)
        base = baseline(b, reps)
        run = lambda t=tile: study.slab_attention_tile_forward(qkv, HEADS, t)  # noqa: E731
        out = run()
        torch.cuda.synchronize()
        rec = {f"fwd_{k}": v for k, v in _diff(
            out, study.slab_attention_reference(qkv, HEADS)).items()}
        rec["fwd_bit_equal_k1"] = torch.equal(out, base["outputs"][0])
        rec.update(_timed(torch, run, reps, "fwd",
                          base["record"]["baseline"]["fwd_bound_ms"]))
        rec["fwd_plain_ms"] = base["record"]["baseline"]["plain_fwd_ms"]
        if tile.stages == 2:
            rec["fwd_device_ms_one_stage"] = cuda_ms(
                torch, lambda: run(tile._replace(stages=1)), 10, calls=20)
        return rec

    return _once(("fwd", tile, b), make)


def tile_backward(tile, b: int, reps: int) -> dict:
    """The backward (both passes) on ``tile`` at batch ``b`` (``bwd_*``)."""
    import torch

    from ..ops import attention_study as study

    def make():
        qkv, g = _inputs(torch, b)
        base = baseline(b, reps)
        run = lambda t=tile: study.slab_attention_tile_backward(  # noqa: E731
            qkv, g, HEADS, t)
        out = run()
        torch.cuda.synchronize()
        rec = {f"bwd_{k}": v for k, v in _diff(
            out, study.slab_attention_backward_reference(qkv, g, HEADS)
        ).items()}
        rec["bwd_bit_equal_k2"] = torch.equal(out, base["outputs"][1])
        rec.update(_timed(torch, run, reps, "bwd",
                          base["record"]["baseline"]["bwd_bound_ms"]))
        rec["bwd_plain_ms"] = base["record"]["baseline"]["plain_bwd_ms"]
        if tile.stages == 2:
            rec["bwd_device_ms_one_stage"] = cuda_ms(
                torch, lambda: run(tile._replace(stages=1)), 10, calls=20)
        return rec

    return _once(("bwd", tile, b), make)


def softmax_forward(variant: tuple, b: int, reps: int) -> dict:
    """An S2 variant (exp2, post_mul) at batch ``b`` (``fwd_*``)."""
    import torch

    from ..ops import attention_study as study

    def make():
        qkv, _ = _inputs(torch, b)
        base = baseline(b, reps)
        run = lambda: study.softmax_variant_forward(qkv, HEADS, *variant)  # noqa: E731
        plain = lambda: study.softmax_variant_reference(qkv, HEADS, *variant)  # noqa: E731
        out = run()
        torch.cuda.synchronize()
        rec = {f"fwd_{k}": v for k, v in _diff(out, plain()).items()}
        rec["fwd_bit_equal_k1"] = torch.equal(out, base["outputs"][0])
        rec.update(_timed(torch, run, reps, "fwd",
                          base["record"]["baseline"]["fwd_bound_ms"]))
        rec["fwd_plain_ms"] = cuda_ms(torch, plain, reps)
        return rec

    return _once(("softmax", variant, b), make)


def measure(name: str, batches=(128, 64), reps: int = 30) -> list[dict]:
    """Study ``name`` (``S1`` ... ``S4``) at each batch: its baseline record,
    then one record per key (see the module docstring)."""
    from ..ops import attention_study as study
    from ..ops.attention import kernel_smem_bytes

    keys = study.STUDY_TILES[name]
    backward = study.STUDY_BACKWARD.get(name, ())
    first = {}
    for key, tile in keys.items():
        first.setdefault(tile, key)
    results = []
    for b in batches:
        results.append({"study": name, **baseline(b, reps)["record"]})
        for key, tile in keys.items():
            key_name = KEY_NAMES[name]
            rec = {"study": name, **(dict(zip(key_name, key)) if name == "S2"
                                     else {key_name: key}), "batch": b}
            if name == "S2":
                rec.update(softmax_forward(key, b, reps))
            else:
                rec.update(tile_forward(tile, b, reps))
                if key in backward:
                    rec.update(tile_backward(tile, b, reps))
                if first[tile] != key:
                    rec["same_kernel_as"] = first[tile]
            x, y, z = study.tile_grid(tile, b, N, HEADS)
            rec.update({"tile": tile._asdict(), "blocks": x * y * z,
                        "stages": tile.stages,
                        "smem_bytes": kernel_smem_bytes(
                            "mma", False, N, C // HEADS) if name == "S2"
                        else study.tile_smem_bytes(tile, N, C // HEADS,
                                                   False)})
            if key in backward:
                rec["bwd_smem_bytes"] = study.tile_smem_bytes(
                    tile, N, C // HEADS, True)
            results.append(rec)
    return results


def main(name: str, prog: str, doc: str, argv=None) -> int:
    """The command line of study ``name``'s tool ``prog``: ``--batch``,
    ``--reps``; one JSON line per record, the card's name and power limit
    last. Exits 1 without a GPU."""
    ap = argparse.ArgumentParser(prog=prog, description=doc.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[128, 64])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print(f"{prog} needs an NVIDIA GPU", file=sys.stderr)
        return 1
    for record in measure(name, args.batch, args.reps):
        print(json.dumps(record), flush=True)
    print(card_line())
    return 0
