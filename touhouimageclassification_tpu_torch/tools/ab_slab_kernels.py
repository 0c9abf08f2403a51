"""A/B of the slab attention kernels K1 (forward) and K2 (backward) between
two checkouts of the repository, on one GPU:

    python -m touhouimageclassification_tpu_torch.tools.ab_slab_kernels \\
        --other <root of the other checkout> [--rounds 2]

Each measurement is a fresh process whose ``PYTHONPATH`` is one checkout's
root, so it builds and times that checkout's kernels through
``slab_attention_forward`` and ``slab_attention_backward`` (present in every
version of the port). The processes run in turns, other, this, this, other,
per round, so that drift of the card or its host falls on both sides alike.
Each prints the median of 30 CUDA-event timings of K1 and K2 at ViT-L batch
64 (B 64, N 197, C 1024, H 16) in bf16 and in f32 (the two device routes
since the tensor-core redesign: ``mma`` and ``simt``); the script prints one
JSON line per process and, last, the card and the medians of each side.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

THIS = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_CHILD = r"""
import json, statistics, torch
from touhouimageclassification_tpu_torch.ops import attention as attn
from touhouimageclassification_tpu_torch.ops._build import build_library
build_library()
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
qkv32 = torch.randn(64, 197, 3 * 1024, generator=gen, device=dev)
g32 = torch.randn(64, 197, 1024, generator=gen, device=dev)
qkv, g = qkv32.to(torch.bfloat16), g32.to(torch.bfloat16)

def ms(fn, warmup=5, reps=30):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)

print(json.dumps({
    "k1_ms": ms(lambda: attn.slab_attention_forward(qkv, 16)),
    "k2_ms": ms(lambda: attn.slab_attention_backward(qkv, g, 16)),
    "k1_f32_ms": ms(lambda: attn.slab_attention_forward(qkv32, 16)),
    "k2_f32_ms": ms(lambda: attn.slab_attention_backward(qkv32, g32, 16))}))
"""


def measure(root: str) -> dict:
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=root, env=env,
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout (e.g. the parent commit "
                         "unpacked with git archive)")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    sides = {"other": os.path.abspath(args.other), "this": THIS}
    runs = {"other": [], "this": []}
    for r in range(args.rounds):
        for side in ("other", "this", "this", "other"):
            got = measure(sides[side])
            runs[side].append(got)
            print(json.dumps({"round": r, "side": side, **got}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    print(json.dumps({side: {k: statistics.median(r[k] for r in rs)
                             for k in rs[0]}
                      for side, rs in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
