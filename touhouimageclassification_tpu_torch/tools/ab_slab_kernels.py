"""A/B of the slab attention kernels K1 (forward) and K2 (backward) and the
patch embedding K5 between two checkouts of the repository, on one GPU:

    python -m touhouimageclassification_tpu_torch.tools.ab_slab_kernels \\
        --other <root of the other checkout> [--rounds 2]

Each measurement is a fresh process whose ``PYTHONPATH`` is one checkout's
root, so it builds and times that checkout's kernels through
``slab_attention_forward``, ``slab_attention_backward`` and
``patch_embed_forward`` (present in every version of the port since K5's
port). The processes run in turns, other, this, this, other, per round, so
that drift of the card or its host falls on both sides alike. Each prints
the median of 30 CUDA-event timings of K1 and K2 at ViT-L batch 64 (B 64, N
197, C 1024, H 16) in bf16 and in f32 (the device routes: bf16 ``mma`` or,
for K1 and K2 since their Hopper redesigns, ``wgmma``; f32 ``simt``), K1's
and K2's bf16 device time (``k1_device_ms``, ``k2_device_ms``) and the
route each side's bf16 K1 and K2 took (``k1_route``, ``k2_route``, read
from the wrapper's ``route_launches``), and of K5 at
ViT-L batch 64 (64 images of 224x224, P 16, D 1024) in bf16 and f32: around one call
(``k5_ms``, as K1 and K2) and on the device alone (``k5_device_ms``: 20
back-to-back calls behind a spin kernel, median of 10; the bf16 kernel
takes less time on the device than its launch on the host); and, end to
end, one forward of a randomly initialised ViT-L (``'fused'``, bf16) at
the serve bucket 64 under ``inference_mode``, median of 10 between CUDA
events (``vit_l_b64_forward_ms``: 24 K1 launches among its ~470). The script
prints one JSON line per process, the card and the medians of each side,
and last whether the two builds compile each kernel to the same code: the
names of the other checkout's kernels whose SASS (``cuobjdump -sass``,
instructions only) no kernel of this checkout's library repeats exactly
(a kernel whose helpers moved to a shared header, as K5's did to
``csrc/sm90.cuh``, is absent from it when its code is unchanged).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

THIS = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_CHILD = r"""
import json, statistics, torch
from touhouimageclassification_tpu_torch.ops import attention as attn
from touhouimageclassification_tpu_torch.ops._build import build_library
lib = str(build_library())
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
qkv32 = torch.randn(64, 197, 3 * 1024, generator=gen, device=dev)
g32 = torch.randn(64, 197, 1024, generator=gen, device=dev)
qkv, g = qkv32.to(torch.bfloat16), g32.to(torch.bfloat16)

def ms(fn, warmup=5, reps=30, calls=1):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if calls > 1:
            torch.cuda._sleep(10_000_000)
        a.record()
        for _ in range(calls):
            fn()
        b.record(); b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)

from touhouimageclassification_tpu_torch.ops import patch_embed as pe
img32 = torch.randn(64, 224, 224, 3, generator=gen, device=dev)
w32 = 0.02 * torch.randn(1024, 768, generator=gen, device=dev)
b32 = 0.02 * torch.randn(1024, generator=gen, device=dev)
img, w, bias = (x.to(torch.bfloat16) for x in (img32, w32, b32))
k5 = lambda: pe.patch_embed_forward(img, w, bias, 16)
k5_32 = lambda: pe.patch_embed_forward(img32, w32, b32, 16)

def route(fn):
    before = dict(attn.route_launches)
    fn()
    torch.cuda.synchronize()
    return [r for r in before if attn.route_launches[r] != before[r]]

k1_route = route(lambda: attn.slab_attention_forward(qkv, 16))
k2_route = route(lambda: attn.slab_attention_backward(qkv, g, 16))
from touhouimageclassification_tpu_torch.models import create_model
vit = create_model("vit-large", num_classes=120, device=dev).eval()
images = torch.randn(64, 224, 224, 3, generator=gen, device=dev)
with torch.inference_mode():
    vit_ms = ms(lambda: vit(images), warmup=3, reps=10)
del vit

print(json.dumps({
    "k1_route": k1_route, "k2_route": k2_route,
    "vit_l_b64_forward_ms": vit_ms,
    "k1_ms": ms(lambda: attn.slab_attention_forward(qkv, 16)),
    "k1_device_ms": ms(lambda: attn.slab_attention_forward(qkv, 16), reps=10,
                       calls=20),
    "k2_ms": ms(lambda: attn.slab_attention_backward(qkv, g, 16)),
    "k2_device_ms": ms(lambda: attn.slab_attention_backward(qkv, g, 16),
                       reps=10, calls=20),
    "k1_f32_ms": ms(lambda: attn.slab_attention_forward(qkv32, 16)),
    "k2_f32_ms": ms(lambda: attn.slab_attention_backward(qkv32, g32, 16)),
    "k5_ms": ms(k5), "k5_device_ms": ms(k5, reps=10, calls=20),
    "k5_f32_ms": ms(k5_32), "k5_f32_device_ms": ms(k5_32, reps=10, calls=20),
    "lib": lib}))
"""


def measure(root: str) -> dict:
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=root, env=env,
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def sass(lib: str) -> dict:
    """Each kernel of the library ``lib`` by mangled name: its SASS
    instructions (the lines that end in ``;``, without addresses and
    encodings), less the NOPs that pad its end (their number follows the
    kernel's place in the library, not its code)."""
    from ..ops._build import find_nvcc

    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", out)
    kernels = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        lines = (re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "",
                        line).strip() for line in body.splitlines())
        code = [x for x in lines if x.endswith(";")]
        while code and code[-1].startswith("NOP"):
            code.pop()
        kernels[name] = tuple(code)
    return kernels


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
                             for k in rs[0]
                             if k not in ("lib", "k1_route", "k2_route")}
                      for side, rs in runs.items()}))
    print(json.dumps({key: {side: rs[0].get(key) for side, rs in runs.items()}
                      for key in ("k1_route", "k2_route")}))
    here = set(sass(runs["this"][0]["lib"]).values())
    other = sass(runs["other"][0]["lib"])
    print(json.dumps({"other_kernels": len(other), "without_same_sass_here": [
        name for name, body in other.items() if body not in here]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
