"""How much a background checkpoint write slows ViT-L train steps, on one GPU:

    python -m touhouimageclassification_tpu_torch.tools.checkpoint_write_study \\
        [--steps 20] [--out build/checkpoint_write_study]

Builds the ``nvit`` trainer (ViT-L, f32 parameters, bf16 compute, AdamW,
the seeded scratch initialisation), takes three warm-up steps on one staged
random batch of 8, copies the training state to the host as a checkpoint
save does (``train/checkpoint.py::state_tensors``, timed), then times
``--steps`` train steps while a background thread does each of: nothing;
``safetensors.torch.save_file`` of that state; the port's
``save_safetensors`` of it. Prints one JSON line per case: the steps'
total, median and largest milliseconds and the thread's own seconds, and
the library's version. The files go under ``--out`` and are deleted.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import threading
import time

import numpy as np


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--out", default=os.path.join(
        "build", "checkpoint_write_study"))
    args = parser.parse_args(argv)

    import safetensors
    import torch
    from safetensors.torch import save_file

    from ..config import PRESETS
    from ..train.checkpoint import save_safetensors, state_tensors
    from ..train.trainer import Trainer

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(PRESETS["nvit"],
                              log_dir=os.path.join(args.out, "log"))
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state()
    rng = np.random.default_rng(0)
    batch = trainer.stage({
        "image": rng.integers(0, 256, (8, 256, 256, 3), dtype=np.uint8),
        "label": rng.integers(0, 120, 8).astype(np.int32),
        "mask": np.ones(8, bool)})
    for _ in range(3):
        trainer.train_step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tensors, _ = state_tensors(state)
    host_copy_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "state.safetensors")
    cases = {"none": None,
             "safetensors.save_file": lambda: save_file(tensors, path),
             "save_safetensors": lambda: save_safetensors(tensors, path)}
    for name, write in cases.items():
        thread_s = [0.0]

        def run(write=write):
            t = time.perf_counter()
            write()
            thread_s[0] = time.perf_counter() - t

        thread = threading.Thread(target=run) if write else None
        if thread:
            thread.start()
        step_ms = []
        for _ in range(args.steps):
            t = time.perf_counter()
            trainer.train_step(state, batch)
            step_ms.append((time.perf_counter() - t) * 1e3)
        if thread:
            thread.join()
        if os.path.exists(path):
            os.remove(path)
        print(json.dumps({
            "case": name, "steps": args.steps,
            "steps_ms": sum(step_ms), "median_ms": statistics.median(step_ms),
            "max_ms": max(step_ms), "thread_s": thread_s[0],
            "state_bytes": nbytes, "host_copy_s": host_copy_s,
            "safetensors": safetensors.__version__,
            "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
