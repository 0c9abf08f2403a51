"""Mini-dataset builder and the image-review apps' reference images (the
port's copy of the JAX package's ``utils/sample_dataset.py``).

- ``sample_dataset(src, dst, p, seed)``: copy each image of each label with
  probability ``p``, drawn from ``random.Random(seed)`` in sorted order, so
  one seed copies the files the JAX package copies;
- ``add_reference`` / ``del_reference``: put or remove each label's
  reference image ``<label>/0.jpg`` (the first file of the label in the
  reference folder), which the image-review apps show.

CLI: ``python -m touhouimageclassification_tpu_torch.utils.sample_dataset
--src <dir> --dst <dir> [-p 0.1 | --add-reference | --del-reference]``
"""
from __future__ import annotations

import os
import random
import shutil


def sample_dataset(src: str, dst: str, p: float, seed: int = 0) -> int:
    """Copy ~p of each label's images; returns total copied."""
    rng = random.Random(seed)
    total = 0
    for label in sorted(os.listdir(src)):
        ldir = os.path.join(src, label)
        if not os.path.isdir(ldir):
            continue
        files = sorted(os.listdir(ldir))
        chosen = [f for f in files if rng.random() < p]
        out = os.path.join(dst, label)
        os.makedirs(out, exist_ok=True)
        for f in chosen:
            shutil.copy(os.path.join(ldir, f), os.path.join(out, f))
        total += len(chosen)
    return total


def add_reference(reference_dir: str, target_dir: str) -> int:
    """Place each label's reference image as ``<label>/0.jpg`` in target."""
    n = 0
    for label in sorted(os.listdir(reference_dir)):
        src_dir = os.path.join(reference_dir, label)
        if not os.path.isdir(src_dir):
            continue
        files = sorted(os.listdir(src_dir))
        if not files:
            continue
        dst_dir = os.path.join(target_dir, label)
        os.makedirs(dst_dir, exist_ok=True)
        shutil.copy(os.path.join(src_dir, files[0]), os.path.join(dst_dir, "0.jpg"))
        n += 1
    return n


def del_reference(target_dir: str) -> int:
    """Remove every ``<label>/0.jpg``."""
    n = 0
    for label in sorted(os.listdir(target_dir)):
        ref = os.path.join(target_dir, label, "0.jpg")
        if os.path.exists(ref):
            os.remove(ref)
            n += 1
    return n


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Sample a mini dataset")
    parser.add_argument("--src", required=True)
    parser.add_argument("--dst", required=True)
    parser.add_argument("-p", type=float, default=0.1)
    parser.add_argument("--add-reference", action="store_true")
    parser.add_argument("--del-reference", action="store_true")
    args = parser.parse_args(argv)
    if args.add_reference:
        print(add_reference(args.src, args.dst), "references added")
    elif args.del_reference:
        print(del_reference(args.dst), "references removed")
    else:
        print(sample_dataset(args.src, args.dst, args.p), "images copied")


if __name__ == "__main__":
    main()
