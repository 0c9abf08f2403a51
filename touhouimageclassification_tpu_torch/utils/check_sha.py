"""Train/test contamination check by content hash (the port's copy of the
JAX package's ``utils/check_sha.py``).

SHA-512 every file under two folders (on a pool of 16 threads: hashing waits
on the disk) and report the files of the second whose content the first
also holds, and those it does not.

CLI: ``python -m touhouimageclassification_tpu_torch.utils.check_sha --src
data/train --dst data/test``
"""
from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor


def sha512_file(path: str) -> str:
    h = hashlib.sha512()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def load_folder(folder: str) -> dict[str, list[str]]:
    """hash -> [paths] over every file under ``folder``."""
    paths = [
        os.path.join(root, name)
        for root, _dirs, files in os.walk(folder)
        for name in files
    ]
    out: dict[str, list[str]] = {}
    with ThreadPoolExecutor(max_workers=16) as pool:
        for path, digest in zip(paths, pool.map(sha512_file, paths)):
            out.setdefault(digest, []).append(path)
    return out


def check_folder(src: str, dst: str) -> tuple[list[str], list[str]]:
    """Returns (duplicated_in_dst, unique_in_dst): files of ``dst`` whose
    content also exists in ``src`` vs not."""
    src_hashes = set(load_folder(src))
    duplicated: list[str] = []
    unique: list[str] = []
    for digest, paths in load_folder(dst).items():
        (duplicated if digest in src_hashes else unique).extend(paths)
    return duplicated, unique


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="SHA-512 duplication check")
    parser.add_argument("--src", required=True, help="reference folder (e.g. train)")
    parser.add_argument("--dst", required=True, help="folder to check (e.g. test)")
    args = parser.parse_args(argv)
    dup, uniq = check_folder(args.src, args.dst)
    print(f"Duplicated: {len(dup)}")
    for p in dup:
        print(f"  {p}")
    print(f"Unique: {len(uniq)}")


if __name__ == "__main__":
    main()
