"""Build and load the port's CUDA kernels (``csrc/*.cu``) with ``nvcc`` + ctypes.

The sources compile into one shared library with a plain C interface,
``build/torch_kernels/<key>/libtic_kernels.so`` at the repository root, where
``<key>`` is the sha256 of the sources, the flags and the compiler. The build
happens at first use, so a fresh checkout needs nothing built beforehand, and
an edited source builds a new library. ``nvcc``'s ``-Xptxas -v`` report
(registers, shared memory, spills per kernel) is kept beside it as
``nvcc.log``. Nothing here runs at import time: the CPU tests import every
module on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libtic_kernels.so"


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the port's CUDA kernels are built from csrc/ at "
                           "first use")
    return nvcc


def build_library() -> Path:
    """Compile ``csrc/*.cu`` unless a library for the same key exists."""
    nvcc = find_nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    key = hashlib.sha256()
    for src in sources:
        key.update(src.name.encode())
        key.update(src.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    key.update(nvcc.encode())
    out_dir = BUILD_ROOT / key.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # build under a per-process name, then rename: a concurrent loader must
    # never open a half-written library
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "nvcc.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every C
    function's ``argtypes`` and ``restype`` declared."""
    lib = ctypes.CDLL(str(build_library()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tic_slab_attention_fwd.argtypes = [ptr, ptr, i32, i32, i32, i32, i32,
                                           ctypes.c_float, ptr]
    lib.tic_slab_attention_fwd.restype = i32
    lib.tic_slab_attention_fwd_smem_bytes.argtypes = [i32, i32, i32]
    lib.tic_slab_attention_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.tic_max_smem_optin.argtypes = [i32]
    lib.tic_max_smem_optin.restype = i32
    return lib
