"""Build and load the port's CUDA kernels (``csrc/*.cu``: attention forward
and backward (each an ``mma.sync`` / SIMT source and a Hopper ``wgmma``
source), patch embedding, the AdamW update, LayerNorm, and the kernel
studies' slab null copy and attention tiles) with ``nvcc`` + ctypes.

Each source compiles to an object file, all of them at once (one ``nvcc``
process per source), and the objects link into one shared library with a
plain C interface, ``build/torch_kernels/<key>/libtic_kernels.so`` at the
repository root, where ``<key>`` is the sha256 of the sources and headers, the
flags and the compiler. The build happens at first use, so a fresh checkout
needs nothing built beforehand, and an edited source builds a new library.
``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills per
kernel) is kept beside it as ``nvcc.log``. Nothing here runs at import time:
the CPU tests import every module on machines without ``nvcc``.
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")
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
    for src in sorted([*sources, *CSRC.glob("*.cuh")]):
        key.update(src.name.encode())
        key.update(src.read_bytes())
    key.update(" ".join(COMPILE_FLAGS).encode())
    key.update(nvcc.encode())
    out_dir = BUILD_ROOT / key.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # objects and library under per-process names, then rename: a concurrent
    # loader must never open a half-written library
    pid = os.getpid()
    objs = [out_dir / f"{src.stem}.{pid}.o" for src in sources]
    compiles = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj),
                                  str(src)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)
                for src, obj in zip(sources, objs)]
    logs = [proc.communicate()[0] for proc in compiles]
    tmp = out_dir / f"{LIB_NAME}.{pid}.tmp"
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    failed = [(src, proc.returncode) for src, proc in zip(sources, compiles)
              if proc.returncode]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode:
            failed.append((tmp, proc.returncode))
    (out_dir / "nvcc.log").write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {failed}:\n{''.join(logs)}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every C
    function's ``argtypes`` and ``restype`` declared."""
    lib = ctypes.CDLL(str(build_library()))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f32 = ctypes.c_float
    lib.tic_slab_attention_fwd.argtypes = [ptr, ptr, i32, i32, i32, i32, i32,
                                           f32, ptr]
    lib.tic_slab_attention_fwd.restype = i32
    lib.tic_attention_fwd.argtypes = [ptr, ptr, ptr, i64, i32, ptr, i32, i32,
                                      i32, i32, i32, f32, ptr]
    lib.tic_attention_fwd.restype = i32
    lib.tic_slab_attention_fwd_sm90.argtypes = [ptr, ptr, i32, i32, i32, i32,
                                                f32, ptr]
    lib.tic_slab_attention_fwd_sm90.restype = i32
    lib.tic_attention_fwd_sm90.argtypes = [ptr, ptr, ptr, i64, i32, ptr, i32,
                                           i32, i32, i32, f32, ptr]
    lib.tic_attention_fwd_sm90.restype = i32
    lib.tic_slab_attention_fwd_sm90_smem_bytes.argtypes = [i32, i32]
    lib.tic_slab_attention_fwd_sm90_smem_bytes.restype = ctypes.c_size_t
    lib.tic_attention_fwd_variant.argtypes = [ptr, ptr, ptr, i64, i32, ptr, i32,
                                              i32, i32, i32, f32, i32, i32, ptr]
    lib.tic_attention_fwd_variant.restype = i32
    lib.tic_slab_attention_fwd_smem_bytes.argtypes = [i32, i32, i32]
    lib.tic_slab_attention_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.tic_slab_attention_bwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                           i32, i32, f32, ptr]
    lib.tic_slab_attention_bwd.restype = i32
    lib.tic_attention_bwd.argtypes = [ptr, ptr, ptr, i64, i32, ptr, ptr, ptr,
                                      ptr, i64, i32, ptr, i32, i32, i32, i32,
                                      i32, f32, ptr]
    lib.tic_attention_bwd.restype = i32
    lib.tic_slab_attention_bwd_sm90.argtypes = [ptr, ptr, ptr, ptr, i32, i32,
                                                i32, i32, f32, ptr]
    lib.tic_slab_attention_bwd_sm90.restype = i32
    lib.tic_slab_attention_bwd_sm90_form.argtypes = [ptr, ptr, ptr, ptr, i32,
                                                     i32, i32, i32, f32, i32,
                                                     ptr]
    lib.tic_slab_attention_bwd_sm90_form.restype = i32
    lib.tic_attention_bwd_sm90.argtypes = [ptr, ptr, ptr, i64, i32, ptr, ptr,
                                           ptr, ptr, i64, i32, ptr, i32, i32,
                                           i32, i32, f32, ptr]
    lib.tic_attention_bwd_sm90.restype = i32
    lib.tic_slab_attention_bwd_sm90_smem_bytes.argtypes = [i32, i32]
    lib.tic_slab_attention_bwd_sm90_smem_bytes.restype = ctypes.c_size_t
    lib.tic_attention_bwd_probes.argtypes = [ptr, ptr, ptr, i64, i32, ptr, ptr,
                                             ptr, ptr, i64, i32, ptr, i32, i32,
                                             i32, i32, f32, ptr, ptr, ptr]
    lib.tic_attention_bwd_probes.restype = i32
    lib.tic_patch_embed.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                    i32, i32, i32, ptr]
    lib.tic_patch_embed.restype = i32
    lib.tic_slab_attention_bwd_smem_bytes.argtypes = [i32, i32, i32]
    lib.tic_slab_attention_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.tic_max_smem_optin.argtypes = [i32]
    lib.tic_max_smem_optin.restype = i32
    lib.tic_attention_fwd_peel.argtypes = [ptr, ptr, i32, i32, i32, i32, f32,
                                           i32, ptr]
    lib.tic_attention_fwd_peel.restype = i32
    lib.tic_attention_bwd_peel.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                           i32, f32, i32, ptr]
    lib.tic_attention_bwd_peel.restype = i32
    lib.tic_slab_null_copy.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, ptr]
    lib.tic_slab_null_copy.restype = i32
    lib.tic_attention_tile_smem_bytes.argtypes = [i32, i32, i32, i32, i32]
    lib.tic_attention_tile_smem_bytes.restype = ctypes.c_size_t
    lib.tic_attention_fwd_tile.argtypes = [ptr, ptr, i32, i32, i32, i32, f32,
                                           i32, i32, i32, i32, i32, ptr]
    lib.tic_attention_fwd_tile.restype = i32
    lib.tic_attention_fwd_softmax.argtypes = [ptr, ptr, i32, i32, i32, i32,
                                              f32, i32, i32, ptr]
    lib.tic_attention_fwd_softmax.restype = i32
    lib.tic_attention_bwd_tile.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                           i32, f32, i32, i32, i32, i32, ptr]
    lib.tic_attention_bwd_tile.restype = i32
    lib.tic_adamw_chunk_elements.argtypes = []
    lib.tic_adamw_chunk_elements.restype = i64
    lib.tic_adamw.argtypes = [ptr, i32, i64, f32, f32, f32, f32, f32, f32, f32,
                              ptr]
    lib.tic_adamw.restype = i32
    lib.tic_layernorm_max_width.argtypes = []
    lib.tic_layernorm_max_width.restype = i32
    lib.tic_layernorm_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64, i32,
                                      f32, i32, i32, ptr]
    lib.tic_layernorm_fwd.restype = i32
    lib.tic_layernorm_bwd_blocks.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32,
                                             i32]
    lib.tic_layernorm_bwd_blocks.restype = i32
    lib.tic_layernorm_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32,
                                      ptr, ptr, i64, i32, i32, i32, ptr]
    lib.tic_layernorm_bwd.restype = i32
    return lib
