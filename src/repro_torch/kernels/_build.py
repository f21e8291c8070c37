"""Build and load the port's CUDA kernels (nvcc into a plain C library).

Each library in :data:`LIBRARIES` is one source under ``csrc/`` with its own
``nvcc`` flags, compiled on first use into a shared library with a plain C
interface, named by a hash of the source and the flags, under
``build/repro_torch_kernels/`` at the root of the checkout, and loaded with
:mod:`ctypes`.  The libraries are independent, so they can be built in
parallel.  Nothing here runs at import time: the module
imports on a host without CUDA or ``nvcc``, and only a launch on a CUDA
tensor reaches :func:`library`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

# --fmad=false: no multiply-add contraction, so every double operation rounds
# exactly as numpy's does (bit-identity with the engine's numpy path).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)
# The attention kernel has no bit-identity contract: multiply-adds contract.
FLASH_NVCC_FLAGS = tuple(f for f in NVCC_FLAGS if f != "--fmad=false")

_P, _I32, _I64, _F64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double

# library name -> (source under csrc/, nvcc flags, {entry point: argtypes});
# every entry point returns a CUDA error code as int
LIBRARIES = {
    "cap_chain": ("cap_chain.cu", NVCC_FLAGS, {
        # n_out, n_in, out_cap, qps, par_rate, blk, rate, n, 4 caps, stream
        "repro_cap_chain_rates": [_P] * 7 + [_I64] + [_F64] * 4 + [_P],
        # nodes, n, counts, stream
        "repro_nic_flow_counts": [_P, _I64, _P, _P],
    }),
    "flash_attention": ("flash_attention.cu", FLASH_NVCC_FLAGS, {
        # q, k, v, o, bh, t, hd, dtype, scale, window, stream
        "repro_flash_attention": [_P] * 4 + [_I64] * 3 + [_I32, _F64, _I64, _P],
    }),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    """Where library ``name`` for its current source and flags lives."""
    source, flags, _ = LIBRARIES[name]
    src = CSRC / source
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(src.name.encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"repro_torch_kernels_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile library ``name`` unless it exists; return its path.

    Raises ``RuntimeError`` with the compiler's output when nvcc fails.
    """
    out = library_path(name)
    if out.exists():
        return out
    source, flags, _ = LIBRARIES[name]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *flags, "-o", tmp, str(CSRC / source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """Library ``name``, built if needed, with its entry points' ``argtypes``."""
    lib = ctypes.CDLL(str(build(name)))
    for entry, argtypes in LIBRARIES[name][2].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
