"""Build and load the port's CUDA kernels (nvcc into a plain C library).

The sources under ``csrc/`` are compiled on first use with ``nvcc`` into one
shared library with a plain C interface, named by a hash of the sources and
the flags, under ``build/repro_torch_kernels/`` at the root of the checkout,
and loaded with :mod:`ctypes`.  Nothing here runs at import time: the module
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


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"repro_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them exists; return its path.

    Raises ``RuntimeError`` with the compiler's output when nvcc fails.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
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
def library() -> ctypes.CDLL:
    """The built library with every entry point's ``argtypes`` declared."""
    lib = ctypes.CDLL(str(build()))
    p, i64, f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    lib.repro_cap_chain_rates.argtypes = [
        p, p, p, p, p, p, p, i64, f64, f64, f64, f64, p,
    ]
    lib.repro_cap_chain_rates.restype = ctypes.c_int
    lib.repro_nic_flow_counts.argtypes = [p, i64, p, p]
    lib.repro_nic_flow_counts.restype = ctypes.c_int
    return lib
