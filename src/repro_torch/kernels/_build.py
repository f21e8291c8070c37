"""Build and load the port's CUDA kernels (nvcc into a plain C library).

Each library in :data:`LIBRARIES` is one source under ``csrc/`` with its own
``nvcc`` flags, compiled on first use into a shared library with a plain C
interface, named by a hash of the source and the flags, under
``build/repro_torch_kernels/`` at the root of the checkout, and loaded with
:mod:`ctypes`.  The libraries are independent, so they can be built in
parallel.  Nothing here runs at import time: the module
imports on a host without CUDA or ``nvcc``, and only a launch on a CUDA
tensor reaches :func:`library`.  :func:`refuse_autograd` is the one rule
every kernel wrapper applies on both of its routes.
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

import torch

from repro_torch import obs

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

# --fmad=false: no multiply-add contraction, so every double operation rounds
# exactly as numpy's does (bit-identity with the engine's numpy path).
# ptxas reports each kernel's registers and spills into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# The model kernels (attention, decoding, SSD scan) have no bit-identity
# contract: multiply-adds contract.
FLASH_NVCC_FLAGS = tuple(f for f in NVCC_FLAGS if f != "--fmad=false")

_P, _I32, _I64, _F64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double

# library name -> (source under csrc/, nvcc flags, {entry point: argtypes});
# every entry point returns a CUDA error code as int
LIBRARIES = {
    "cap_chain": ("cap_chain.cu", NVCC_FLAGS, {
        # n_out, n_in, out_cap, qps, par_rate, blk, rate, n, 4 caps, stream
        "repro_cap_chain_rates": [_P] * 7 + [_I64] + [_F64] * 4 + [_P],
        # host_in, dev_in, dev_out, host_out, n, 4 caps, stream
        "repro_cap_chain_front": [_P] * 4 + [_I64] + [_F64] * 4 + [_P],
        # nodes, n, counts, stream
        "repro_nic_flow_counts": [_P, _I64, _P, _P],
    }),
    "flash_attention": ("flash_attention.cu", FLASH_NVCC_FLAGS, {
        # q, k, v, o, bh, t, hd, dtype, scale, window, stream
        "repro_flash_attention": [_P] * 4 + [_I64] * 3 + [_I32, _F64, _I64, _P],
    }),
    "decode_attention": ("decode_attention.cu", FLASH_NVCC_FLAGS, {
        # q, k, v, valid, o, ws, bh, s, hd, split, dtype, scale, stream
        "repro_decode_attention": [_P] * 6 + [_I64] * 4 + [_I32, _F64, _P],
        # q, k, v, valid, o, ws, bh, s, hd, nsplit, scale, stream
        "repro_decode_attention_tiled": [_P] * 6 + [_I64] * 4 + [_F64, _P],
    }),
    "ssd_scan": ("ssd_scan.cu", FLASH_NVCC_FLAGS, {
        # x, dt, a, b, c, y, ws, bh, t, p, n, q, dtype, stream
        "repro_ssd_scan": [_P] * 7 + [_I64] * 5 + [_I32, _P],
    }),
    "moe_route": ("moe_route.cu", FLASH_NVCC_FLAGS, {
        # eids, slot, counts, routings, choices a routing, experts, capacity, stream
        "repro_expert_slots": [_P] * 3 + [_I64] * 2 + [_I32] * 2 + [_P],
        "repro_expert_slots_tile": [],
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


def build_log_path(name: str) -> Path:
    """The compiler's output of library ``name``'s build, beside the library."""
    return library_path(name).with_suffix(".log")


def build(name: str) -> Path:
    """Compile library ``name`` unless it exists; return its path.

    Raises ``RuntimeError`` with the compiler's output when nvcc fails; on
    success the output goes to :func:`build_log_path`.
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
        build_log_path(name).write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """Library ``name``, built if needed, with its entry points' ``argtypes``."""
    with obs.span("kernels.load", library=name) as sp:
        if obs.on:
            sp.set(built=not library_path(name).exists())  # whether nvcc runs
        lib = ctypes.CDLL(str(build(name)))
        for entry, argtypes in LIBRARIES[name][2].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def refuse_autograd(name: str, *operands) -> None:
    """Raise where autograd would record a call of kernel ``name``.

    No kernel has a backward, as none of the JAX package's Pallas kernels
    has one (it defines no ``custom_vjp``, and ``jax.grad`` through them
    fails).  A launch's output carries no ``grad_fn``, so a loss taken
    through it would get wrong gradients with no error; the plain version
    refuses too, so that the two routes behave alike.
    """
    if torch.is_grad_enabled() and any(x.requires_grad for x in operands):
        raise NotImplementedError(
            f"{name} has no backward (nor has the JAX package's Pallas kernel); "
            "train through attn_impl 'full' or 'chunked', or call it under torch.no_grad()"
        )
