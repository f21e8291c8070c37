"""Mamba2 SSD chunked-scan kernel (CUDA on Hopper).

The function of the JAX package's Pallas ``ssd_scan_bhtpn`` over
(BH, T, P) inputs: per row, the SSM recurrence
``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``, ``y_t = h_t C_t`` with a
(P, N) float32 state from zero, computed chunk by chunk (chunk
``q = min(q, T)``) as the SSD algebra; y in x's dtype.

``ssd_scan_bhtpn`` launches the hand-written CUDA kernel
(``csrc/ssd_scan.cu``: three chunk-parallel passes, chunk states, state
passing and a chunk scan in 64-row tiles; bf16 on the tensor cores with
every float32 operand as bf16 hi + lo terms, float32 as SIMT FMAs) for a
CUDA tensor and takes the plain PyTorch version ``ssd_scan_torch`` (the
per-step recurrence of ``ref.py``) for a CPU tensor;
``ref.ssd_scan_tiled_ref`` repeats the kernel's arithmetic.  Both sides keep the Pallas wrapper's shape rule: ``T``
must be a multiple of ``min(q, T)``.  The kernel takes x, b and c in bf16
or float32 (one dtype), P in ``SUPPORTED_P``, N in ``SUPPORTED_N`` and a
chunk of at most ``MAX_CHUNK``; anything else on a CUDA tensor raises
``ValueError``, and a failed build or launch raises: there is no fallback.
Each call that launches the kernel's passes adds one to
``ssd_scan_bhtpn.launches``.  The wrapper allocates the passes' float32
workspace (:func:`workspace_floats`) with ``torch.empty``.  Neither route
has a backward, as the Pallas kernel has none: under autograd, with an
operand that requires grad, both raise ``NotImplementedError``
(``_build.refuse_autograd``).
"""
from __future__ import annotations

import torch

from ._build import refuse_autograd
from .ref import ssd_scan_ref

__all__ = [
    "MAX_CHUNK",
    "SUPPORTED_DTYPES",
    "SUPPORTED_N",
    "SUPPORTED_P",
    "check_kernel_operands",
    "reset_launches",
    "ssd_scan_bhtpn",
    "ssd_scan_torch",
    "workspace_floats",
]

SUPPORTED_P = (16, 32, 64)  # head dims of the mamba2_130m and jamba_v01_52b configs
SUPPORTED_N = (8, 16, 32, 64, 128)  # their state sizes
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
MAX_CHUNK = 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def ssd_scan_torch(x, dt, a, b, c, *, q: int = 128) -> torch.Tensor:
    """The plain version: the per-step recurrence, float32 state (``q`` does
    not change the function)."""
    return ssd_scan_ref(x, dt, a, b, c)


def workspace_floats(bh: int, t: int, p: int, n: int, q: int) -> int:
    """Floats of the kernel's workspace: a (P, N) state per chunk of every
    row, then the per-step cumulative decay of every row."""
    return bh * (t // min(q, t)) * p * n + bh * t


def _check_shapes(x, dt, a, b, c, q: int) -> int:
    if x.dim() != 3:
        raise ValueError(f"x must be (BH, T, P), got {tuple(x.shape)}")
    bh, t, _ = x.shape
    if tuple(dt.shape) != (bh, t, 1) or tuple(a.shape) != (bh, 1):
        raise ValueError(f"dt must be {(bh, t, 1)} and a {(bh, 1)}, got "
                         f"{tuple(dt.shape)}, {tuple(a.shape)}")
    if b.dim() != 3 or b.shape[:2] != (bh, t) or c.shape != b.shape:
        raise ValueError(f"b, c must share one (BH, T, N) = ({bh}, {t}, N) shape, got "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    if q < 1:
        raise ValueError(f"q must be >= 1, got {q}")
    chunk = min(q, t)
    if t == 0 or t % chunk:
        raise ValueError(f"T={t} is not a multiple of the chunk q=min({q}, T)={chunk}")
    return chunk


def check_kernel_operands(x, dt, a, b, c, q: int) -> None:
    """Raise ``ValueError`` unless the CUDA kernel takes these operands."""
    p, n = x.shape[-1], b.shape[-1]
    if p not in SUPPORTED_P or n not in SUPPORTED_N:
        raise ValueError(f"(P, N) = {(p, n)} not supported; the kernel takes P in "
                         f"{SUPPORTED_P} and N in {SUPPORTED_N}")
    if x.dtype not in SUPPORTED_DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}, {b.dtype}, {c.dtype} not supported; the kernel "
                         f"takes one of {SUPPORTED_DTYPES} for x, b and c")
    if not (dt.is_floating_point() and a.is_floating_point()):
        raise ValueError(f"dt and a must be floating point, got {dt.dtype}, {a.dtype}")
    if min(q, x.shape[1]) > MAX_CHUNK:
        raise ValueError(f"chunk {min(q, x.shape[1])} above the kernel's {MAX_CHUNK}")
    if len({x.device, dt.device, a.device, b.device, c.device}) != 1:
        raise ValueError("x, dt, a, b, c on different devices")


def ssd_scan_bhtpn(
    x: torch.Tensor,  # (BH, T, P)
    dt: torch.Tensor,  # (BH, T, 1): post-softplus
    a: torch.Tensor,  # (BH, 1): negative per-head decay rate
    b: torch.Tensor,  # (BH, T, N)
    c: torch.Tensor,  # (BH, T, N)
    *,
    q: int = 128,
) -> torch.Tensor:
    """The SSD scan from a zero state; (BH, T, P) out in x's dtype."""
    chunk = _check_shapes(x, dt, a, b, c, q)
    refuse_autograd("ssd_scan_bhtpn", x, dt, a, b, c)
    if x.device.type == "cpu":
        return ssd_scan_torch(x, dt, a, b, c, q=q)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bhtpn runs on cpu or cuda, not {x.device}")
    check_kernel_operands(x, dt, a, b, c, q)
    from ._build import library

    x, b, c = x.contiguous(), b.contiguous(), c.contiguous()
    # the Pallas kernel casts dt to float32 and takes a as given (float32)
    dt32 = dt.to(torch.float32).contiguous()
    a32 = a.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    bh, t, p = x.shape
    if bh == 0:
        return out
    n = b.shape[2]
    ws = torch.empty(workspace_floats(bh, t, p, n, chunk), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = library("ssd_scan").repro_ssd_scan(
            x.data_ptr(), dt32.data_ptr(), a32.data_ptr(), b.data_ptr(), c.data_ptr(),
            out.data_ptr(), ws.data_ptr(), bh, t, p, n, chunk, _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    ssd_scan_bhtpn.launches += 1
    return out


def reset_launches() -> None:
    """Set the wrapper's launch count to 0."""
    ssd_scan_bhtpn.launches = 0


reset_launches()
