"""Flash-attention kernel of the prefill path (CUDA on Hopper).

Causal attention with an optional sliding window over (BH, T, hd) tensors,
the function of the JAX package's Pallas ``flash_attention_bhtd``:
positions run contiguously from 0, ``keep(q, k) = q >= k and q - k <
window``, scores ``(q . k) * scale`` in float32, an online softmax with
float32 statistics, output in the input dtype.

``flash_attention_bhtd`` launches the hand-written CUDA kernel
(``csrc/flash_attention.cu``) for a CUDA tensor and takes the plain PyTorch
version ``flash_attention_torch`` (the full-matrix oracle of ``ref.py``) for
a CPU tensor.  Both sides keep the Pallas wrapper's shape rule: the tile is
``bq = min(128, T)`` and ``T`` must be a multiple of it.  The kernel takes
bf16 and float32 with ``hd`` in ``SUPPORTED_HD``; anything else on a CUDA
tensor raises ``ValueError``, and a failed build or launch raises: there is
no fallback.  Each launch adds one to ``flash_attention_bhtd.launches``.
Neither route has a backward, as the Pallas kernel has none: with autograd
on and an operand that requires grad, both raise ``NotImplementedError``
(``_build.refuse_autograd``); train through ``full`` or ``chunked``.

The source holds two instances behind one entry point.  bf16 runs on the
tensor cores (``mma.sync`` tiles fed by ``cp.async``; P enters the PV
product as bf16 hi + lo terms), and ``ref.flash_attention_tiled_ref``
repeats its arithmetic; its operands must be 16-byte aligned, as every
allocation is.  float32 runs on the FMA units, so its inputs are never
rounded to TF32.
"""
from __future__ import annotations

import torch

from ._build import refuse_autograd
from .ref import flash_attention_ref

__all__ = [
    "SUPPORTED_HD",
    "SUPPORTED_DTYPES",
    "check_kernel_operands",
    "flash_attention_bhtd",
    "flash_attention_torch",
    "reset_launches",
]

SUPPORTED_HD = (16, 32, 48, 64, 128, 160, 256)  # the head dims the configs use
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_NO_WINDOW = 2**31 - 1

# The plain version: the direct full-matrix formulation, float32 throughout.
flash_attention_torch = flash_attention_ref


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: int | None) -> None:
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one (BH, T, hd) shape with T == S, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    t = q.shape[1]
    bq = min(128, t)
    if t == 0 or t % bq:
        raise ValueError(f"T={t} is not a multiple of the tile bq=min(128, T)={bq}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def check_kernel_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the CUDA kernel takes these operands."""
    if q.shape[-1] not in SUPPORTED_HD:
        raise ValueError(f"head dim {q.shape[-1]} not supported by the kernel; "
                         f"it takes {SUPPORTED_HD}")
    if q.dtype not in SUPPORTED_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype} not supported; "
                         f"the kernel takes one of {SUPPORTED_DTYPES} for all three")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")


def flash_attention_bhtd(
    q: torch.Tensor,  # (BH, T, hd)
    k: torch.Tensor,  # (BH, T, hd)
    v: torch.Tensor,
    *,
    scale: float,
    window: int | None = None,
) -> torch.Tensor:
    """Causal (sliding-window) attention; (BH, T, hd) in, same out."""
    _check_shapes(q, k, v, window)
    refuse_autograd("flash_attention_bhtd", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, scale=scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bhtd runs on cpu or cuda, not {q.device}")
    check_kernel_operands(q, k, v)
    from ._build import library

    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    bh, t, hd = q.shape
    if bh == 0:
        return out
    with torch.cuda.device(q.device):
        rc = library("flash_attention").repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bh, t, hd, _DTYPE_CODE[q.dtype], float(scale),
            _NO_WINDOW if window is None else int(window),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    flash_attention_bhtd.launches += 1
    return out


def reset_launches() -> None:
    """Set the wrapper's launch count to 0."""
    flash_attention_bhtd.launches = 0


reset_launches()
