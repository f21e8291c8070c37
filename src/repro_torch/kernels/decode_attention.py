"""Flash-decoding kernel of the decode path (CUDA on Hopper).

One query row against an S-long KV cache over (BH, 1, hd) and (BH, S, hd)
tensors, the function of the JAX package's Pallas ``decode_attention_bhsd``:
scores ``(q . k) * scale`` in float32, masked to the finite ``NEG_INF``
where the int32 ``valid`` (BH, S) is 0, a float32 softmax, output in the
input dtype.  A row with no valid slot comes out as the uniform mean of v,
as the oracle's softmax gives.

``decode_attention_bhsd`` launches the hand-written CUDA kernel
(``csrc/decode_attention.cu``, split-S flash decoding: one block per
(bh, 256-key split), then one merging block per bh) for a CUDA tensor and
takes the plain PyTorch version ``decode_attention_torch`` (the
full-matrix oracle of ``ref.py``) for a CPU tensor.  Both sides keep the
Pallas wrapper's shape rule: ``S`` must be a multiple of ``min(bs, S)``,
although the kernel's splits do not follow ``bs``.  The kernel takes bf16
and float32; anything else on a CUDA tensor raises ``ValueError``, and a
failed build or launch raises: there is no fallback.  Each launch adds one
to ``decode_attention_bhsd.launches``.
"""
from __future__ import annotations

import torch

from .ref import decode_attention_ref

__all__ = [
    "SPLIT",
    "SUPPORTED_DTYPES",
    "check_kernel_operands",
    "decode_attention_bhsd",
    "decode_attention_torch",
    "reset_launches",
]

SPLIT = 256  # keys a block of the kernel's first pass scores
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
MAX_HD = 4096
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The plain version: the direct full-matrix formulation, float32 throughout.
decode_attention_torch = decode_attention_ref


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid: torch.Tensor, bs: int) -> None:
    if q.dim() != 3 or q.shape[1] != 1:
        raise ValueError(f"q must be (BH, 1, hd), got {tuple(q.shape)}")
    bh, _, hd = q.shape
    if k.dim() != 3 or k.shape[0] != bh or k.shape[2] != hd or v.shape != k.shape:
        raise ValueError(f"k, v must be (BH, S, hd) = ({bh}, S, {hd}), got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    s = k.shape[1]
    if tuple(valid.shape) != (bh, s):
        raise ValueError(f"valid must be (BH, S) = {(bh, s)}, got {tuple(valid.shape)}")
    if bs < 1:
        raise ValueError(f"bs must be >= 1, got {bs}")
    blk = min(bs, s)
    if s == 0 or s % blk:
        raise ValueError(f"S={s} is not a multiple of the block bs=min({bs}, S)={blk}")


def check_kernel_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          valid: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the CUDA kernel takes these operands."""
    if q.dtype not in SUPPORTED_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype} not supported; "
                         f"the kernel takes one of {SUPPORTED_DTYPES} for q, k and v")
    if valid.dtype != torch.int32:
        raise ValueError(f"valid must be int32, got {valid.dtype}")
    if q.shape[-1] > MAX_HD:
        raise ValueError(f"head dim {q.shape[-1]} above the kernel's {MAX_HD}")
    if len({q.device, k.device, v.device, valid.device}) != 1:
        raise ValueError(f"q, k, v, valid on {q.device}, {k.device}, {v.device}, {valid.device}")


def decode_attention_bhsd(
    q: torch.Tensor,  # (BH, 1, hd)
    k: torch.Tensor,  # (BH, S, hd)
    v: torch.Tensor,
    valid: torch.Tensor,  # (BH, S) int32: 1 where the slot holds a real key
    *,
    scale: float,
    bs: int = 512,
) -> torch.Tensor:
    """One query against the cache; (BH, 1, hd) out in q's dtype."""
    _check_shapes(q, k, v, valid, bs)
    if q.device.type == "cpu":
        return decode_attention_torch(q, k, v, valid, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_bhsd runs on cpu or cuda, not {q.device}")
    check_kernel_operands(q, k, v, valid)
    from ._build import library

    q, k, v, valid = q.contiguous(), k.contiguous(), v.contiguous(), valid.contiguous()
    bh, s, hd = k.shape
    out = torch.empty_like(q)
    if bh == 0:
        return out
    nsplit = -(-s // SPLIT)
    ws = torch.empty(bh * nsplit * (hd + 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = library("decode_attention").repro_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(),
            ws.data_ptr(), bh, s, hd, SPLIT, _DTYPE_CODE[q.dtype], float(scale),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {rc}")
    decode_attention_bhsd.launches += 1
    return out


def reset_launches() -> None:
    """Set the wrapper's launch count to 0."""
    decode_attention_bhsd.launches = 0


reset_launches()
