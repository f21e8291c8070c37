"""Flash-decoding kernel of the decode path (CUDA on Hopper).

One query row against an S-long KV cache over (BH, 1, hd) and (BH, S, hd)
tensors, the function of the JAX package's Pallas ``decode_attention_bhsd``:
scores ``(q . k) * scale`` in float32, masked to the finite ``NEG_INF``
where the int32 ``valid`` (BH, S) is 0, a float32 softmax, output in the
input dtype.  A row with no valid slot comes out as the uniform mean of v,
as the oracle's softmax gives.

``decode_attention_bhsd`` launches the hand-written CUDA kernel
(``csrc/decode_attention.cu``) for a CUDA tensor and takes the plain
PyTorch version ``decode_attention_torch`` (the full-matrix oracle of
``ref.py``) for a CPU tensor.  The source holds two instances, picked by
(dtype, hd) alone:

* bf16 at ``hd`` in ``SUPPORTED_HD``: 64-key tiles split over ~132 blocks
  (``ref.decode_split_plan``; split ``sp`` owns tiles ``sp, sp + nsplit,
  ...``).  A block reads its tiles' valid words first and loads k and v
  only of the tiles that hold a valid key, through a 3-stage ring of bulk
  copies; in a tile it reads, a masked key is selected out.  So non-finite
  values in masked slots never reach the output, where the Pallas kernel,
  which reads every slot, propagates 0 * NaN; the models' caches are
  zero-initialised, so no served path sees the difference.  Only a row with
  no valid slot at all reads its masked v (for the mean).
  ``ref.decode_attention_tiled_ref`` repeats its arithmetic.  Its operands
  must be 16-byte aligned, as every allocation is.
* float32, and bf16 at any other hd: the first design, split-S flash
  decoding over every slot (one block per (bh, ``GENERIC_SPLIT``-key
  split), then a merging block per bh).

Both sides keep the Pallas wrapper's shape rule: ``S`` must be a multiple
of ``min(bs, S)``, although the kernel's tiles do not follow ``bs``.  Any
other dtype on a CUDA tensor raises ``ValueError``, and a failed build or
launch raises: there is no fallback.  Each call adds one to
``decode_attention_bhsd.launches``.  Neither route has a backward, as the
Pallas kernel has none: under autograd, with an operand that requires
grad, both raise ``NotImplementedError`` (``_build.refuse_autograd``).
"""
from __future__ import annotations

import torch

from ._build import refuse_autograd
from .ref import decode_attention_ref, decode_split_plan

__all__ = [
    "GENERIC_SPLIT",
    "SUPPORTED_DTYPES",
    "SUPPORTED_HD",
    "check_kernel_operands",
    "decode_attention_bhsd",
    "decode_attention_torch",
    "reset_launches",
    "uses_tiled_instance",
    "workspace_floats",
]

GENERIC_SPLIT = 256  # keys a block of the float32 / generic instance's first pass scores
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
SUPPORTED_HD = (16, 32, 48, 64, 128, 160, 256)  # head dims of the bf16 tiled instance
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


def uses_tiled_instance(dtype: torch.dtype, hd: int) -> bool:
    """Whether the kernel runs the bf16 tiled instance (else the generic one)."""
    return dtype == torch.bfloat16 and hd in SUPPORTED_HD


def workspace_floats(bh: int, s: int, hd: int, dtype: torch.dtype) -> int:
    """4-byte words of the workspace a launch needs: ``hd + 2`` floats per
    (row, split), and for the tiled instance one int32 counter per row."""
    if uses_tiled_instance(dtype, hd):
        return bh * decode_split_plan(bh, s)[1] * (hd + 2) + bh
    return bh * -(-s // GENERIC_SPLIT) * (hd + 2)


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
    refuse_autograd("decode_attention_bhsd", q, k, v)
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
    ws = torch.empty(workspace_floats(bh, s, hd, q.dtype), dtype=torch.float32, device=q.device)
    lib = library("decode_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if uses_tiled_instance(q.dtype, hd):
            if any(x.data_ptr() % 16 for x in (q, k, v, out)):
                raise ValueError("the bf16 decode kernel takes 16-byte aligned q, k, v")
            rc = lib.repro_decode_attention_tiled(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(),
                ws.data_ptr(), bh, s, hd, decode_split_plan(bh, s)[1], float(scale), stream,
            )
        else:
            rc = lib.repro_decode_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(),
                ws.data_ptr(), bh, s, hd, GENERIC_SPLIT, _DTYPE_CODE[q.dtype], float(scale),
                stream,
            )
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {rc}")
    decode_attention_bhsd.launches += 1
    return out


def reset_launches() -> None:
    """Set the wrapper's launch count to 0."""
    decode_attention_bhsd.launches = 0


reset_launches()
