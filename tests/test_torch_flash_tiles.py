"""The arithmetic of K3's bf16 tensor-core instance, on the CPU.

``ref.flash_attention_tiled_ref`` repeats what the CUDA kernel computes (its
tile plan, its live-tile walk, the online softmax in log2 units, P as bf16
hi + lo terms); it is held against the JAX package's Pallas kernel in
interpret mode and its oracle, with inputs drawn by numpy, on the sweep of
``test_torch_flash_attention.py``, ragged T below 128 and gemma3_1b's local
layer.  bf16 is held to two bounds at once: 2e-2 abs, and
``2e-3 + 2e-2 |want|``, which a dropped KV tile on a late row (outputs ~0.1)
would break.  float32 is held to 2e-4.  The ``cuda``-marked test holds the
kernel itself to the tiled version at ``1e-3 + 1e-2 |want|``.
"""
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_bhtd as jflash
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref

from test_torch_flash_attention import NEW_HD, SWEEP, _f32, _qkv

# (B, H, T, hd, window): T < 128 need not be a multiple of the 64-row tile
RAGGED = [(2, 2, 16, 64, None), (1, 2, 16, 256, 8), (2, 2, 40, 128, None),
          (1, 2, 40, 160, 24), (2, 2, 100, 64, None), (1, 2, 100, 128, 30)]
HD256_WINDOW = [(1, 1, 1024, 256, 512)]  # gemma3_1b's local layer


def _assert_bounds(got, want, dtype: str) -> None:
    got, want = _f32(got), _f32(want)
    diff = np.abs(got - want)
    if dtype == "bfloat16":
        assert diff.max() <= 2e-2, diff.max()
        excess = diff - (2e-3 + 2e-2 * np.abs(want))
        assert excess.max() <= 0, (excess.max(), np.unravel_index(excess.argmax(), diff.shape))
    else:
        assert diff.max() <= 2e-4, diff.max()


@pytest.mark.parametrize(
    "b,h,t,hd,window,dtype",
    [(*s, dt) for s in SWEEP + NEW_HD for dt in ("bfloat16", "float32")]
    + [(*s, "bfloat16") for s in RAGGED + HD256_WINDOW],
)
def test_tiled_ref_matches_jax(b, h, t, hd, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv((b * h, t, hd), seed=b * 100 + t + hd, dtype=dtype)
    scale = hd**-0.5
    got = tref.flash_attention_tiled_ref(tq, tk, tv, scale=scale, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert torch.isfinite(got).all()
    pallas = jflash(jq, jk, jv, scale=scale, window=window, interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, scale=scale, window=window)
    for want in (pallas, oracle):
        _assert_bounds(got, want, dtype)


@pytest.mark.parametrize("b,h,t,hd,window", RAGGED)
def test_ragged_plain_version_matches_jax(b, h, t, hd, window):
    """The wrapper's CPU path takes T < 128 that no 64-row tile divides, as
    the Pallas wrapper does."""
    (jq, jk, jv), (tq, tk, tv) = _qkv((b * h, t, hd), seed=b * 100 + t + hd, dtype="bfloat16")
    got = tfa.flash_attention_bhtd(tq, tk, tv, scale=hd**-0.5, window=window)
    pallas = jflash(jq, jk, jv, scale=hd**-0.5, window=window, interpret=True)
    _assert_bounds(got, pallas, "bfloat16")


@pytest.mark.parametrize("hd", tfa.SUPPORTED_HD)
def test_tile_plan_fits_the_kernel(hd):
    """The plan's tiles meet what the CUDA instance assumes: a padded shared
    row that is an odd multiple of 16 bytes (conflict-free ldmatrix), tiles
    of whole 16-byte chunks for 128 threads, 16-key mma steps, and a 2-stage
    ring that fits the 227 KB a block may have."""
    bq, bk = tref.flash_tile_plan(hd)
    assert bq == 64 and bk == (64 if hd <= 64 else 32)
    row_bytes = (hd + 8) * 2
    assert row_bytes % 16 == 0 and (row_bytes // 16) % 2 == 1
    chunks = hd // 8
    assert (bq * chunks) % 128 == 0 and (bk * chunks) % 128 == 0 and (16 * chunks) % 32 == 0
    assert bk % 16 == 0
    assert row_bytes * (bq + 2 * 2 * bk) <= 232_448


@pytest.mark.parametrize("bk", [32, 64])
@pytest.mark.parametrize("t,window", [(16, None), (100, None), (512, None), (512, 1),
                                      (512, 16), (512, 64), (1024, 512), (100, 30), (40, 100)])
def test_live_kv_tiles_are_the_tiles_with_a_kept_key(t, window, bk):
    """For each 64-row query tile, the walked KV tiles are exactly those in
    which some row of the tile keeps some key."""
    w = t + 1 if window is None else window
    for q0 in range(0, t, 64):
        qp = np.arange(q0, min(q0 + 64, t))[:, None]
        kp = np.arange(0, -(-t // bk) * bk)[None, :]
        keep = (qp >= kp) & (qp - kp < w)
        live = {int(k) // bk for k in np.flatnonzero(keep.any(axis=0))}
        walked = tref.flash_live_kv_tiles(q0, t, 64, bk, window)
        assert set(walked) == live and list(walked) == sorted(live)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,hd,window", SWEEP + NEW_HD + RAGGED + HD256_WINDOW
                         + [(4, 32, 512, 128, None)])
def test_bf16_kernel_matches_tiled_ref_on_card(cuda_device, b, h, t, hd, window):
    _, tensors = _qkv((b * h, t, hd), seed=b * 100 + t + hd, dtype="bfloat16")
    q, k, v = (x.to(cuda_device) for x in tensors)
    got = tfa.flash_attention_bhtd(q, k, v, scale=hd**-0.5, window=window)
    torch.cuda.synchronize()
    tiled = tref.flash_attention_tiled_ref(q, k, v, scale=hd**-0.5, window=window).float()
    assert (got.float() - tiled).abs().le(1e-3 + 1e-2 * tiled.abs()).all()
    _assert_bounds(got.cpu(), tfa.flash_attention_torch(q, k, v, scale=hd**-0.5,
                                                        window=window).cpu(), "bfloat16")
