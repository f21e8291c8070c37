"""Port kernel K4 (flash decoding) against the JAX package.

On the CPU the port's ``ops.decode_attention`` runs the kernel's plain
version (the full-matrix oracle); it is held against the JAX package's
Pallas kernel in interpret mode and its ``ref.decode_attention_ref`` on the
sweep of ``tests/test_kernels.py``, with inputs drawn by numpy, at that
file's tolerances (2e-2 for bf16, 2e-4 for float32, absolute and
relative).  The CUDA kernel is held against the plain version by the
``cuda``-marked tests, which run only where a card is present.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

B, H, HD = 2, 4, 64
SWEEP = [(512, 511), (1024, 700), (2048, 1)]
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}


def _tol(dtype: str) -> float:
    return 2e-2 if dtype == "bfloat16" else 2e-4


def _qkv(s: int, seed: int, dtype: str, b: int = B, h: int = H, hd: int = HD):
    """numpy f32 draws of q (B,H,1,hd), k, v (B,H,S,hd), rounded once to ``dtype``."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    shapes = [(b, h, 1, hd), (b, h, s, hd), (b, h, s, hd)]
    tq = [torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)).to(tdt) for sh in shapes]
    jq = [jnp.asarray(t.float().numpy()).astype(jdt) for t in tq]
    return jq, tq


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _jax_both(jq, jk, jv, valid_bs: np.ndarray, valid_arg):
    """The Pallas kernel (interpret mode) through ops, and the oracle on (B*H, S)."""
    b, h, s, hd = jk.shape
    pallas = jops.decode_attention(jq, jk, jv, jnp.asarray(valid_arg), scale=hd**-0.5,
                                   interpret=True)
    validbh = np.broadcast_to(valid_bs[:, None, :], (b, h, s)).reshape(b * h, s)
    oracle = jref.decode_attention_ref(
        jq.reshape(b * h, 1, hd), jk.reshape(b * h, s, hd), jv.reshape(b * h, s, hd),
        jnp.asarray(validbh.astype(np.int32)), scale=hd**-0.5,
    ).reshape(b, h, 1, hd)
    return pallas, oracle


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s,valid_upto", SWEEP)
def test_decode_attention_matches_jax(s, valid_upto, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(s, seed=s, dtype=dtype)
    valid = (np.arange(s) <= valid_upto).astype(np.int32)  # 1-D, as tests/test_kernels.py
    got = tops.decode_attention(tq, tk, tv, torch.from_numpy(valid), scale=HD**-0.5)
    assert got.dtype == tq.dtype and got.shape == (B, H, 1, HD)
    pallas, oracle = _jax_both(jq, jk, jv, np.broadcast_to(valid[None], (B, s)), valid)
    tol = _tol(dtype)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_two_d_valid_and_a_row_with_no_valid_slot(dtype):
    """valid (B, S): batch 1 has no valid slot at all.  The finite NEG_INF
    makes its softmax uniform: the output is the mean of v, not a NaN."""
    s = 512
    (jq, jk, jv), (tq, tk, tv) = _qkv(s, seed=21, dtype=dtype)
    valid = (np.random.default_rng(21).random((B, s)) < 0.4).astype(np.int32)
    valid[1] = 0
    got = tops.decode_attention(tq, tk, tv, torch.from_numpy(valid), scale=HD**-0.5)
    pallas, oracle = _jax_both(jq, jk, jv, valid, valid)
    tol = _tol(dtype)
    assert torch.isfinite(got).all()
    for want in (pallas, oracle):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(got)[1, :, 0], _f32(tv)[1].mean(axis=1), atol=tol, rtol=tol)


def test_one_d_and_two_d_valid_agree():
    _, (tq, tk, tv) = _qkv(512, seed=4, dtype="float32")
    valid = (np.arange(512) % 3 != 0).astype(np.int32)
    one = tops.decode_attention(tq, tk, tv, torch.from_numpy(valid), scale=0.125)
    two = tops.decode_attention(tq, tk, tv, torch.from_numpy(np.stack([valid] * B)), scale=0.125)
    assert torch.equal(one, two)


@pytest.mark.parametrize(
    "q_shape,kv_shape,valid_shape,bs",
    [((8, 1, 64), (8, 600, 64), (8, 600), 512),
     ((8, 2, 64), (8, 512, 64), (8, 512), 512),
     ((8, 1, 64), (8, 512, 32), (8, 512), 512),
     ((8, 1, 64), (8, 512, 64), (512,), 512),
     ((8, 1, 64), (8, 512, 64), (8, 512), 0)],
    ids=["S_not_multiple_of_bs", "two_queries", "hd_mismatch", "valid_not_bh_s", "bs_0"],
)
def test_wrapper_rejects_what_the_pallas_wrapper_rejects(q_shape, kv_shape, valid_shape, bs):
    q, k = torch.zeros(q_shape), torch.zeros(kv_shape)
    with pytest.raises(ValueError):
        tda.decode_attention_bhsd(q, k, k, torch.ones(valid_shape, dtype=torch.int32),
                                  scale=0.1, bs=bs)


@pytest.mark.parametrize(
    "dtype,valid_dtype", [(torch.float16, torch.int32), (torch.float64, torch.int32),
                          (torch.float32, torch.int64), (torch.bfloat16, torch.bool)],
)
def test_kernel_rejects_unsupported_dtypes(dtype, valid_dtype):
    q, k = torch.zeros((4, 1, 64), dtype=dtype), torch.zeros((4, 512, 64), dtype=dtype)
    with pytest.raises(ValueError):
        tda.check_kernel_operands(q, k, k, torch.ones((4, 512), dtype=valid_dtype))


def test_plain_version_is_the_oracle_and_launches_stay_zero():
    tda.reset_launches()
    _, (tq, tk, tv) = _qkv(1024, seed=9, dtype="float32", b=3, h=1)
    q, k, v = tq[:, 0], tk[:, 0], tv[:, 0]
    valid = torch.from_numpy((np.random.default_rng(9).random((3, 1024)) < 0.5).astype(np.int32))
    got = tda.decode_attention_bhsd(q, k, v, valid, scale=0.2)
    assert torch.equal(got, tref.decode_attention_ref(q, k, v, valid, scale=0.2))
    assert tda.decode_attention_bhsd.launches == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,h,s,hd,n_valid", [(2, 4, 512, 64, 512), (2, 4, 1024, 64, 701),
                                              (2, 4, 2048, 64, 2), (2, 4, 512, 64, 0),
                                              (4, 32, 1024, 128, 528), (1, 2, 300, 48, 17)])
def test_kernel_matches_plain_on_card(cuda_device, b, h, s, hd, n_valid, dtype):
    _, (tq, tk, tv) = _qkv(s, seed=s + hd, dtype=dtype, b=b, h=h, hd=hd)
    q, k, v = (x.reshape(b * h, -1, hd).to(cuda_device) for x in (tq, tk, tv))
    valid = (torch.arange(s, device=cuda_device) < n_valid).to(torch.int32)
    valid = valid[None].expand(b * h, s).contiguous()
    tda.reset_launches()
    got = tda.decode_attention_bhsd(q, k, v, valid, scale=hd**-0.5)
    torch.cuda.synchronize()
    assert tda.decode_attention_bhsd.launches == 1
    want = tda.decode_attention_torch(q, k, v, valid, scale=hd**-0.5)
    tol = _tol(dtype)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _card_operands(device, bh: int, s: int, hd: int, dtype: str, seed: int):
    _, (tq, tk, tv) = _qkv(s, seed=seed, dtype=dtype, b=1, h=bh, hd=hd)
    return [x.reshape(bh, -1, hd).to(device) for x in (tq, tk, tv)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hd", tda.SUPPORTED_HD)
@pytest.mark.parametrize("kind", ["prefix", "ring", "scattered", "one_key_tiles", "no_valid_rows"])
def test_every_instance_matches_plain_on_card(cuda_device, kind, hd, dtype):
    """Every templated hd of the bf16 tiled instance (and the float32
    instance at the same hd) on the masks of ``test_torch_decode_tiles``,
    against the plain version at ``_tol``; bf16 also against
    ``decode_attention_tiled_ref`` at 1e-3 + 1e-2 |want|."""
    from test_torch_decode_tiles import _masks  # (that module imports this one)

    q, k, v = _card_operands(cuda_device, 8, 1024, hd, dtype, seed=hd)
    valid = torch.from_numpy(_masks(kind, np.random.default_rng(hd))).to(cuda_device)
    tda.reset_launches()
    got = tda.decode_attention_bhsd(q, k, v, valid, scale=hd**-0.5)
    torch.cuda.synchronize()
    assert tda.decode_attention_bhsd.launches == 1
    assert torch.isfinite(got).all()
    want = tda.decode_attention_torch(q, k, v, valid, scale=hd**-0.5)
    tol = _tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if dtype == "bfloat16":
        tiled = tref.decode_attention_tiled_ref(q, k, v, valid, scale=hd**-0.5)
        torch.testing.assert_close(got.float(), tiled.float(), atol=1e-3, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", tda.SUPPORTED_HD)
def test_fully_masked_tiles_are_never_read_on_card(cuda_device, hd):
    """NaN in k and v of every 64-key tile with no valid key, in rows that
    have one: the bf16 kernel's output is finite and equals the plain
    version on the same operands with those slots zeroed."""
    bh, s = 128, 1024
    q, k, v = _card_operands(cuda_device, bh, s, hd, "bfloat16", seed=3 * hd)
    rng = np.random.default_rng(hd)
    valid = np.zeros((bh, s), np.int32)
    for r in range(bh):
        n = int(rng.integers(1, s))
        valid[r, (int(rng.integers(0, s)) + np.arange(n)) % s] = 1  # a ring run
    valid[::7] = rng.random((len(valid[::7]), s)) < 0.05  # scattered rows
    valid[::7, 0] = 1
    valid = torch.from_numpy(valid).to(cuda_device)
    dead = (~valid.view(bh, s // 64, 64).bool().any(-1)).repeat_interleave(64, dim=1)
    assert dead.any()
    k_nan, v_nan = k.clone(), v.clone()
    k_nan[dead], v_nan[dead] = float("nan"), float("nan")
    got = tda.decode_attention_bhsd(q, k_nan, v_nan, valid, scale=hd**-0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    k0, v0 = k.clone(), v.clone()
    k0[dead], v0[dead] = 0, 0
    want = tda.decode_attention_torch(q, k0, v0, valid, scale=hd**-0.5)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
