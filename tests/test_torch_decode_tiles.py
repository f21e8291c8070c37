"""The arithmetic of K4's bf16 tiled instance, on the CPU.

``ref.decode_attention_tiled_ref`` repeats what the CUDA kernel computes:
64-key tiles, a tile with no valid key never read, splits that own
interleaved tiles (``ref.decode_split_plan``, or a given count), an online
softmax per split in which a masked key is selected out, the merge in split
order, and the mean of v for a row with no valid slot.  It is held against
the JAX package's Pallas ``decode_attention_bhsd`` in interpret mode and its
``ref.decode_attention_ref``, with inputs drawn by numpy, at the tolerance
of ``tests/test_kernels.py``'s decode sweep (2e-2 for bf16, 2e-4 for
float32, absolute and relative), on every mask layout the served caches
make and on the edges of the skip rule.  The ``cuda``-marked tests of
``test_torch_decode_attention.py`` hold the kernel itself to it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_bhsd as jdecode
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ref as tref

from test_torch_decode_attention import DTYPES, _f32, _tol

BH, S = 8, 1024
TILE = tref.DECODE_TILE


def _masks(kind: str, rng: np.random.Generator) -> np.ndarray:
    """(BH, S) int32 masks; every row differs."""
    valid = np.zeros((BH, S), np.int32)
    if kind == "prefix":
        for r, n in enumerate([528, 1, 64, 65, 1024, 700, 129, 300]):
            valid[r, :n] = 1
    elif kind == "ring":  # a run of n slots from `start`, wrapping past S
        for r, (start, n) in enumerate([(900, 528), (1000, 100), (0, 1024), (1023, 2),
                                        (960, 64), (512, 600), (37, 990), (700, 1)]):
            valid[r, (start + np.arange(n)) % S] = 1
    elif kind == "scattered":
        valid[:] = rng.random((BH, S)) < 0.3
        valid[3] = rng.random(S) < 0.01
    elif kind == "one_key_tiles":  # tiles holding exactly one valid key
        valid[0, :129] = 1  # tile 2 holds key 128 alone
        valid[1, 700] = 1
        valid[2, [0, 3 * TILE + 63, 9 * TILE]] = 1
        for r in range(3, BH):
            valid[r, r * TILE + r] = 1
            valid[r, :r] = 1
    elif kind == "no_valid_rows":
        valid[:] = rng.random((BH, S)) < 0.4
        valid[1] = 0
        valid[5] = 0
    else:
        raise ValueError(kind)
    return valid


def _operands(kind: str, dtype: str, hd: int, seed: int):
    """numpy draws of q (BH,1,hd), k, v (BH,S,hd) and the mask; the
    ``garbage`` case puts +-1e4 in every masked slot of k and v."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BH, 1, hd), dtype=np.float32)
    k = rng.standard_normal((BH, S, hd), dtype=np.float32)
    v = rng.standard_normal((BH, S, hd), dtype=np.float32)
    valid = _masks("prefix" if kind == "garbage" else kind, rng)
    if kind == "garbage":
        masked = valid == 0
        for x in (k, v):
            x[masked] = rng.choice(np.float32([-1e4, 1e4]), size=(int(masked.sum()), hd))
    jdt, tdt = DTYPES[dtype]
    tq = [torch.from_numpy(x).to(tdt) for x in (q, k, v)]
    jq = [jnp.asarray(t.float().numpy()).astype(jdt) for t in tq]
    return jq, tq, valid


MASKS = ["prefix", "ring", "scattered", "one_key_tiles", "no_valid_rows", "garbage"]


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", MASKS)
def test_tiled_ref_matches_jax(kind, dtype, hd):
    (jq, jk, jv), (tq, tk, tv), valid = _operands(kind, dtype, hd, seed=hd + len(kind))
    scale = hd**-0.5
    pallas = jdecode(jq, jk, jv, jnp.asarray(valid), scale=scale, interpret=True)
    oracle = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(valid), scale=scale)
    tol = _tol(dtype)
    tvalid = torch.from_numpy(valid)
    # the plan's split count (one tile a split at BH 8), and splits of
    # several tiles each, with a ragged last split
    for nsplit in (None, 1, 3):
        got = tref.decode_attention_tiled_ref(tq, tk, tv, tvalid, scale=scale, nsplit=nsplit)
        assert got.dtype == tq.dtype and got.shape == tq.shape
        assert torch.isfinite(got).all()
        for want in (pallas, oracle):
            np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    if kind == "no_valid_rows":
        for r in (1, 5):
            np.testing.assert_allclose(_f32(got)[r, 0], _f32(tv)[r].mean(0), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fully_masked_tiles_are_never_read(dtype):
    """NaN in k and v of every tile with no valid key of a row that has one:
    the tiled version stays finite and equals itself, and the plain version,
    on the same operands with those slots zeroed."""
    _, (tq, tk, tv), valid = _operands("scattered", dtype, 64, seed=11)
    valid[:, 5 * TILE:9 * TILE] = 0  # four fully masked tiles in every row
    valid[2, TILE:] = 0
    tvalid = torch.from_numpy(valid)
    dead = ~tvalid.view(BH, S // TILE, TILE).any(-1)  # (BH, tiles)
    dead_slots = dead.repeat_interleave(TILE, dim=1)
    nan_k, nan_v = tk.clone(), tv.clone()
    nan_k[dead_slots], nan_v[dead_slots] = float("nan"), float("nan")
    zero_k, zero_v = tk.clone(), tv.clone()
    zero_k[dead_slots], zero_v[dead_slots] = 0, 0
    for nsplit in (None, 1, 3):
        got = tref.decode_attention_tiled_ref(tq, nan_k, nan_v, tvalid, scale=0.125, nsplit=nsplit)
        assert torch.isfinite(got).all()
        zeroed = tref.decode_attention_tiled_ref(tq, zero_k, zero_v, tvalid, scale=0.125,
                                                 nsplit=nsplit)
        assert torch.equal(got, zeroed)
        plain = tda.decode_attention_torch(tq, zero_k, zero_v, tvalid, scale=0.125)
        np.testing.assert_allclose(_f32(got), _f32(plain), atol=_tol(dtype), rtol=_tol(dtype))
    # the oracle reads them: 0 * NaN
    assert not torch.isfinite(tda.decode_attention_torch(tq, nan_k, nan_v, tvalid, scale=0.125)).all()


@pytest.mark.parametrize("bh,s", [(128, 1024), (8, 1024), (64, 1024), (16, 1024), (4, 300),
                                  (1, 64), (1, 1), (2, 200_000), (1, 5_000_000), (1024, 512)])
def test_split_plan(bh, s):
    """Every tile belongs to exactly one split; the splits fill ~132 blocks,
    never more than one a tile, and no split owns more than 1024 tiles (the
    kernel's mask words in shared memory)."""
    ntiles, nsplit = tref.decode_split_plan(bh, s)
    assert ntiles == -(-s // TILE)
    assert 1 <= nsplit <= ntiles
    assert -(-ntiles // nsplit) <= tref.DECODE_MAX_SPLIT_TILES
    assert nsplit == ntiles or bh * nsplit <= tref.DECODE_BLOCKS or nsplit == -(-ntiles // 1024)
    owned = sorted(t for sp in range(nsplit) for t in range(sp, ntiles, nsplit))
    assert owned == list(range(ntiles))
    assert tda.workspace_floats(bh, s, 128, torch.bfloat16) == bh * nsplit * 130 + bh
    assert tda.workspace_floats(bh, s, 128, torch.float32) == bh * -(-s // 256) * 130
    assert tda.workspace_floats(bh, s, 96, torch.bfloat16) == bh * -(-s // 256) * 98


@pytest.mark.parametrize("bh,nsplit,live", [(128, 1, [9]), (64, 2, [5, 4]),
                                            (16, 8, [2, 1, 1, 1, 1, 1, 1, 1])])
def test_served_decode_plans(bh, nsplit, live):
    """At the timed decode shapes (S 1024, 528 valid): deepseek_7b's BH 128
    reads 9 of 16 tiles in one split a row; granite_moe_1b's BH 64 and
    gemma3_1b's BH 16 spread the 9 over 2 and 8 splits."""
    ntiles, got = tref.decode_split_plan(bh, 1024)
    assert (ntiles, got) == (16, nsplit)
    assert [sum(1 for t in range(sp, ntiles, got) if t * TILE < 528) for sp in range(got)] == live


def test_instance_is_picked_by_dtype_and_hd_alone():
    for hd in tda.SUPPORTED_HD:
        assert tda.uses_tiled_instance(torch.bfloat16, hd)
        assert not tda.uses_tiled_instance(torch.float32, hd)
    assert not tda.uses_tiled_instance(torch.bfloat16, 96)
