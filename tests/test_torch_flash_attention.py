"""Port kernel K3 (flash attention) and the attention impls against the JAX package.

On the CPU the port's ``ops.flash_attention`` runs the kernel's plain
version (the full-matrix oracle); it is held against the JAX package's
Pallas kernel in interpret mode and against its ``ref.flash_attention_ref``
on the sweep of ``tests/test_kernels.py``, with inputs drawn by numpy, at
that file's tolerances (2e-2 for bf16, 2e-4 for float32).  The CUDA kernel
is held against the plain version by the ``cuda``-marked test, which runs
only where a card is present.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

SWEEP = [
    (2, 4, 256, 64, None),
    (1, 2, 512, 64, None),
    (2, 2, 256, 128, None),
    (1, 4, 256, 64, 64),
    (1, 1, 128, 32, 32),
]
# head dims beyond 32/64/128 that configs use: stablelm_12b_smoke 16,
# gemma3_1b_smoke 48, stablelm_12b 160, gemma3_1b 256 (with a window)
NEW_HD = [(2, 2, 256, 16, None), (1, 2, 256, 48, None), (1, 2, 128, 160, None),
          (1, 2, 128, 256, None), (1, 1, 256, 256, 64)]
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}


def _tol(dtype: str) -> float:
    return 2e-2 if dtype == "bfloat16" else 2e-4


def _qkv(shape, seed: int, dtype: str):
    """numpy f32 draws, rounded once to ``dtype``; the same values go to both packages."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    arrs = [rng.standard_normal(shape, dtype=np.float32) for _ in range(3)]
    tq = [torch.from_numpy(a).to(tdt) for a in arrs]
    jq = [jnp.asarray(t.float().numpy()).astype(jdt) for t in tq]
    return jq, tq


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,h,t,hd,window", SWEEP + NEW_HD)
def test_flash_attention_matches_jax(b, h, t, hd, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv((b, h, t, hd), seed=b * 100 + t + hd, dtype=dtype)
    scale = hd**-0.5
    got = tops.flash_attention(tq, tk, tv, scale=scale, window=window)
    assert got.dtype == tq.dtype and got.shape == (b, h, t, hd)
    pallas = jops.flash_attention(jq, jk, jv, scale=scale, window=window, interpret=True)
    oracle = jref.flash_attention_ref(
        jq.reshape(b * h, t, hd), jk.reshape(b * h, t, hd), jv.reshape(b * h, t, hd),
        scale=scale, window=window,
    ).reshape(b, h, t, hd)
    tol = _tol(dtype)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_fully_masked_rows_give_no_nan():
    """With window 16 and 128-row tiles, rows 143..255 see an all-masked first
    live tile; the Pallas kernel's finite NEG_INF keeps them finite."""
    (jq, jk, jv), (tq, tk, tv) = _qkv((1, 2, 256, 64), seed=5, dtype="float32")
    got = tops.flash_attention(tq, tk, tv, scale=0.125, window=16)
    pallas = jops.flash_attention(jq, jk, jv, scale=0.125, window=16, interpret=True)
    assert torch.isfinite(got).all()
    assert np.isfinite(np.asarray(pallas)).all()
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize(
    "shape,window",
    [((2, 200, 64), None), ((2, 384, 64), 0), ((2, 64, 64), -3)],
    ids=["T_not_multiple_of_bq", "window_0", "window_negative"],
)
def test_wrapper_rejects_what_the_pallas_wrapper_rejects(shape, window):
    q = torch.zeros(shape)
    with pytest.raises(ValueError):
        tfa.flash_attention_bhtd(q, q, q, scale=0.1, window=window)


# hd 24 is whisper_medium_smoke's (not a multiple of 16); 40 and 512 are
# multiples of 16 that no config uses
@pytest.mark.parametrize(
    "hd,dtype", [(24, torch.float32), (40, torch.bfloat16), (512, torch.bfloat16),
                 (64, torch.float16), (128, torch.float64)],
)
def test_kernel_rejects_unsupported_head_dim_and_dtype(hd, dtype):
    q = torch.zeros((2, 128, hd), dtype=dtype)
    with pytest.raises(ValueError):
        tfa.check_kernel_operands(q, q, q)


def test_kernel_takes_every_head_dim_the_configs_use():
    """Every attention config's head dim is a kernel instance, whisper_medium's
    64 included, but whisper_medium_smoke's 24 (not a multiple of 16), whose
    config attends through ``full``."""
    from repro_torch.configs.base import ARCH_IDS
    from repro_torch.configs import get_config, get_smoke

    cfgs = [get(a) for a in ARCH_IDS for get in (get_config, get_smoke) if get(a).n_heads]
    off = [c for c in cfgs if c.hd not in tfa.SUPPORTED_HD]
    assert [(c.name, c.hd, c.attn_impl) for c in off] == [("whisper_medium_smoke", 24, "full")]
    hds = {c.hd for c in cfgs if c not in off}
    assert hds <= set(tfa.SUPPORTED_HD)
    assert hds == {16, 32, 48, 64, 128, 160, 256}
    for hd in tfa.SUPPORTED_HD:
        q = torch.zeros((1, 128, hd), dtype=torch.bfloat16)
        tfa.check_kernel_operands(q, q, q)


def test_gemma3_smoke_served_with_the_kernel_matches_jax():
    """gemma3_1b_smoke (hd 48, sliding window, ring cache) served with
    attn_impl="pallas" in float32: the port's greedy tokens equal the JAX
    engine's, whose attention runs the Pallas kernel in interpret mode."""
    import dataclasses

    import jax

    from repro.configs import get_smoke as jget_smoke
    from repro.models import model_for as jmodel_for
    from repro.serving.engine import ServeEngine as JServeEngine
    from repro_torch.configs import get_smoke
    from repro_torch.models import params_from_numpy
    from repro_torch.serving.engine import ServeEngine

    over = {"attn_impl": "pallas", "compute_dtype": "float32"}
    jcfg = dataclasses.replace(jget_smoke("gemma3_1b"), **over)
    tcfg = dataclasses.replace(get_smoke("gemma3_1b"), **over)
    assert tcfg.hd == 48
    params = jmodel_for(jcfg).init(jax.random.key(8))
    jeng, teng = JServeEngine(jcfg, max_batch=2), ServeEngine(tcfg, max_batch=2, device="cpu")
    jeng.model = dataclasses.replace(
        jeng.model, prefill=jax.jit(jeng.model.prefill, static_argnames=("cache_len",)),
        decode_step=jax.jit(jeng.model.decode_step))
    jeng.set_params(params)
    teng.set_params(params_from_numpy(jax.tree.map(np.asarray, params), "cpu"))
    rng = np.random.default_rng(8)
    for n in (32, 25):  # the 25-token prompt is left-padded
        prompt = rng.integers(0, jcfg.vocab_size, size=n)
        jeng.submit(prompt, 5)
        teng.submit(prompt, 5)
    want, got = jeng.step_batch(), teng.step_batch()
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(len(r.out_tokens) == 5 for r in got)


def test_plain_version_is_the_oracle_and_launches_stay_zero():
    tfa.reset_launches()
    (_, _, _), (tq, tk, tv) = _qkv((3, 128, 32), seed=9, dtype="float32")
    got = tfa.flash_attention_bhtd(tq, tk, tv, scale=0.2, window=40)
    assert torch.equal(got, tref.flash_attention_ref(tq, tk, tv, scale=0.2, window=40))
    assert tfa.flash_attention_bhtd.launches == 0


@pytest.mark.parametrize("impl", ["full", "chunked", "pallas"])
@pytest.mark.parametrize("t,window,chunk", [(96, None, 32), (96, 20, 32), (80, 24, 32)])
def test_attention_impls_match_jax(impl, t, window, chunk):
    """The port's three prefill impls against the JAX package's same impl."""
    (jq, jk, jv), (tq, tk, tv) = _qkv((2, 3, t, 32), seed=t + (window or 0), dtype="float32")
    kw = dict(impl=impl, window=window, scale=32**-0.5, chunk=chunk)
    got = tattn.attention(tq, tk, tv, q_pos=torch.arange(t), k_pos=torch.arange(t), **kw)
    want = jattn.attention(jq, jk, jv, q_pos=jnp.arange(t), k_pos=jnp.arange(t), **kw)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("fn", ["attend_decode", "attend_decode_plus_new",
                                "attend_decode_plus_new_gqa"])
def test_decode_attention_matches_jax(fn):
    """The three decode paths: one query against a cache with invalid slots."""
    rng = np.random.default_rng(11)
    b, h, hkv, s, hd = 2, 4, 2 if fn.endswith("gqa") else 4, 24, 32
    shapes = [(b, h, 1, hd), (b, hkv, s, hd), (b, hkv, s, hd), (b, hkv, 1, hd), (b, hkv, 1, hd)]
    arrs = [rng.standard_normal(sh, dtype=np.float32) for sh in shapes]
    if fn == "attend_decode":  # q against the cache alone, no separate new key
        arrs = arrs[:3]
    valid = np.arange(s) % 5 != 3
    want = getattr(jattn, fn)(*map(jnp.asarray, arrs), jnp.asarray(valid), 0.125)
    got = getattr(tattn, fn)(*map(torch.from_numpy, arrs), torch.from_numpy(valid), 0.125)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,h,t,hd,window", SWEEP + [(4, 32, 512, 128, None), (1, 2, 256, 64, 16)]
                         + NEW_HD + [(4, 4, 1024, 256, 512), (2, 8, 512, 160, None)])
def test_kernel_matches_plain_on_card(cuda_device, b, h, t, hd, window, dtype):
    _, tensors = _qkv((b * h, t, hd), seed=t + hd, dtype=dtype)
    q, k, v = (x.to(cuda_device) for x in tensors)
    tfa.reset_launches()
    got = tfa.flash_attention_bhtd(q, k, v, scale=hd**-0.5, window=window)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bhtd.launches == 1
    want = tfa.flash_attention_torch(q, k, v, scale=hd**-0.5, window=window)
    tol = _tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_kernel_on_second_card():
    """hd 128 needs more shared memory than the default, set per device: the
    kernel must launch on a second card after the first."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    _, tensors = _qkv((8, 256, 128), seed=5, dtype="bfloat16")
    for dev in ("cuda:0", "cuda:1"):
        q, k, v = (x.to(dev) for x in tensors)
        got = tfa.flash_attention_bhtd(q, k, v, scale=128**-0.5)
        want = tfa.flash_attention_torch(q, k, v, scale=128**-0.5)
        torch.testing.assert_close(got.float(), want.float(), atol=_tol("bfloat16"),
                                   rtol=_tol("bfloat16"))

