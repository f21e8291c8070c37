"""The port's encoder-decoder (whisper) model against the JAX package.

Params come from the JAX package's ``model.init`` and reach the port through
``params_from_numpy``; batches come from both packages' ``make_batch``
(equal bit for bit, the bf16 frames included).  On whisper_medium's smoke
config: the param tree's layout, ``sinusoid``, ``encode``, ``cross_kv``,
the prefill logits and caches, 20 decode steps past a 16-token prompt (the
self-cache is a ring as long as the prompt, so it wraps), the loss, the
``init_cache`` layout, and remat ``block`` against ``none``.  Each decode
step runs twice in the port: from the reference's cache of that step, so
that it is held alone, and chained from the port's own cache, whose greedy
tokens must equal the reference's.  Then the smoke config widened to hd 64
with ``attn_impl="pallas"``: the JAX package's Pallas kernel in interpret
mode against the port's kernel through its plain version.

Tolerances, as in ``test_torch_serving.py``: float32 1e-4 absolute; bf16
2e-2 of the largest |want|, and each bf16 cache leaf within 2e-2 of its norm.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.data.synthetic import make_batch as jmake_batch
from repro.models import model_for as jmodel_for
from repro.models import whisper as jwhisper
from repro_torch.checkpoint import manager as tckpt
from repro_torch.configs import get_config, get_smoke
from repro_torch.data.synthetic import make_batch
from repro_torch.models import model_for, params_from_numpy
from repro_torch.models import whisper as twhisper
from repro_torch.models.params import tree_leaves_with_path, tree_unflatten
from repro_torch.train.step import init_train_state

ARCH = "whisper_medium"
B, T, STEPS = 2, 16, 20
DTYPES = ["float32", "bfloat16"]
# whisper_medium_smoke widened to hd 64, a K3 instance
HD64 = dict(d_model=128, n_heads=2, n_kv_heads=2)


def _cfgs(dtype: str, **over):
    over = {"compute_dtype": dtype, **over}
    return dataclasses.replace(jget_smoke(ARCH), **over), dataclasses.replace(get_smoke(ARCH), **over)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().copy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _jleaves(tree) -> list[np.ndarray]:
    return [_f32(x) for x in jax.tree.leaves(tree)]


def _tleaves(tree) -> list[np.ndarray]:
    # copies: a later decode step writes the port's cache in place
    return [_f32(x) for _, x in tckpt._leaf_paths(tree)]


def _assert_close(want, got, dtype):
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    assert want.shape == got.shape
    atol = 1e-4 if dtype == "float32" else 2e-2 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _assert_leaves_close(want, got, dtype):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        if dtype == "float32":
            _assert_close(w, g, dtype)
        else:  # bf16 rounding drifts with depth: hold the leaf as a whole
            assert w.shape == g.shape
            assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w)


def _jit(fn, dtype: str):
    """float32: one compile of the reference call.  bf16: eager, so that each
    op rounds to bf16 as in PyTorch (a jit's fusions may keep whole chains in
    float32)."""
    return jax.jit(fn) if dtype == "float32" else fn


def _run_both(dtype: str, **over) -> dict:
    """Prefill of a 16-token prompt and 20 greedy decode steps in both
    packages, from the same params and batch."""
    jcfg, tcfg = _cfgs(dtype, **over)
    jm, tm = jmodel_for(jcfg), model_for(tcfg)
    params = jm.init(jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    jbatch = jmake_batch(jcfg, T, B, kind="prefill", seed=1)
    tbatch = make_batch(tcfg, T, B, kind="prefill", seed=1, device="cpu")
    jl, jc = _jit(jm.prefill, dtype)(params, jbatch)
    tl, tc = tm.prefill(tparams, tbatch, cache_len=T + STEPS)
    out = {"prefill": (_f32(jl), _f32(tl)), "cache": (_jleaves(jc), _tleaves(tc)),
           "single": [], "chained": [], "tokens": ([], [])}
    jdecode = _jit(jm.decode_step, dtype)
    jtok = jnp.argmax(jl[:, -1], axis=-1).astype(jnp.int32)
    ttok = tl[:, -1].argmax(dim=-1).to(torch.int32)
    for k in range(1, STEPS + 1):
        pos = T + k - 1
        jc_before = jax.tree.map(np.asarray, jc)
        jl, jc = jdecode(params, {"tokens": jtok[:, None], "pos": jnp.asarray(pos, jnp.int32)}, jc)
        # from the reference's cache: this step alone
        sl, sc = tm.decode_step(tparams, {"tokens": torch.from_numpy(np.array(jtok))[:, None],
                                          "pos": pos}, params_from_numpy(jc_before, "cpu"))
        out["single"].append(((_f32(jl), _jleaves(jc)), (_f32(sl), _tleaves(sc))))
        # chained from the port's own cache
        tl, tc = tm.decode_step(tparams, {"tokens": ttok[:, None], "pos": pos}, tc)
        out["chained"].append((_f32(jl), _f32(tl)))
        jtok = jnp.argmax(jl[:, -1], axis=-1).astype(jnp.int32)
        ttok = tl[:, -1].argmax(dim=-1).to(torch.int32)
        out["tokens"][0].append(np.asarray(jtok).tolist())
        out["tokens"][1].append(ttok.tolist())
    return out


@pytest.fixture(scope="module")
def runs():
    memo = {}

    def get(dtype, **over):
        key = (dtype, tuple(sorted(over.items())))
        if key not in memo:
            memo[key] = _run_both(dtype, **over)
        return memo[key]

    return get


@pytest.fixture(scope="module")
def shared():
    """Params and a frames batch of the smoke config, in both packages."""
    jcfg, tcfg = _cfgs("float32")
    params = jmodel_for(jcfg).init(jax.random.key(0))
    return {"params": params,
            "tparams": params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
            "jbatch": jmake_batch(jcfg, T, B, kind="prefill", seed=1),
            "tbatch": make_batch(tcfg, T, B, kind="prefill", seed=1, device="cpu")}


# ----------------------------------------------------------------------
# layout
# ----------------------------------------------------------------------
def test_param_tree_layout_matches_jax():
    """Paths, shapes and dtypes of the port's init equal the reference's
    (the draws differ and are never compared)."""
    jcfg, tcfg = _cfgs("float32")
    jtree = jax.eval_shape(jmodel_for(jcfg).init, jax.random.key(0))
    jlayout = [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path),
                tuple(x.shape), str(x.dtype))
               for path, x in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    ttree = model_for(tcfg).init(torch.Generator().manual_seed(0))
    tlayout = [(path, tuple(x.shape), str(x.dtype).split(".")[1])
               for path, x in tree_leaves_with_path(ttree)]
    assert tlayout == jlayout
    assert {p[0] for p, _, _ in tlayout} == {"frontend_proj", "embed", "enc_layers", "enc_norm",
                                             "dec_layers", "final_norm"}


def test_init_cache_layout_matches_jax():
    jcfg, tcfg = _cfgs("float32")
    jc = jax.tree.leaves(jmodel_for(jcfg).init_cache(B, 24))
    tc = [x for _, x in tckpt._leaf_paths(model_for(tcfg).init_cache(B, 24, device="cpu"))]
    assert [(x.shape, str(x.dtype)) for x in jc] == \
        [(tuple(x.shape), str(x.dtype).split(".")[1]) for x in tc]
    assert all(not x.any() for x in tc)


def test_full_config_builds_with_the_rough_param_count():
    """whisper_medium's model builds in the port; ``param_count`` stays the
    reference's rough enc-dec count, below the tree's 759,592,960."""
    cfg = get_config(ARCH)
    model = model_for(cfg)
    assert model.cfg is cfg and cfg.hd == 64
    assert cfg.param_count() == 707_594_240


# 1e-6 at the smoke config's positions (encoder ctx 32, decoder up to 40).
# At whisper_medium's encoder ctx 1500 the two packages' float32 ``exp`` may
# give a frequency one ulp apart (2^-23 of it, at most 1), which moves the
# angle at position p by up to p 2^-23: 1.8e-4 at p 1500.
@pytest.mark.parametrize("n,dim,atol", [(32, 96, 1e-6), (40, 128, 1e-6),
                                        (1500, 1024, 1500 * 2**-23)])
def test_sinusoid_matches_jax(n, dim, atol):
    pos = np.arange(n)
    want = np.asarray(jwhisper.sinusoid(jnp.asarray(pos), dim, jnp.float32))
    got = twhisper.sinusoid(torch.from_numpy(pos), dim, torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    # (B, T) positions as the decoder passes them, and the cast
    pos2 = np.stack([pos, pos[::-1]])
    want = jwhisper.sinusoid(jnp.asarray(pos2), dim, jnp.bfloat16)
    got = twhisper.sinusoid(torch.from_numpy(pos2.copy()), dim, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-2, rtol=0)


# ----------------------------------------------------------------------
# encoder, cross K/V, prefill, decode, loss
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_and_cross_kv_match_jax(shared, dtype):
    jcfg, tcfg = _cfgs(dtype)
    want = jwhisper.encode(shared["params"], jcfg, shared["jbatch"]["frames"])
    got = twhisper.encode(shared["tparams"], tcfg, shared["tbatch"]["frames"])
    assert got.dtype == getattr(torch, dtype)
    _assert_close(_f32(want), _f32(got), dtype)
    jkv = jwhisper.cross_kv(shared["params"], jcfg, want)
    tkv = twhisper.cross_kv(shared["tparams"], tcfg, got)
    assert isinstance(tkv, tuple) and len(tkv) == 2
    for w, g in zip(jkv, tkv):
        assert tuple(g.shape) == (tcfg.n_layers, B, tcfg.n_kv_heads, tcfg.encdec.encoder_ctx,
                                  tcfg.hd)
        _assert_close(_f32(w), _f32(g), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("what", ["prefill", "cache"])
def test_prefill_matches_jax(runs, dtype, what):
    want, got = runs(dtype)[what]
    if what == "cache":
        _assert_leaves_close(want, got, dtype)
        # {"cross": (kx, vx), "self": {"k", "v"}}: the self-cache is the prompt's own K/V
        assert got[2].shape[3] == T
    else:
        _assert_close(want, got, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_steps_from_the_reference_cache_match_jax(runs, dtype):
    """Each of 20 steps (pos 16-35) alone: logits and the updated caches."""
    steps = runs(dtype)["single"]
    assert len(steps) == STEPS
    for (jl, jc), (tl, tc) in steps:
        _assert_close(jl, tl, dtype)
        _assert_leaves_close(jc, tc, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_chained_decode_wraps_the_ring_and_matches_jax(runs, dtype):
    """20 chained steps past a 16-token prompt: the ring wraps after 16, the
    logits stay within tolerance and the greedy tokens are equal."""
    res = runs(dtype)
    for want, got in res["chained"]:
        assert np.isfinite(got).all()
        _assert_close(want, got, dtype)
    assert res["tokens"][1] == res["tokens"][0]


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_matches_jax(dtype):
    jcfg, tcfg = _cfgs(dtype)
    params = jmodel_for(jcfg).init(jax.random.key(2))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    jbatch = jmake_batch(jcfg, 24, B, kind="train", seed=5)
    tbatch = make_batch(tcfg, 24, B, kind="train", seed=5, device="cpu")
    # mask some labels, as padding does
    drop = np.random.default_rng(6).random((B, 24)) < 0.2
    jbatch["labels"] = jnp.where(jnp.asarray(drop), -1, jbatch["labels"])
    tbatch["labels"] = torch.where(torch.from_numpy(drop), -1, tbatch["labels"])
    jloss, jmet = _jit(jmodel_for(jcfg).loss, dtype)(params, jbatch)
    tloss, tmet = model_for(tcfg).loss(tparams, tbatch)
    rel = 1e-5 if dtype == "float32" else 2e-3
    assert float(tloss) == pytest.approx(float(jloss), rel=rel)
    assert int(tmet["tokens"]) == int(jmet["tokens"])
    assert float(tmet["aux"]) == 0.0


# ----------------------------------------------------------------------
# attn_impl="pallas" at hd 64
# ----------------------------------------------------------------------
@pytest.mark.parametrize("what", ["prefill", "cache", "decode", "tokens"])
def test_pallas_route_at_hd64_matches_the_pallas_kernel(runs, what):
    """The decoder's prefill self-attention through the JAX package's Pallas
    kernel (interpret mode) and the port's K3 route (its plain version on the
    CPU), in float32; decode runs attend_decode_plus_new in both."""
    res = runs("float32", attn_impl="pallas", **HD64)
    if what == "decode":
        for want, got in res["chained"]:
            _assert_close(want, got, "float32")
    elif what == "tokens":
        assert res["tokens"][1] == res["tokens"][0]
    elif what == "cache":
        _assert_leaves_close(*res["cache"], "float32")
    else:
        _assert_close(*res["prefill"], "float32")


def test_prefill_ignores_cache_len():
    _, tcfg = _cfgs("float32")
    m = model_for(tcfg)
    params = m.init(torch.Generator().manual_seed(1))
    batch = make_batch(tcfg, T, B, kind="prefill", seed=2, device="cpu")
    l1, c1 = m.prefill(params, batch)
    l2, c2 = m.prefill(params, batch, cache_len=T + 40)
    assert torch.equal(l1, l2)
    assert c1["self"]["k"].shape == c2["self"]["k"].shape == (tcfg.n_layers, B, tcfg.n_kv_heads,
                                                               T, tcfg.hd)


# ----------------------------------------------------------------------
# remat (test_torch_train.py holds its gradients bit for bit against none)
# ----------------------------------------------------------------------
def _saved_tensors(fn) -> int:
    count = [0]

    def pack(x):
        count[0] += 1
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        fn()
    return count[0]


def test_remat_block_wraps_the_decoder_layers_only():
    """Under remat "block" the forward keeps each decoder layer's input only,
    and the encoder, which the reference does not wrap, keeps all it saves."""
    _, tcfg = _cfgs("float32")
    params, _ = init_train_state(tcfg, torch.Generator().manual_seed(0))
    batch = make_batch(tcfg, 24, B, kind="train", seed=3, device="cpu")
    live = tree_unflatten(params, [p.detach().requires_grad_()
                                   for _, p in tree_leaves_with_path(params)])
    saved = {remat: _saved_tensors(
        lambda remat=remat: model_for(dataclasses.replace(tcfg, remat=remat)).loss(live, batch))
        for remat in ("block", "none")}
    encoder = _saved_tensors(lambda: twhisper.encode(live, tcfg, batch["frames"]))
    assert encoder < saved["block"] < saved["none"], (encoder, saved)
    assert saved["block"] - encoder < (saved["none"] - encoder) / 2, (encoder, saved)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.cuda
def test_pallas_route_on_card_matches_cpu(cuda_device):
    """The hd-64 variant in float32 with K3 on the card: its prefill logits
    and self-cache equal the CPU path's within 1e-4, with one K3 launch a
    decoder layer."""
    from repro_torch.kernels import flash_attention as tfa

    _, tcfg = _cfgs("float32", attn_impl="pallas", **HD64)
    m = model_for(tcfg)
    params = m.init(torch.Generator().manual_seed(0))
    batch = make_batch(tcfg, T, B, kind="prefill", seed=1, device="cpu")
    want, wcache = m.prefill(params, batch)
    on_card = [p.to(cuda_device) for _, p in tree_leaves_with_path(params)]
    tfa.reset_launches()
    got, gcache = m.prefill(tree_unflatten(params, on_card),
                            {k: v.to(cuda_device) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert tfa.flash_attention_bhtd.launches == tcfg.n_layers
    _assert_close(_f32(want), _f32(got.cpu()), "float32")
    _assert_close(_f32(wcache["self"]["k"]), _f32(gcache["self"]["k"].cpu()), "float32")
