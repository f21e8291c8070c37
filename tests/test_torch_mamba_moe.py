"""The port's Mamba2 and MoE layers, and the models built of them, against the JAX package.

Inputs are drawn with numpy and handed to both packages; params come from
the JAX package's ``init`` and reach the port through ``params_from_numpy``.
Everything is compared in float32:

* the Mamba2 pieces (``causal_conv``, ``conv_step``, ``ssd_chunked`` with
  both ``intra_dtype``s, ``ssd_step``) at 1e-5 absolute, except
  ``ssd_chunked`` with ``intra_dtype="bf16"`` at 2e-2 of the largest |y|
  (its decay matrices and partial products are rounded to bf16, where XLA
  and PyTorch may round at other points);
* the router's slots and expert ids exactly, its gates and aux loss at
  1e-6 relative, ``apply_moe`` at 1e-5 absolute;
* the smoke configs of mamba2_130m, granite_moe_1b, jamba_v01_52b and
  deepseek_moe_16b: prefill logits and three decode steps from the port's
  own caches at 1e-4 absolute, the training loss and aux loss at 1e-5
  relative, and ``ServeEngine``'s greedy tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.configs import get_smoke as jget_smoke
from repro.models import mamba2 as jm2
from repro.models import model_for as jmodel_for
from repro.models import moe as jmoe
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.checkpoint import manager as tckpt
from repro_torch.configs import get_smoke
from repro_torch.models import mamba2 as tm2
from repro_torch.models import model_for, params_from_numpy, params_to_numpy
from repro_torch.models import moe as tmoe
from repro_torch.serving.engine import ServeEngine

ARCHS = ["mamba2_130m", "granite_moe_1b", "jamba_v01_52b", "deepseek_moe_16b"]
B, T, CACHE_LEN, DECODE_STEPS = 2, 24, 28, 3


def _draw(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ----------------------------------------------------------------------
# Mamba2 pieces
# ----------------------------------------------------------------------
def test_causal_conv_and_conv_step_match_jax():
    rng = np.random.default_rng(0)
    (jx, jk, js, jn), (tx, tk, ts, tn) = _both(_draw(rng, 2, 13, 24), _draw(rng, 4, 24),
                                               _draw(rng, 2, 3, 24), _draw(rng, 2, 24))
    np.testing.assert_allclose(_f32(tm2.causal_conv(tx, tk)), _f32(jm2.causal_conv(jx, jk)),
                               atol=1e-5, rtol=0)
    jy, jw = jm2.conv_step(jn, js, jk)
    ty, tw = tm2.conv_step(tn, ts, tk)
    np.testing.assert_allclose(_f32(ty), _f32(jy), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(_f32(tw), _f32(jw))


def _ssd_inputs(seed, b=2, t=50, h=4, p=8, g=2, n=6):
    rng = np.random.default_rng(seed)
    x = _draw(rng, b, t, h, p)
    dt = (np.logaddexp(_draw(rng, b, t, h), 0.0) * 0.1).astype(np.float32)
    a = -np.exp(_draw(rng, h))
    bm, cm = _draw(rng, b, t, g, n), _draw(rng, b, t, g, n)
    s0 = _draw(rng, b, h, p, n)
    return _both(x, dt, a, bm, cm, s0)


@pytest.mark.parametrize("intra_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("chunk,with_state", [(16, False), (16, True), (64, False)],
                         ids=["t_not_multiple", "init_state", "chunk_longer_than_t"])
def test_ssd_chunked_matches_jax(intra_dtype, chunk, with_state):
    (jx, jdt, ja, jb, jc, js), (tx, tdt, ta, tb, tc, ts) = _ssd_inputs(1)
    jy, jfinal = jm2.ssd_chunked(jx, jdt, ja, jb, jc, chunk=chunk, intra_dtype=intra_dtype,
                                 init_state=js if with_state else None)
    ty, tfinal = tm2.ssd_chunked(tx, tdt, ta, tb, tc, chunk=chunk, intra_dtype=intra_dtype,
                                 init_state=ts if with_state else None)
    assert ty.shape == tuple(jy.shape) and tfinal.shape == tuple(jfinal.shape)
    for want, got in ((jy, ty), (jfinal, tfinal)):
        atol = 1e-5 if intra_dtype == "f32" else 2e-2 * float(np.abs(_f32(want)).max())
        np.testing.assert_allclose(_f32(got), _f32(want), atol=atol, rtol=0)


def test_ssd_step_matches_jax():
    (jx, jdt, ja, jb, jc, js), (tx, tdt, ta, tb, tc, ts) = _ssd_inputs(2)
    jy, jst = jm2.ssd_step(jx[:, 0], jdt[:, 0], ja, jb[:, 0], jc[:, 0], js)
    ty, tst = tm2.ssd_step(tx[:, 0], tdt[:, 0], ta, tb[:, 0], tc[:, 0], ts)
    np.testing.assert_allclose(_f32(ty), _f32(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_f32(tst), _f32(jst), atol=1e-5, rtol=0)


# ----------------------------------------------------------------------
# MoE pieces
# ----------------------------------------------------------------------
# (T, E, k, capacity, skew): every config's (E, k), heavy drops and none
# (capacity T, as decode routes), T not a multiple of 32, every token
# preferring the same k experts, and one token
ROUTE_CASES = {
    "drops": (40, 8, 2, 4, False),
    "no_drops": (40, 8, 2, 40, False),
    "odd": (17, 4, 3, 6, False),
    "granite_moe_1b_drops": (300, 32, 8, 30, False),
    "granite_moe_1b_decode": (4, 32, 8, 4, False),
    "deepseek_moe_16b_drops": (200, 64, 6, 9, False),
    "deepseek_moe_16b_no_drops": (200, 64, 6, 200, False),
    "jamba_v01_52b_drops": (97, 16, 2, 6, False),
    "jamba_v01_52b_no_drops": (97, 16, 2, 97, False),
    "smoke_8_4_drops": (33, 8, 4, 8, False),
    "smoke_8_2_drops": (45, 8, 2, 5, False),
    "smoke_4_2_drops": (31, 4, 2, 3, False),
    "skew_drops": (100, 32, 8, 20, True),
    "skew_no_drops": (64, 32, 8, 64, True),
    "one_token": (1, 32, 8, 1, False),
}


@pytest.mark.parametrize("t,e,k,capacity,skew", list(ROUTE_CASES.values()), ids=list(ROUTE_CASES))
def test_route_topk_matches_jax(t, e, k, capacity, skew):
    logits = _draw(np.random.default_rng(t + e), t, e) * 2
    if skew:
        logits[:, :k] += 20 + np.arange(k, 0, -1, dtype=np.float32)
    jslot, jgate, jeids, jaux = jmoe.route_topk(jnp.asarray(logits), k, capacity)
    tslot, tgate, teids, taux = tmoe.route_topk(torch.from_numpy(logits), k, capacity)
    assert tslot.dtype == torch.int32 and teids.dtype == torch.int32
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(teids.numpy(), np.asarray(jeids))
    np.testing.assert_allclose(tgate.numpy(), np.asarray(jgate), rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    dropped = int((tslot.numpy() == e * capacity).sum())
    assert (dropped > 0) == (capacity < t)


@pytest.mark.parametrize("arch", ["granite_moe_1b", "deepseek_moe_16b"])
@pytest.mark.parametrize("t", [12, 1], ids=["prefill", "decode"])
def test_apply_moe_matches_jax(arch, t):
    """granite: 8 experts top-4; deepseek: top-2 with two shared experts."""
    cfg = jget_smoke(arch)
    p = jmoe.init_moe(jax.random.key(5), cfg)
    x = _draw(np.random.default_rng(t), 3, t, cfg.d_model)
    jy, jaux = jmoe.apply_moe(p, jnp.asarray(x), cfg)
    ty, taux = tmoe.apply_moe(params_from_numpy(jax.tree.map(np.asarray, p), "cpu"),
                              torch.from_numpy(x), get_smoke(arch))
    np.testing.assert_allclose(_f32(ty), _f32(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


# ----------------------------------------------------------------------
# The four smoke models
# ----------------------------------------------------------------------
def _cfgs(arch):
    over = {"compute_dtype": "float32"}
    return dataclasses.replace(jget_smoke(arch), **over), dataclasses.replace(get_smoke(arch), **over)


def _run_both(arch: str) -> dict:
    jcfg, tcfg = _cfgs(arch)
    jm, tm = jmodel_for(jcfg), model_for(tcfg)
    params = jm.init(jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    labels = np.where(rng.random((B, T)) < 0.2, -1, toks).astype(np.int32)
    out = {}
    jloss, jmet = jax.jit(jm.loss)(params, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tloss, tmet = tm.loss(tparams, {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    out["loss"] = ([float(jloss), float(jmet["aux"])], [float(tloss), float(tmet["aux"])])
    jl, jc = jax.jit(jm.prefill, static_argnames=("cache_len",))(
        params, {"tokens": jnp.asarray(toks)}, cache_len=CACHE_LEN)
    tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)}, cache_len=CACHE_LEN)
    out["prefill"] = (_f32(jl), _f32(tl))
    # each package decodes from its own caches (the port writes them in place)
    jdec, tdec = jax.jit(jm.decode_step), []
    want, got = [], []
    nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    for k in range(DECODE_STEPS):
        jl2, jc = jdec(params, {"tokens": jnp.asarray(nxt), "pos": jnp.asarray(T + k, jnp.int32)}, jc)
        tl2, tc = tm.decode_step(tparams, {"tokens": torch.from_numpy(nxt), "pos": T + k}, tc)
        want.append(_f32(jl2))
        got.append(_f32(tl2))
        nxt = np.array(jnp.argmax(jl2[:, -1], axis=-1), np.int32)[:, None]
    out["decode"] = (np.stack(want), np.stack(got))
    return out


@pytest.fixture(scope="module")
def runs():
    memo = {}

    def get(arch):
        if arch not in memo:
            memo[arch] = _run_both(arch)
        return memo[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("what", ["prefill", "decode", "loss"])
def test_smoke_model_matches_jax(runs, arch, what):
    want, got = runs(arch)[what]
    if what == "loss":  # total (ce + aux_loss_weight * aux), aux
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        assert (want[1] > 0) == (get_smoke(arch).moe is not None)
    else:
        assert np.shape(got) == np.shape(want)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_equal_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    params = jmodel_for(jcfg).init(jax.random.key(3))
    jeng, teng = JServeEngine(jcfg, max_batch=2), ServeEngine(tcfg, max_batch=2, device="cpu")
    # one compile of each reference call: both batches have the same shapes
    jeng.model = dataclasses.replace(
        jeng.model, prefill=jax.jit(jeng.model.prefill, static_argnames=("cache_len",)),
        decode_step=jax.jit(jeng.model.decode_step))
    jeng.set_params(params)
    teng.set_params(params_from_numpy(jax.tree.map(np.asarray, params), "cpu"))
    rng = np.random.default_rng(4)
    for n, new in ((16, 4), (11, 3), (16, 4), (9, 2)):  # short prompts are left-padded
        prompt = rng.integers(0, jcfg.vocab_size, size=n)
        jeng.submit(prompt, new)
        teng.submit(prompt, new)
    while jeng.queue:
        want, got = jeng.step_batch(), teng.step_batch()
        assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
        assert [len(r.out_tokens) for r in got] == [r.max_new_tokens for r in got]
    assert not teng.queue and len(teng.done) == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_cache_layout_match_jax(arch):
    """The port's own init and zeroed caches have the reference's leaves."""
    jcfg, tcfg = _cfgs(arch)
    jm, tm = jmodel_for(jcfg), model_for(tcfg)
    jp = jax.eval_shape(jm.init, jax.random.key(0))
    tp = tm.init(torch.Generator().manual_seed(0))
    assert ([(p, tuple(x.shape), str(x.dtype)) for p, x in jckpt._leaf_paths(jp)]
            == [(p, tuple(x.shape), str(x.dtype).split(".")[1]) for p, x in tckpt._leaf_paths(tp)])
    jc = jax.tree.leaves(jm.init_cache(B, CACHE_LEN))
    tc = [x for _, x in tckpt._leaf_paths(tm.init_cache(B, CACHE_LEN, device="cpu"))]
    assert ([(x.shape, str(x.dtype)) for x in jc]
            == [(tuple(x.shape), str(x.dtype).split(".")[1]) for x in tc])


@pytest.mark.parametrize("arch", ["mamba2_130m", "granite_moe_1b"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_restores_across_packages(tmp_path, arch, writer):
    jcfg, _ = _cfgs(arch)
    tree = jax.tree.map(np.asarray, jmodel_for(jcfg).init(jax.random.key(7)))
    if writer == "jax":
        jckpt.CheckpointManager(str(tmp_path), block_size=4096).save(0, jax.tree.map(jnp.asarray, tree))
    else:
        tckpt.CheckpointManager(str(tmp_path), block_size=4096).save(0, params_from_numpy(tree, "cpu"))
    got = tckpt.CheckpointManager(str(tmp_path)).restore(0, params_from_numpy(tree, "cpu"), device="cpu")
    back = jckpt.CheckpointManager(str(tmp_path)).restore(0, jax.tree.map(jnp.asarray, tree))
    want = jax.tree.leaves(tree)
    got, back = jax.tree.leaves(params_to_numpy(got)), jax.tree.leaves(back)
    assert len(got) == len(want) == len(back)
    for w, g, j in zip(want, got, back):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(np.asarray(j), w)
