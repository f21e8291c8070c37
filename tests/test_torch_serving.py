"""The port's serving path against the JAX package: models, engine, checkpoints.

Params come from the JAX package's ``model.init`` and reach the port through
``params_from_numpy``.  The smoke configs of ``deepseek_7b`` (MHA, full
cache) and ``gemma3_1b`` (sliding window, ring cache, GeGLU, qk-norm, tied
embeddings) run with ``attn_impl="pallas"``: the JAX package's Pallas kernel
in interpret mode, the port's kernel through its plain version.  Prefill
logits, the caches and one decode step are compared at 1e-4 absolute in
float32.  In bf16 the logits are held at 2e-2 of the largest |logit|, and
each cache leaf at 2e-2 of its norm: XLA may keep bf16 elementwise chains in
float32 where PyTorch rounds after every op, and the difference grows with
depth (in the gemma3 smoke, one element of a late layer's keys differed
by 0.075 at a largest magnitude of 3.2 while the first layer's matched).  JAX results are computed once per
module, since interpret-mode Pallas costs seconds.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.configs import get_smoke as jget_smoke
from repro.models import model_for as jmodel_for
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.checkpoint import manager as tckpt
from repro_torch.configs import get_smoke
from repro_torch.models import model_for, params_from_numpy, params_to_numpy
from repro_torch.serving.engine import ServeEngine

B, T, CACHE_LEN = 2, 32, 40


def _cfgs(arch: str, dtype: str, **kw):
    over = {"attn_impl": "pallas", "compute_dtype": dtype, **kw}
    return dataclasses.replace(jget_smoke(arch), **over), dataclasses.replace(get_smoke(arch), **over)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a), tree)


def _t_np(tree):
    # copies: a decode step later writes the port's cache in place
    return [(x.float() if x.dtype == torch.bfloat16 else x).numpy().copy()
            for _, x in tckpt._leaf_paths(tree)]


def _jit(fn, dtype: str = "float32"):
    """In float32, one compile of the whole reference call (seconds less than
    op by op).  In bf16 the reference stays eager, as its ServeEngine runs
    it: each op rounds to bf16 as in PyTorch, where a jit's fusions may keep
    whole chains in float32."""
    if dtype != "float32":
        return fn
    return jax.jit(fn, static_argnames=("cache_len",) if fn.__name__ == "prefill" else ())


def _run_both(arch: str, dtype: str, **kw) -> dict:
    jcfg, tcfg = _cfgs(arch, dtype, **kw)
    jm, tm = jmodel_for(jcfg), model_for(tcfg)
    params = jm.init(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, params)
    tparams = params_from_numpy(np_params, "cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    jl, jc = _jit(jm.prefill, dtype)(params, {"tokens": jnp.asarray(toks)}, cache_len=CACHE_LEN)
    tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)}, cache_len=CACHE_LEN)
    out = {"prefill": (np.asarray(jl, np.float32), tl.float().numpy()),
           "cache": (jax.tree.leaves(_np(jc)), _t_np(tc))}
    # one decode step from the reference's cache, so that it is held alone
    nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    jl2, jc2 = _jit(jm.decode_step, dtype)(params, {"tokens": jnp.asarray(nxt), "pos": jnp.asarray(T, jnp.int32)}, jc)
    tc = params_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    tl2, tc2 = tm.decode_step(tparams, {"tokens": torch.from_numpy(nxt), "pos": T}, tc)
    out["decode"] = (np.asarray(jl2, np.float32), tl2.float().numpy())
    out["decode_cache"] = (jax.tree.leaves(_np(jc2)), _t_np(tc2))
    return out


@pytest.fixture(scope="module")
def runs():
    memo = {}

    def get(arch, dtype):
        if (arch, dtype) not in memo:
            memo[arch, dtype] = _run_both(arch, dtype)
        return memo[arch, dtype]

    return get


def _assert_close(want, got, dtype):
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    assert want.shape == got.shape
    atol = 1e-4 if dtype == "float32" else 2e-2 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["deepseek_7b", "gemma3_1b"])
@pytest.mark.parametrize("what", ["prefill", "cache", "decode", "decode_cache"])
def test_smoke_model_matches_jax(runs, arch, dtype, what):
    want, got = runs(arch, dtype)[what]
    if what in ("cache", "decode_cache"):
        assert len(want) == len(got)
        for w, g in zip(want, got):
            if dtype == "float32":
                _assert_close(w, g, dtype)
            else:  # bf16 rounding drifts with depth: hold the leaf as a whole
                assert w.shape == g.shape
                assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w)
    else:
        _assert_close(want, got, dtype)


def test_int8_cache_and_grouped_decode_match_jax():
    """GQA (6 heads on 2 KV heads), the int8 KV cache and the grouped decode, in float32."""
    res = _run_both("internlm2_20b", "float32", attn_impl="full",
                    kv_cache_dtype="int8", gqa_decode="grouped")
    for what in ("prefill", "decode"):
        _assert_close(*res[what], "float32")
    for what in ("cache", "decode_cache"):
        for w, g in zip(*res[what]):
            if w.dtype == np.int8:  # a value on a rounding boundary may land one step off
                assert np.abs(w.astype(np.int32) - g.astype(np.int32)).max() <= 1
            else:
                _assert_close(w, g, "float32")


def test_loss_vlm_prefill_and_init_cache_match_jax():
    """Train-mode loss with masked labels, a VLM prefill with patch embeddings,
    and the zeroed cache layout, on llava_next_mistral_7b's smoke config."""
    jcfg, tcfg = _cfgs("llava_next_mistral_7b", "float32", attn_impl="full")
    jm, tm = jmodel_for(jcfg), model_for(tcfg)
    params = jm.init(jax.random.key(2))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab_size, (B, 24)).astype(np.int32)
    labels = np.where(rng.random((B, 24)) < 0.2, -1, toks).astype(np.int32)
    jloss, jmet = _jit(jm.loss)(params, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tloss, tmet = tm.loss(tparams, {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert int(tmet["tokens"]) == int(jmet["tokens"])
    patches = rng.standard_normal((B, jcfg.vlm.n_patches, jcfg.vlm.d_vision)).astype(np.float32)
    jl, _ = _jit(jm.prefill)(params, {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(patches)})
    tl, _ = tm.prefill(tparams, {"tokens": torch.from_numpy(toks), "patch_embeds": torch.from_numpy(patches)})
    _assert_close(np.asarray(jl), tl.numpy(), "float32")
    jc = jax.tree.leaves(jm.init_cache(B, 40))
    tc = [x for _, x in tckpt._leaf_paths(tm.init_cache(B, 40, device="cpu"))]
    assert [(x.shape, str(x.dtype)) for x in jc] == [(tuple(x.shape), str(x.dtype).split(".")[1]) for x in tc]


def test_engine_greedy_tokens_equal_jax():
    jcfg, tcfg = _cfgs("deepseek_7b", "float32")
    params = jmodel_for(jcfg).init(jax.random.key(3))
    jeng, teng = JServeEngine(jcfg, max_batch=2), ServeEngine(tcfg, max_batch=2, device="cpu")
    jeng.set_params(params)
    teng.set_params(params_from_numpy(jax.tree.map(np.asarray, params), "cpu"))
    rng = np.random.default_rng(4)
    for n, new in ((32, 4), (20, 3), (32, 2)):  # the 20-token prompt is left-padded
        prompt = rng.integers(0, jcfg.vocab_size, size=n)
        jeng.submit(prompt, new)
        teng.submit(prompt, new)
    while jeng.queue:
        want, got = jeng.step_batch(), teng.step_batch()
        assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
        assert [len(r.out_tokens) for r in got] == [r.max_new_tokens for r in got]
    assert not teng.queue and len(teng.done) == 3


# ----------------------------------------------------------------------
# checkpoints: the same bytes from both packages, restorable across them
# ----------------------------------------------------------------------
def _mixed_tree():
    rng = np.random.default_rng(7)
    return {
        "w": rng.standard_normal((33, 17)).astype(np.float32),
        "half": rng.standard_normal((5, 300)).astype(np.float32).astype(jnp.bfloat16),
        "layers": [(rng.integers(-9, 9, (4, 4)).astype(np.int32), {"b": np.arange(7, dtype=np.uint8)})],
        "a": {"z": np.float32(2.5) * np.ones(3, np.float32), "y": np.zeros((0, 2), np.float32)},
    }


# gemma3_1b's smoke width at 14 layers: the full config's stage layout (two
# one-layer stages, then the 6-layer period repeated), so ``stages/0`` is one
# layer; the smoke's 8 layers fold into a single stage.
GEMMA_LAZY = dict(n_layers=14)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    jcfg, _ = _cfgs("deepseek_7b", "float32")
    gcfg, _ = _cfgs("gemma3_1b", "float32", **GEMMA_LAZY)
    trees = {"model": jax.tree.map(np.asarray, jmodel_for(jcfg).init(jax.random.key(0))),
             "gemma3": jax.tree.map(np.asarray, jmodel_for(gcfg).init(jax.random.key(0))),
             "mixed": _mixed_tree(),
             "whisper": jax.tree.map(np.asarray, jmodel_for(jget_smoke("whisper_medium")).init(
                 jax.random.key(1)))}
    out = {}
    for name, tree in trees.items():
        jdir, tdir = (str(tmp_path_factory.mktemp(f"{name}_{pkg}")) for pkg in ("jax", "torch"))
        jckpt.CheckpointManager(jdir, block_size=4096).save(0, jax.tree.map(jnp.asarray, tree))
        tckpt.CheckpointManager(tdir, block_size=4096).save(0, params_from_numpy(tree, "cpu"))
        out[name] = (tree, Path(jdir), Path(tdir))
    return out


@pytest.mark.parametrize("name", ["model", "mixed", "whisper", "gemma3"])
def test_checkpoint_bytes_and_manifest_identical(ckpts, name):
    tree, jdir, tdir = ckpts[name]
    jpaths = [p for p, _ in jckpt._leaf_paths(jax.tree.map(jnp.asarray, tree))]
    assert [p for p, _ in tckpt._leaf_paths(params_from_numpy(tree, "cpu"))] == jpaths
    for suffix in ("blocks", "json"):
        (jf,), (tf,) = jdir.glob(f"*.{suffix}"), tdir.glob(f"*.{suffix}")
        assert jf.name == tf.name
        if suffix == "json":
            assert json.loads(tf.read_text()) == json.loads(jf.read_text())
        else:
            assert tf.read_bytes() == jf.read_bytes()


@pytest.mark.parametrize("name", ["model", "mixed", "whisper", "gemma3"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_restores_across_packages(ckpts, name, writer):
    tree, jdir, tdir = ckpts[name]
    d = str(jdir if writer == "jax" else tdir)
    want = jax.tree.leaves(tree)
    got = tckpt.CheckpointManager(d).restore(0, params_from_numpy(tree, "cpu"), device="cpu")
    got = jax.tree.leaves(params_to_numpy(got))
    back = jax.tree.leaves(jckpt.CheckpointManager(d).restore(0, jax.tree.map(jnp.asarray, tree)))
    assert len(got) == len(want) == len(back)
    for w, g, j in zip(want, got, back):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint8), np.asarray(w).view(np.uint8))
        np.testing.assert_array_equal(np.asarray(j).view(np.uint8), np.asarray(w).view(np.uint8))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_lazy_cold_start_stats_equal_jax(ckpts, writer):
    tree, jdir, tdir = ckpts["model"]
    d = str(jdir if writer == "jax" else tdir)
    jcfg, tcfg = _cfgs("deepseek_7b", "float32")
    jeng, teng = JServeEngine(jcfg), ServeEngine(tcfg, device="cpu")
    jeng.start(jckpt.CheckpointManager(d), 0, jax.tree.map(jnp.asarray, tree), lazy=True)
    teng.start(tckpt.CheckpointManager(d), 0, params_from_numpy(tree, "cpu"), lazy=True)
    keys = ("first_fetch_compressed_bytes", "total_fetch_compressed_bytes", "read_amplification")
    assert {k: teng.cold_start_stats[k] for k in keys} == {k: jeng.cold_start_stats[k] for k in keys}
    for w, g in zip(jax.tree.leaves(tree), jax.tree.leaves(params_to_numpy(teng.params))):
        np.testing.assert_array_equal(g, w)


def _bits(x):
    return np.asarray(x).view(np.uint8)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_partial_lazy_restore_equals_jax_on_gemma3(ckpts, writer):
    """gemma3_1b's ``stages/0`` is one layer (``GEMMA_LAZY``), so the first fetch is a real
    prefix and the other leaves start as zeros: the partial tree, the fetch
    statistics after it and after ``finish()``, the final params and the
    engine's ``cold_start_stats`` all equal the JAX package's."""
    from repro.serving.engine import FIRST_LEAF_PRED as JPRED
    from repro_torch.models.params import MetaGenerator
    from repro_torch.serving.engine import FIRST_LEAF_PRED

    tree, jdir, tdir = ckpts["gemma3"]
    d = str(jdir if writer == "jax" else tdir)
    jtree = jax.tree.map(jnp.asarray, tree)
    jpart, jfinish, jreader = jckpt.CheckpointManager(d).restore_lazy(0, jtree, JPRED)
    tpart, tfinish, treader = tckpt.CheckpointManager(d).restore_lazy(
        0, params_from_numpy(tree, "cpu"), FIRST_LEAF_PRED, device="cpu")
    paths = [p for p, _ in jckpt._leaf_paths(jtree)]
    first = [FIRST_LEAF_PRED(p) for p in paths]
    assert first == [JPRED(p) for p in paths] and 0 < sum(first) < len(first)
    assert any(p.startswith("stages/1") for p, f in zip(paths, first) if not f)
    for f, w, j, g in zip(first, jax.tree.leaves(tree), jax.tree.leaves(jpart),
                          jax.tree.leaves(params_to_numpy(tpart))):
        np.testing.assert_array_equal(_bits(g), _bits(j))
        np.testing.assert_array_equal(_bits(g), _bits(w) if f else np.zeros_like(_bits(w)))
    assert dataclasses.asdict(treader.stats) == dataclasses.asdict(jreader.stats)
    assert treader.stats.fetched_raw < jreader.manifest.raw_size
    jfull, tfull = jfinish(), tfinish()
    assert dataclasses.asdict(treader.stats) == dataclasses.asdict(jreader.stats)
    for w, j, g in zip(jax.tree.leaves(tree), jax.tree.leaves(jfull), jax.tree.leaves(params_to_numpy(tfull))):
        np.testing.assert_array_equal(_bits(g), _bits(w))
        np.testing.assert_array_equal(_bits(j), _bits(w))
    treader.close()
    jcfg, tcfg = _cfgs("gemma3_1b", "float32", **GEMMA_LAZY)
    jeng, teng = JServeEngine(jcfg), ServeEngine(tcfg, device="cpu")
    jeng.start(jckpt.CheckpointManager(d), 0, jtree, lazy=True)
    teng.start(tckpt.CheckpointManager(d), 0, model_for(tcfg).init(MetaGenerator()), lazy=True)
    keys = ("first_fetch_compressed_bytes", "total_fetch_compressed_bytes", "read_amplification")
    assert {k: teng.cold_start_stats[k] for k in keys} == {k: jeng.cold_start_stats[k] for k in keys}
    assert teng.cold_start_stats["first_fetch_compressed_bytes"] < teng.cold_start_stats[
        "total_fetch_compressed_bytes"]
    for w, g in zip(jax.tree.leaves(tree), jax.tree.leaves(params_to_numpy(teng.params))):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("name", ["model", "gemma3"])
def test_finish_keeps_the_first_leaves_and_decodes_each_leaf_once(ckpts, name, monkeypatch):
    """``finish()`` returns the partial tree's own first leaves (same storage)
    and decodes every other leaf once: one copy of the weights in all."""
    from repro_torch.models.params import MetaGenerator
    from repro_torch.serving.engine import FIRST_LEAF_PRED

    tree, _, tdir = ckpts[name]
    decoded = []
    load = tckpt.CheckpointManager._load
    monkeypatch.setattr(tckpt.CheckpointManager, "_load",
                        staticmethod(lambda r, m, device: decoded.append(m.path) or load(r, m, device)))
    cfg = _cfgs(*{"model": ("deepseek_7b", "float32"), "gemma3": ("gemma3_1b", "float32")}[name],
                **(GEMMA_LAZY if name == "gemma3" else {}))[1]
    like = model_for(cfg).init(MetaGenerator())
    part, finish, reader = tckpt.CheckpointManager(str(tdir)).restore_lazy(0, like, FIRST_LEAF_PRED,
                                                                          device="cpu")
    paths = [p for p, _ in tckpt._leaf_paths(like)]
    assert decoded == [p for p in paths if FIRST_LEAF_PRED(p)]
    full = finish()
    reader.close()
    assert sorted(decoded) == sorted(paths)  # each leaf once
    for p, (_, a), (_, b) in zip(paths, tckpt._leaf_paths(part), tckpt._leaf_paths(full)):
        assert b.device.type == "cpu" and not b.is_meta
        if FIRST_LEAF_PRED(p):
            assert b is a and b.data_ptr() == a.data_ptr()
        else:
            assert not bool(a.any())
    for w, g in zip(jax.tree.leaves(tree), jax.tree.leaves(params_to_numpy(full))):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_async_save_snapshots_the_tree(ckpts, tmp_path):
    """An asynchronous save copies the leaves before it returns: changing the
    tree while the blocks are written leaves the file the JAX package's."""
    tree, jdir, _ = ckpts["gemma3"]
    tparams = params_from_numpy(tree, "cpu")
    mgr = tckpt.CheckpointManager(str(tmp_path), block_size=4096, async_save=True)
    mgr.save(0, tparams)
    for _, leaf in tckpt._leaf_paths(tparams):
        leaf.add_(1)
    mgr.wait()
    for suffix in ("blocks", "json"):
        (jf,), (tf,) = jdir.glob(f"*.{suffix}"), tmp_path.glob(f"*.{suffix}")
        assert tf.read_bytes() == jf.read_bytes()


@pytest.mark.parametrize("arch", ["whisper_medium"])  # the audio family
def test_unported_layer_kinds_raise(arch, monkeypatch):
    """Every family builds in the port now.  The audio one is served through
    the model facade (its batches carry frames); both packages' serving
    launchers refuse it, since ServeEngine feeds tokens only."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    model = model_for(get_smoke(arch))
    assert model.cfg.family == "audio"
    for launcher in (jserve, tserve):
        monkeypatch.setattr("sys.argv", ["serve", "--arch", arch])
        with pytest.raises(SystemExit, match="requires frames"):
            launcher.main()


def test_engine_on_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(get_smoke("deepseek_7b"))
