"""MoE's per-shard dispatch and the mesh train step against the JAX package's.

The reference runs once, in a subprocess with eight forced host devices,
every program under ``jax.jit`` (eager ``shard_map`` compiles op by op),
inside ``sharding_context(mesh, rules.logical_mapping())``; inputs and
params go to it, and its results come back, as ``.npz``.  The port runs
the same cases on the CPU, inside its own ``sharding_context`` on a mesh of
the same shape.

* ``apply_moe`` on (8, 1), (4, 2) and (2, 2, 2) ``("pod", "data",
  "model")`` meshes, for granite_moe_1b's smoke config (8 experts, top-4)
  and deepseek_moe_16b's (top-2, two shared experts): every shard's slots
  bit-equal to the reference's ``_dispatch_combine_plan`` on that shard's
  tokens; ``y`` within 1e-5 absolute and aux within 1e-5 relative of the
  reference's ``shard_map`` branch (``tests/test_torch_mamba_moe.py``'s
  limits for the one-device branch).  Decode (``t == 1``: a shard's
  capacity is its token count) on every mesh; a token count that dp does
  not divide, and dp = 1, fall back to the one-device branch, bit for bit.
* One train step of granite_moe_1b's smoke config on (4, 2) inside the
  context, against ``jax.jit(make_train_step(cfg, mesh))`` there, at the
  limits of ``tests/test_torch_train.py``: float32 loss 1e-6 relative,
  every gradient leaf (the first step's ``m``) within 2e-4 of its largest
  |g|, params within ``2·lr + 1e-6``; bf16 loss 2e-3 relative, params
  2e-2.  The reference's mesh step is not bit-equal to its own
  ``mesh=None`` step even outside a context (its constraints change XLA's
  reduction order), so nothing here is held bit for bit across packages;
  the port's mesh step outside a context is held against both of the
  reference's at the same limits, and ``pytest -s`` prints how far apart
  the reference's two are.
* The port's mesh step without a context is its ``mesh=None`` step, bit for
  bit; inside the context it is not (other drops).
* A ``chunked`` float32 prefill inside the context: logits and caches
  within 1e-4 absolute of the reference's jitted prefill.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import model_for as jmodel_for
from repro.models import moe as jmoe
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train.step import init_train_state as jinit_train_state
from repro_torch.configs import get_smoke
from repro_torch.data.synthetic import make_batch
from repro_torch.distributed.api import sharding_context
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model_for, params_from_numpy
from repro_torch.models import moe as tmoe
from repro_torch.models.params import tree_leaves_with_path, tree_map
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import make_train_step

ROOT = Path(__file__).resolve().parent.parent
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
MESHES = {"8x1": (8, 1), "4x2": (4, 2), "2x2x2": (2, 2, 2)}
# (case, arch, mesh, batch, tokens a sequence)
MOE_CASES = (
    [(f"{arch}-{mesh}-prefill", arch, mesh, 4, 16)
     for arch in ("granite_moe_1b", "deepseek_moe_16b") for mesh in MESHES]
    + [(f"granite_moe_1b-{mesh}-decode", "granite_moe_1b", mesh, 8, 1) for mesh in MESHES]
    + [("deepseek_moe_16b-4x2-decode", "deepseek_moe_16b", "4x2", 8, 1),
       ("granite_moe_1b-4x2-uneven", "granite_moe_1b", "4x2", 3, 5),  # 15 tokens, dp 4
       ("granite_moe_1b-1x8-dp1", "granite_moe_1b", "1x8", 4, 16)]
)
MESHES["1x8"] = (1, 8)
TRAIN_MESH, SEQ, BATCH, N_MICRO, LR = "4x2", 32, 8, 2, 1e-3
OPT = dict(lr=LR, warmup_steps=0, total_steps=10)
PREFILL = dict(batch=4, seq=32, chunk=8)

SCRIPT = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, sys
sys.path.insert(0, os.environ["REPRO_SRC"])
import jax, jax.numpy as jnp
import numpy as np
from repro.compat import make_mesh
from repro.configs import get_smoke
from repro.data.synthetic import make_batch
from repro.distributed.api import sharding_context
from repro.distributed.sharding import ShardingRules
from repro.models import model_for
from repro.models.moe import _dispatch_combine_plan, apply_moe, init_moe
from repro.optim.adamw import AdamWConfig
from repro.train.step import init_train_state, make_train_step

in_path, out_dir, spec = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
inp = dict(np.load(in_path))
out = {}
axes = {2: ("data", "model"), 3: ("pod", "data", "model")}


def mesh_of(shape):
    return make_mesh(tuple(shape), axes[len(shape)])


def tree_in(prefix, like):
    leaves = [jnp.asarray(inp[f"{prefix}/{i}"]) for i in range(len(jax.tree.leaves(like)))]
    return jax.tree.unflatten(jax.tree.structure(like), leaves)


def tree_out(prefix, tree):
    for i, leaf in enumerate(jax.tree.leaves(tree)):
        out[f"{prefix}/{i}"] = np.asarray(leaf.astype(jnp.float32))


for case, arch, shape, b, t in spec["moe"]:
    cfg = get_smoke(arch)
    p = tree_in(f"moe_params/{arch}", jax.eval_shape(lambda: init_moe(jax.random.key(5), cfg)))
    x = jnp.asarray(inp[f"x/{case}"])
    mesh = mesh_of(shape)
    with sharding_context(mesh, ShardingRules(cfg, mesh).logical_mapping()):
        y, aux = jax.jit(lambda p, x: apply_moe(p, x, cfg))(p, x)
    out[f"y/{case}"], out[f"aux/{case}"] = np.asarray(y), np.asarray(aux)
    dp = int(np.prod([mesh.shape[a] for a in ("pod", "data") if a in mesh.shape]))
    xf = x.reshape(b * t, -1)
    n = b * t // dp
    plan = jax.jit(lambda xl, r: _dispatch_combine_plan(xl, r, cfg.moe, t)[1])
    out[f"slots/{case}"] = np.stack([np.asarray(plan(xf[i * n:(i + 1) * n], p["router"]))
                                     for i in range(dp)])

tr = spec["train"]
base = dataclasses.replace(get_smoke("granite_moe_1b"), compute_dtype="float32", remat="none")
like_p, like_o = jax.eval_shape(lambda: init_train_state(base, jax.random.key(0)))
params32, opt = tree_in("train/params", like_p), tree_in("train/opt", like_o)
mesh = mesh_of(tr["mesh"])
batch = make_batch(base, tr["seq"], tr["batch"], kind="train", seed=1)
for dtype in ("float32", "bfloat16"):
    cfg = dataclasses.replace(base, compute_dtype=dtype)
    params = jax.tree.map(lambda a: a.astype(dtype), params32)
    with sharding_context(mesh, ShardingRules(cfg, mesh).logical_mapping()):
        _, step = make_train_step(cfg, mesh, opt=AdamWConfig(**tr["opt"]), n_micro=tr["n_micro"])
        new_p, new_o, m = jax.jit(step)(params, opt, batch)
    out[f"train/{dtype}/loss"] = np.asarray(m["loss"])
    out[f"train/{dtype}/grad_norm"] = np.asarray(m["grad_norm"])
    tree_out(f"train/{dtype}/m", new_o["m"])
    tree_out(f"train/{dtype}/new_params", new_p)
    # the mesh step with no context, and the mesh=None step
    for name, step_mesh in (("no_context", mesh), ("none", None)):
        _, step = make_train_step(cfg, step_mesh, opt=AdamWConfig(**tr["opt"]),
                                  n_micro=tr["n_micro"])
        new_p, _, m = jax.jit(step)(params, opt, batch)
        out[f"train/{dtype}/{name}/loss"] = np.asarray(m["loss"])
        tree_out(f"train/{dtype}/{name}/new_params", new_p)

pf = spec["prefill"]
cfg = dataclasses.replace(base, attn_impl="chunked", attn_chunk=pf["chunk"])
model = model_for(cfg)
pbatch = make_batch(cfg, pf["seq"], pf["batch"], kind="prefill", seed=2)
with sharding_context(mesh, ShardingRules(cfg, mesh).logical_mapping()):
    logits, cache = jax.jit(model.prefill)(params32, pbatch)
out["prefill/logits"] = np.asarray(logits)
tree_out("prefill/cache", cache)
np.savez(os.path.join(out_dir, "ref.npz"), **out)
'''


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _draw(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _state32():
    cfg = dataclasses.replace(jget_smoke("granite_moe_1b"), compute_dtype="float32")
    params, opt = jinit_train_state(cfg, jax.random.key(0))
    return _np_tree(params), _np_tree(opt)


def _moe_params(arch: str):
    return _np_tree(jmoe.init_moe(jax.random.key(5), jget_smoke(arch)))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    import json

    out = tmp_path_factory.mktemp("moe_mesh_ref")
    inp = {}
    for arch in ("granite_moe_1b", "deepseek_moe_16b"):
        for i, leaf in enumerate(jax.tree.leaves(_moe_params(arch))):
            inp[f"moe_params/{arch}/{i}"] = leaf
    for n, (case, arch, _, b, t) in enumerate(MOE_CASES):
        inp[f"x/{case}"] = _draw(100 + n, b, t, jget_smoke(arch).d_model)
    params, opt = _state32()
    for name, tree in (("params", params), ("opt", opt)):
        for i, leaf in enumerate(jax.tree.leaves(tree)):
            inp[f"train/{name}/{i}"] = leaf
    np.savez(out / "in.npz", **inp)
    spec = {"moe": [(c, a, MESHES[m], b, t) for c, a, m, b, t in MOE_CASES],
            "train": {"mesh": MESHES[TRAIN_MESH], "seq": SEQ, "batch": BATCH,
                      "n_micro": N_MICRO, "opt": OPT},
            "prefill": PREFILL}
    env = dict(os.environ, REPRO_SRC=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(out / "in.npz"), str(out),
                           json.dumps(spec)], capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out / "ref.npz") as z:
        return dict(z)


def _port_mesh(name: str):
    shape = MESHES[name]
    return make_mesh(shape, AXES[len(shape)], device="cpu")


def _context(cfg, mesh_name: str):
    mesh = _port_mesh(mesh_name)
    return sharding_context(mesh, ShardingRules(cfg, mesh).logical_mapping())


def _leaves(ref: dict, prefix: str) -> list[np.ndarray]:
    n = sum(1 for k in ref if k.startswith(prefix + "/"))
    return [ref[f"{prefix}/{i}"] for i in range(n)]


def _tleaves(tree) -> list[np.ndarray]:
    return [x.detach().float().numpy() for _, x in tree_leaves_with_path(tree)]


# ----------------------------------------------------------------------
# apply_moe
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case, arch, mesh_name, b, t", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_apply_moe_per_shard_matches_jax(ref, case, arch, mesh_name, b, t):
    cfg = get_smoke(arch)
    p = params_from_numpy(_moe_params(arch), "cpu")
    x = torch.from_numpy(_draw(100 + [c[0] for c in MOE_CASES].index(case), b, t, cfg.d_model))
    with _context(cfg, mesh_name):
        dp = tmoe.data_shards(b * t)
        y, aux = tmoe.apply_moe(p, x, cfg)
    np.testing.assert_allclose(y.numpy(), ref[f"y/{case}"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux), float(ref[f"aux/{case}"]), rtol=1e-5)

    shape = MESHES[mesh_name]
    want_dp = int(np.prod(shape[:-1]))
    if b * t % want_dp:  # the one-device branch, as the reference falls back
        assert dp == 1 and ref[f"slots/{case}"].shape[0] == want_dp
        y1, aux1 = tmoe.apply_moe(p, x, cfg)
        assert torch.equal(y, y1) and torch.equal(aux, aux1)
        return
    assert dp == want_dp
    xf = x.reshape(b * t, -1)
    if dp == 1:
        y1, aux1 = tmoe.apply_moe(p, x, cfg)
        assert torch.equal(y, y1) and torch.equal(aux, aux1)
        _, slots, *_ = tmoe._dispatch_combine_plan(xf, p["router"], cfg.moe, t)
        slots = slots[None]
    else:
        *_, slots, _, cap = tmoe._shard_dispatch_plan(xf, p["router"], cfg.moe, t, dp)
        assert cap == (b * t // dp if t == 1 else
                       max(int(b * t // dp * cfg.moe.top_k / cfg.moe.n_experts
                               * cfg.moe.capacity_factor), cfg.moe.top_k))
    np.testing.assert_array_equal(slots.numpy(), ref[f"slots/{case}"])


def test_per_shard_drops_differ_from_one_device():
    """On (8, 1) each shard routes 8 tokens at capacity 5; the one-device
    branch routes 64 at 40.  Other (token, choice) pairs drop, so ``y``
    differs; shard p's choices land in columns [p·C, (p+1)·C)."""
    cfg = get_smoke("granite_moe_1b")
    p = params_from_numpy(_moe_params("granite_moe_1b"), "cpu")
    x = torch.from_numpy(_draw(7, 4, 16, cfg.d_model))
    xf = x.reshape(64, -1)
    e = cfg.moe.n_experts
    buf, read, keep, gate, slots, aux, cap = tmoe._shard_dispatch_plan(xf, p["router"], cfg.moe,
                                                                       16, 8)
    assert cap == 5 and buf.shape == (e, 8 * cap, cfg.d_model)
    _, gslot, *_ = tmoe._dispatch_combine_plan(xf, p["router"], cfg.moe, 16)
    assert not torch.equal(keep, gslot < e * 40)
    for shard in range(8):
        for n in range(8):
            tok = shard * 8 + n
            for c in range(cfg.moe.top_k):
                s = int(slots[shard, n, c])
                if s < e * cap:
                    col = shard * cap + s % cap
                    assert torch.equal(buf[s // cap, col], xf[tok])
                    assert int(read[tok, c]) == (s // cap) * 8 * cap + col
    with _context(cfg, "8x1"):
        y, _ = tmoe.apply_moe(p, x, cfg)
    y1, _ = tmoe.apply_moe(p, x, cfg)
    assert not torch.allclose(y, y1)


def test_route_topk_batched_equals_per_row():
    """Leading dims route independently: each equals a 2-D call."""
    logits = torch.from_numpy(_draw(3, 4, 24, 8) * 2)
    slot, gate, eids, aux = tmoe.route_topk(logits, 2, 5)
    for i in range(4):
        s, g, ei, a = tmoe.route_topk(logits[i], 2, 5)
        assert torch.equal(slot[i], s) and torch.equal(gate[i], g) and torch.equal(eids[i], ei)
        assert torch.equal(aux[i], a)


def test_moe_gradients_flow_through_shards():
    cfg = get_smoke("deepseek_moe_16b")
    p = params_from_numpy(_moe_params("deepseek_moe_16b"), "cpu")
    x = torch.from_numpy(_draw(11, 4, 8, cfg.d_model)).requires_grad_()
    live = {k: v.requires_grad_() for k, v in p.items() if k != "shared"}
    with _context(cfg, "4x2"):
        y, aux = tmoe.apply_moe({**p, **live}, x, cfg)
    (y.square().sum() + aux).backward()
    assert x.grad is not None and float(x.grad.abs().max()) > 0
    for k in ("router", "w_gate", "w_up", "w_down"):
        assert live[k].grad is not None and float(live[k].grad.abs().max()) > 0, k


# ----------------------------------------------------------------------
# the mesh train step
# ----------------------------------------------------------------------
def _port_step(dtype: str, mesh, context: bool):
    cfg = dataclasses.replace(get_smoke("granite_moe_1b"), compute_dtype=dtype)
    params, opt = _state32()
    params = tree_map(lambda a: a.to(getattr(torch, dtype)), params_from_numpy(params, "cpu"))
    opt = params_from_numpy(opt, "cpu")
    batch = make_batch(cfg, SEQ, BATCH, kind="train", seed=1, device="cpu")
    _, step = make_train_step(cfg, mesh, opt=AdamWConfig(**OPT), n_micro=N_MICRO)
    if context:
        with sharding_context(mesh, ShardingRules(cfg, mesh).logical_mapping()):
            return step(params, opt, batch)
    return step(params, opt, batch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mesh_train_step_matches_jax(ref, dtype):
    new_p, new_o, m = _port_step(dtype, _port_mesh(TRAIN_MESH), context=True)
    loss, want_loss = float(m["loss"]), float(ref[f"train/{dtype}/loss"])
    want_p, got_p = _leaves(ref, f"train/{dtype}/new_params"), _tleaves(new_p)
    assert len(want_p) == len(got_p) > 0
    if dtype == "float32":
        assert loss == pytest.approx(want_loss, rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(float(ref[f"train/{dtype}/grad_norm"]),
                                                      rel=1e-5)
        want_g, got_g = _leaves(ref, f"train/{dtype}/m"), _tleaves(new_o["m"])
        assert len(want_g) == len(got_g)
        for w, g in zip(want_g, got_g):
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-4 * np.abs(w).max())
        atol = 2 * LR + 1e-6
    else:
        assert loss == pytest.approx(want_loss, rel=2e-3)
        atol = 2e-2
    for w, g in zip(want_p, got_p):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mesh_step_without_context_matches_both_jax_steps(ref, dtype):
    new_p, _, m = _port_step(dtype, _port_mesh(TRAIN_MESH), context=False)
    got = _tleaves(new_p)
    loss = {k: float(ref[f"train/{dtype}/{k}/loss"]) for k in ("none", "no_context")}
    want = {k: _leaves(ref, f"train/{dtype}/{k}/new_params") for k in loss}
    apart = max(float(np.abs(a - b).max()) for a, b in zip(want["none"], want["no_context"]))
    print(f"\nreference {dtype} step: loss {loss['none']!r} with mesh=None, "
          f"{loss['no_context']!r} with mesh {MESHES[TRAIN_MESH]} and no context; "
          f"params apart by up to {apart!r}")
    rel, atol = (1e-6, 2 * LR + 1e-6) if dtype == "float32" else (2e-3, 2e-2)
    for k in loss:
        assert len(want[k]) == len(got) > 0
        assert float(m["loss"]) == pytest.approx(loss[k], rel=rel), k
        for w, g in zip(want[k], got):
            np.testing.assert_allclose(g, w, rtol=0, atol=atol)


def test_mesh_step_without_context_is_the_plain_step():
    mesh = _port_mesh(TRAIN_MESH)
    runs = [_port_step("float32", m, context=False) for m in (None, mesh)]
    (p0, o0, m0), (p1, o1, m1) = runs
    for key in ("loss", "grad_norm", "ce_last"):
        assert torch.equal(m0[key], m1[key]), key
    for tree0, tree1 in ((p0, p1), (o0, o1)):
        for (path, a), (_, b) in zip(tree_leaves_with_path(tree0), tree_leaves_with_path(tree1)):
            assert torch.equal(a, b), path
    _, _, m2 = _port_step("float32", mesh, context=True)
    assert not torch.equal(m0["loss"], m2["loss"])  # per-shard routing drops other pairs


# ----------------------------------------------------------------------
# prefill
# ----------------------------------------------------------------------
def test_chunked_prefill_in_context_matches_jax(ref):
    cfg = dataclasses.replace(get_smoke("granite_moe_1b"), compute_dtype="float32",
                              attn_impl="chunked", attn_chunk=PREFILL["chunk"])
    params = params_from_numpy(_state32()[0], "cpu")
    batch = make_batch(cfg, PREFILL["seq"], PREFILL["batch"], kind="prefill", seed=2, device="cpu")
    with _context(cfg, TRAIN_MESH):
        logits, cache = model_for(cfg).prefill(params, batch)
    np.testing.assert_allclose(logits.numpy(), ref["prefill/logits"], atol=1e-4, rtol=0)
    want, got = _leaves(ref, "prefill/cache"), _tleaves(cache)
    assert len(want) == len(got) > 0
    for w, g in zip(want, got):
        assert w.shape == g.shape
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ["granite_moe_1b", "whisper_medium"])
def test_remat_recompute_keeps_the_context(arch):
    """On the card, autograd runs the backward, and so the recompute of every
    remat block, on a device thread of its own, where the caller's
    sharding context is not set: the recompute must route as the forward
    did.  Here the backward runs on another thread, outside the context."""
    import threading

    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    assert cfg.remat == "block"
    params = model_for(cfg).init(torch.Generator().manual_seed(0))
    batch = make_batch(cfg, 16, 4, kind="train", seed=1, device="cpu")
    leaves = [p for _, p in tree_leaves_with_path(params)]

    def grads(backward_elsewhere: bool):
        from repro_torch.models.params import tree_unflatten

        live = [p.detach().requires_grad_() for p in leaves]
        with _context(cfg, TRAIN_MESH):
            loss, _ = model_for(cfg).loss(tree_unflatten(params, live), batch)
            if not backward_elsewhere:
                return torch.autograd.grad(loss, live, allow_unused=True)
        out = []
        worker = threading.Thread(
            target=lambda: out.append(torch.autograd.grad(loss, live, allow_unused=True)))
        worker.start()
        worker.join(timeout=120)
        assert not worker.is_alive() and out, "the backward on another thread failed"
        return out[0]

    want, got = grads(False), grads(True)
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if w is not None:
            assert torch.equal(w, g)
