"""The port's device-plane weight broadcast held against the JAX package's.

* ``faasnet_rounds`` and ``binomial_rounds`` equal the reference's (perm
  lists and ``send_blk`` / ``recv_blk`` / ``recv_mask`` arrays) for dp in
  {1, 2, 3, 4, 5, 7, 8, 16, 33} and 1, 2, 4 and 32 blocks; the FaaSNet
  schedule's invariants hold in the port alone.
* ``flatten_pytree`` is bit-equal to the reference's, ``FlatSpec`` alike,
  on a tree mixing float32 and bfloat16 leaves, a scalar, a list, a tuple
  and ``None``, and on granite_moe_1b's smoke params as JAX initialises
  them; ``unflatten_pytree`` round-trips.
* The per-position body: every position's buffer bit-equal to the
  reference's per-device output, from a ``-7.0`` sentinel on a (4, 2) mesh
  (the cases of ``tests/test_broadcast.py``, plus ``allgather``) and from a
  sentinel that differs per position at dp 3, 5, 6 and 7; and two
  hand-made rounds in which a position sends a range that the same round
  overwrites, where only reading every source before the round's writes
  gives the reference's result.
* ``tree_broadcast`` for the four schedules and for ``pipelined`` with int8
  compression, on (4, 2) and (2, 2, 2) meshes: the tree, the report and the
  int8 payloads and scales equal to the reference's, every position equal
  to the root; then the reference's own assertions on the port.

The reference runs in one subprocess with eight forced host devices, as
``tests/test_broadcast.py`` does, and hands its results over as ``.npz``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.distributed.broadcast as jb
from repro.configs import get_smoke as jget_smoke
from repro.models import model_for as jmodel_for
import repro_torch.distributed.broadcast as tb
from repro_torch.launch import mesh as tmesh
from repro_torch.models.params import params_from_numpy, tensor_to_numpy, tree_leaves_with_path

ROOT = Path(__file__).resolve().parent.parent

# Executed here and in the reference's subprocess, so both start from the
# same numpy leaves.
TREES_SRC = r'''
import ml_dtypes
import numpy as np


def make_trees():
    rng = np.random.default_rng(0)
    return {
        # tests/test_broadcast.py's params
        "ref_test": {"a": np.arange(640, dtype=np.float32).reshape(80, 8) / np.float32(1037.0),
                     "b": np.arange(10, dtype=np.float32) * np.float32(0.05)},
        # 666 elements: padding occurs at 4 and at 32 blocks
        "mixed": {"w": rng.standard_normal((80, 8)).astype(np.float32),
                  "b": [rng.standard_normal(10).astype(ml_dtypes.bfloat16),
                        np.asarray(0.3, np.float32)],
                  "none": None,
                  "t": (rng.standard_normal((3, 5)).astype(np.float32),)},
    }
'''
_ns: dict = {}
exec(TREES_SRC, _ns)
make_trees = _ns["make_trees"]

DPS = (1, 2, 3, 4, 5, 7, 8, 16, 33)
BLOCKS = (1, 2, 4, 32)
SWEEP_DPS = (3, 5, 6, 7)
VARIANTS = [(s, False) for s in tb.SCHEDULES] + [("pipelined", True)]
# Rounds in which a position sends a range the same round overwrites:
# binomial as (src, dst) perms; pipelined as (perm, send_blk, recv_blk,
# recv_mask), dp 4, 4 blocks.
CUSTOM = {
    "binomial_chain": [[(0, 1), (1, 2), (2, 3)]],
    "pipelined_overlap": [
        ([(0, 1), (1, 2), (2, 3)], [2, 1, 0, 0], [0, 1, 0, 3], [0, 1, 1, 1]),
        ([(1, 3), (3, 1)], [0, 2, 0, 3], [0, 3, 0, 2], [0, 1, 0, 1]),
    ],
}

SCRIPT = TREES_SRC + r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
sys.path.insert(0, os.environ["REPRO_SRC"])
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.distributed.broadcast import (
    Round, _bcast_body, binomial_rounds, faasnet_rounds, flatten_pytree, tree_broadcast)
from repro.optim.compress import quantize_int8

out_dir, custom = sys.argv[1], json.loads(sys.argv[2])
trees = {k: jax.tree.map(jnp.asarray, t) for k, t in make_trees().items()}
arrays, meta = {}, {}


def bits(x):
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def body_rows(mesh, spec, flat, sched, info, n_blocks, per_position):
    def run(buf):
        idx = jax.lax.axis_index(("data",))
        stale = (-7.0 - idx).astype(buf.dtype) if per_position else -7.0
        buf = jnp.where(idx == 0, buf, stale)
        return _bcast_body(buf, axes=("data",), dp=mesh.shape["data"], schedule=sched,
                           n_blocks=n_blocks, rounds_info=info)
    rows = jax.jit(shard_map(run, mesh=mesh, in_specs=P(), out_specs=spec, check_vma=False))(flat)
    return np.asarray(rows).reshape(mesh.devices.size, -1).view(np.uint16)


def info_for(sched, dp, n_blocks):
    return {"binomial": binomial_rounds(dp), "pipelined": faasnet_rounds(dp, n_blocks)}.get(sched)


mesh42 = make_mesh((4, 2), ("data", "model"))
flat4, _ = flatten_pytree(trees["mixed"], pad_to=4)
for sched in ("naive", "allgather", "binomial", "pipelined"):
    arrays[f"body/{sched}"] = body_rows(mesh42, P(("data", "model")), flat4, sched,
                                        info_for(sched, 4, 4), 4, False)

flat32, _ = flatten_pytree(trees["mixed"], pad_to=32)
for dp in (3, 5, 6, 7):
    mesh = Mesh(np.array(jax.devices()[:dp]).reshape(dp, 1), ("data", "model"))
    for sched in ("naive", "allgather", "binomial", "pipelined"):
        arrays[f"sweep/{dp}/{sched}"] = body_rows(mesh, P("data"), flat32, sched,
                                                  info_for(sched, dp, 32), 32, True)

mesh4 = Mesh(np.array(jax.devices()[:4]).reshape(4, 1), ("data", "model"))
arrays["custom/binomial_chain"] = body_rows(
    mesh4, P("data"), flat4, "binomial", [[tuple(p) for p in r] for r in custom["binomial_chain"]],
    4, True)
rounds = [Round([tuple(p) for p in perm], np.asarray(sb, np.int32), np.asarray(rb, np.int32),
                np.asarray(rm, bool)) for perm, sb, rb, rm in custom["pipelined_overlap"]]
arrays["custom/pipelined_overlap"] = body_rows(mesh4, P("data"), flat4, "pipelined", rounds, 4, True)

meshes = {"4x2": mesh42, "2x2x2": make_mesh((2, 2, 2), ("pod", "data", "model"))}
for mesh_name, mesh in meshes.items():
    for tree_name, tree in trees.items():
        flat, _ = flatten_pytree(tree, pad_to=4)
        q, scale = quantize_int8(flat.reshape(4, -1))
        arrays[f"q/{tree_name}"], arrays[f"scale/{tree_name}"] = np.asarray(q), np.asarray(scale)
        for sched, compress in [(s, False) for s in ("naive", "allgather", "binomial", "pipelined")] \
                + [("pipelined", True)]:
            key = f"tb/{mesh_name}/{tree_name}/{sched}/{int(compress)}"
            reps = []

            def run(tree, mesh=mesh, sched=sched, compress=compress):
                res, rep = tree_broadcast(tree, mesh, schedule=sched, n_blocks=4, compress=compress)
                reps.append(rep)
                return res
            res = jax.jit(run)(tree)  # one program; eager shard_map compiles op by op
            (rep,) = reps
            for i, leaf in enumerate(jax.tree.leaves(res)):
                arrays[f"{key}/{i}"] = bits(leaf)
            meta[key] = dict(rep.__dict__, dtypes=[str(l.dtype) for l in jax.tree.leaves(res)])
np.savez(os.path.join(out_dir, "ref.npz"), **arrays)
with open(os.path.join(out_dir, "ref.json"), "w") as f:
    json.dump(meta, f)
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("broadcast_ref")
    env = dict(os.environ, REPRO_SRC=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(out), json.dumps(CUSTOM)],
                          capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out / "ref.npz") as z:
        arrays = dict(z)
    return arrays, json.loads((out / "ref.json").read_text())


def port_tree(name: str):
    return params_from_numpy(make_trees()[name], "cpu")


def u16(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def leaf_bits(x) -> np.ndarray:
    """A leaf's bytes, from a tensor or a JAX array."""
    x = tensor_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def sentinel_buffer(like, device):
    """Every byte 0xFF: NaN in bf16 and f32, -1 in int8."""
    buf = torch.empty(like.shape, dtype=like.dtype, device=device)
    buf.view(torch.uint8).fill_(0xFF)
    return buf


# ----------------------------------------------------------------------
# schedules
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n_blocks", BLOCKS)
@pytest.mark.parametrize("dp", DPS)
def test_faasnet_rounds_equal_reference(dp, n_blocks):
    want, got = jb.faasnet_rounds(dp, n_blocks), tb.faasnet_rounds(dp, n_blocks)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.perm == w.perm
        for f in ("send_blk", "recv_blk", "recv_mask"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("dp", DPS)
def test_binomial_rounds_equal_reference(dp):
    assert tb.binomial_rounds(dp) == jb.binomial_rounds(dp)


@pytest.mark.parametrize("n_blocks", BLOCKS)
@pytest.mark.parametrize("dp", DPS)
def test_faasnet_rounds_invariants(dp, n_blocks):
    """Each non-root position receives each block once, from a sender that
    held it before the round; a position sends and receives at most one
    block a round."""
    have = [set(range(n_blocks))] + [set() for _ in range(dp - 1)]
    received = np.zeros((dp, n_blocks), int)
    for rnd in tb.faasnet_rounds(dp, n_blocks):
        srcs, dsts = [s for s, _ in rnd.perm], [d for _, d in rnd.perm]
        assert len(set(srcs)) == len(srcs) and len(set(dsts)) == len(dsts)
        assert sorted(dsts) == np.flatnonzero(rnd.recv_mask).tolist()
        for s, d in rnd.perm:
            assert rnd.send_blk[s] == rnd.recv_blk[d] and rnd.send_blk[s] in have[s]
        for s, d in rnd.perm:
            have[d].add(int(rnd.recv_blk[d]))
            received[d, rnd.recv_blk[d]] += 1
    assert (received[0] == 0).all() and (received[1:] == 1).all()


def test_faasnet_round_count():
    """Single-port binary tree: ~2B + O(log dp) rounds for B blocks."""
    assert len(tb.faasnet_rounds(16, 32)) <= 2 * 32 + 2 * 4 + 4


# ----------------------------------------------------------------------
# the flat image
# ----------------------------------------------------------------------
def _flat_pair(np_tree, pad_to):
    jflat, jspec = jb.flatten_pytree(jax.tree.map(jnp.asarray, np_tree), pad_to=pad_to)
    tflat, tspec = tb.flatten_pytree(params_from_numpy(np_tree, "cpu"), pad_to=pad_to)
    return (jflat, jspec), (tflat, tspec)


def _assert_flat_equal(np_tree, pad_to):
    (jflat, jspec), (tflat, tspec) = _flat_pair(np_tree, pad_to)
    assert tflat.dtype == torch.bfloat16
    assert np.array_equal(u16(tflat), np.asarray(jflat).view(np.uint16))
    assert (tspec.sizes, tspec.pad, tspec.total) == (jspec.sizes, jspec.pad, jspec.total)
    assert tspec.shapes == [tuple(s) for s in jspec.shapes]
    assert [str(d).removeprefix("torch.") for d in tspec.dtypes] == [str(d) for d in jspec.dtypes]
    # round trip: the port's tree equals the reference's, leaf for leaf
    jtree = jax.tree.leaves(jb.unflatten_pytree(jflat, jspec))
    ttree = tb.unflatten_pytree(tflat, tspec)
    tleaves = [leaf for _, leaf in tree_leaves_with_path(ttree)]
    assert len(tleaves) == len(jtree)
    for t, j in zip(tleaves, jtree):
        assert np.array_equal(leaf_bits(t), leaf_bits(j))
        assert t.untyped_storage().data_ptr() != tflat.untyped_storage().data_ptr()
    return ttree


@pytest.mark.parametrize("pad_to", [1, 4, 32])
def test_flatten_mixed_tree_equals_reference(pad_to):
    ttree = _assert_flat_equal(make_trees()["mixed"], pad_to)
    assert ttree["none"] is None and isinstance(ttree["b"], list) and isinstance(ttree["t"], tuple)
    assert ttree["b"][0].dtype == torch.bfloat16 and ttree["b"][1].shape == ()
    assert list(ttree) == ["w", "b", "none", "t"]


def test_flatten_smoke_params_equal_reference():
    params = jmodel_for(jget_smoke("granite_moe_1b")).init(jax.random.key(0))
    _assert_flat_equal(jax.tree.map(np.asarray, params), 32)


# ----------------------------------------------------------------------
# the per-position body
# ----------------------------------------------------------------------
def _columns(flat, n_cols, dp, stale):
    return [[flat.clone()] + [torch.full_like(flat, stale(i)) for i in range(1, dp)]
            for _ in range(n_cols)]


@pytest.mark.parametrize("sched", tb.SCHEDULES)
def test_body_from_sentinel_equals_reference(ref, sched):
    arrays, _ = ref
    flat, _ = tb.flatten_pytree(port_tree("mixed"), pad_to=4)
    cols = _columns(flat, 2, 4, lambda i: -7.0)
    info = {"binomial": tb.binomial_rounds(4), "pipelined": tb.faasnet_rounds(4, 4)}.get(sched)
    for col in cols:
        tb.broadcast_buffers(col, dp=4, schedule=sched, n_blocks=4, rounds_info=info)
    want = arrays[f"body/{sched}"]
    for i in range(4):
        for j in range(2):
            assert np.array_equal(u16(cols[j][i]), want[i * 2 + j]), (i, j)
            assert same_bits(cols[j][i], flat), (i, j)


@pytest.mark.parametrize("sched", tb.SCHEDULES)
@pytest.mark.parametrize("dp", SWEEP_DPS)
def test_body_per_position_sentinel_equals_reference(ref, dp, sched):
    arrays, _ = ref
    flat, _ = tb.flatten_pytree(port_tree("mixed"), pad_to=32)
    (col,) = _columns(flat, 1, dp, lambda i: -7.0 - i)
    info = {"binomial": tb.binomial_rounds(dp), "pipelined": tb.faasnet_rounds(dp, 32)}.get(sched)
    copied = tb.broadcast_buffers(col, dp=dp, schedule=sched, n_blocks=32, rounds_info=info)
    want = arrays[f"sweep/{dp}/{sched}"]
    for i in range(dp):
        assert np.array_equal(u16(col[i]), want[i]), i
        assert same_bits(col[i], flat), i
    per_pos = (2 * dp - 1) if sched == "allgather" else (dp - 1)
    assert copied == per_pos * flat.nbytes


@pytest.mark.parametrize("name", sorted(CUSTOM))
def test_rounds_read_before_write(ref, name):
    """A position that sends a range the same round overwrites: the send
    carries the range as it stood before the round, as in ``ppermute``."""
    arrays, _ = ref
    flat, _ = tb.flatten_pytree(port_tree("mixed"), pad_to=4)
    (col,) = _columns(flat, 1, 4, lambda i: -7.0 - i)
    if name == "binomial_chain":
        sched, info = "binomial", [[tuple(p) for p in r] for r in CUSTOM[name]]
    else:
        sched, info = "pipelined", [
            tb.Round([tuple(p) for p in perm], np.asarray(sb, np.int32), np.asarray(rb, np.int32),
                     np.asarray(rm, bool)) for perm, sb, rb, rm in CUSTOM[name]]
    copied = tb.broadcast_buffers(col, dp=4, schedule=sched, n_blocks=4, rounds_info=info)
    want = arrays[f"custom/{name}"]
    for i in range(4):
        assert np.array_equal(u16(col[i]), want[i]), i
    # position 2 holds what position 1 held before the round, not the root's
    n = flat.numel() // 4 if sched == "pipelined" else flat.numel()
    assert bool((col[2][:n] == -8.0).all())
    # in each case two sources are overwritten in their round and staged
    sends = sum(len(r[0]) for r in CUSTOM[name]) if sched == "pipelined" else 3
    assert copied == (sends + 2) * n * flat.element_size()


def test_a_position_receiving_twice_in_a_round_raises():
    bufs = [torch.zeros(4) for _ in range(3)]
    with pytest.raises(ValueError, match="receives twice"):
        tb.broadcast_buffers(bufs, dp=3, schedule="binomial", n_blocks=1,
                             rounds_info=[[(0, 2), (1, 2)]])


# ----------------------------------------------------------------------
# tree_broadcast
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mesh_shape", ["4x2", "2x2x2"])
@pytest.mark.parametrize("tree_name", ["ref_test", "mixed"])
@pytest.mark.parametrize("sched,compress", VARIANTS)
def test_tree_broadcast_equals_reference(ref, monkeypatch, mesh_shape, tree_name, sched,
                                         compress):
    arrays, meta = ref
    monkeypatch.setattr(tb, "_stale_buffer", sentinel_buffer)
    shape = tuple(int(x) for x in mesh_shape.split("x"))
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    mesh = tmesh.make_mesh(shape, axes, device="cpu")
    res, rep, (bufs, scale_bufs) = tb.tree_broadcast(
        port_tree(tree_name), mesh, schedule=sched, n_blocks=4, compress=compress,
        return_buffers=True)
    key = f"tb/{mesh_shape}/{tree_name}/{sched}/{int(compress)}"
    want = dict(meta[key])
    dtypes = want.pop("dtypes")
    assert dataclasses.asdict(rep) == want
    leaves = [leaf for _, leaf in tree_leaves_with_path(res)]
    assert [str(l.dtype).removeprefix("torch.") for l in leaves] == dtypes
    for i, leaf in enumerate(leaves):
        assert np.array_equal(leaf_bits(leaf), arrays[f"{key}/{i}"]), i
    assert len(bufs) == 2 and all(len(col) == 4 for col in bufs)
    for col in bufs:
        for buf in col:
            assert same_bits(buf, bufs[0][0])
    if compress:
        assert np.array_equal(bufs[0][0].numpy(), arrays[f"q/{tree_name}"].reshape(-1))
        for col in scale_bufs:
            for buf in col:
                assert np.array_equal(buf.view(torch.int32).numpy(),
                                      arrays[f"scale/{tree_name}"].view(np.int32))
    else:
        assert scale_bufs is None


def test_reference_assertions_hold_on_the_port():
    """tests/test_broadcast.py's checks, on the port."""
    mesh = tmesh.make_test_mesh((4, 2), device="cpu")
    params = port_tree("ref_test")
    ser = {}
    for sched in tb.SCHEDULES:
        res, rep = tb.tree_broadcast(params, mesh, schedule=sched, n_blocks=4)
        assert all(torch.allclose(x, y, atol=2e-2) for x, y in zip(params.values(), res.values()))
        ser[sched] = rep.serialized_bytes
    assert ser["pipelined"] <= ser["binomial"] <= ser["naive"] <= ser["allgather"]
    res, rep = tb.tree_broadcast(params, mesh, schedule="pipelined", n_blocks=4, compress=True)
    err = max(float((x - y).abs().max()) for x, y in zip(params.values(), res.values()))
    assert err < 2e-2
    assert rep.payload_bytes < ser["pipelined"]


def test_modeled_time_takes_a_bandwidth():
    rep = tb.BroadcastReport("pipelined", 8, 32, 32 * 100, 66, 66 * 100)
    assert rep.modeled_time_s(450e9) == 6600 / 450e9
    with pytest.raises(TypeError):
        rep.modeled_time_s()


def test_unknown_schedule_raises():
    mesh = tmesh.make_mesh((2, 1), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="not in"):
        tb.tree_broadcast(port_tree("ref_test"), mesh, schedule="ring")


# ----------------------------------------------------------------------
# the mesh
# ----------------------------------------------------------------------
def test_meshes_on_the_cpu():
    m = tmesh.make_production_mesh(device="cpu")
    assert (m.axis_names, m.shape) == (("data", "model"), {"data": 16, "model": 16})
    m = tmesh.make_production_mesh(multi_pod=True, device="cpu")
    assert m.axis_names == ("pod", "data", "model") and m.devices.shape == (2, 16, 16)
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert tmesh.make_test_mesh(device="cpu").shape == {"data": 2, "model": 2}
    with pytest.raises(ValueError):
        tmesh.make_mesh((2, 2), ("data",), device="cpu")


@pytest.mark.parametrize("make", [
    lambda: tmesh.make_mesh((2, 2), ("data", "model")),
    lambda: tmesh.make_production_mesh(),
    lambda: tmesh.make_test_mesh(),
])
def test_entry_points_run_on_the_card_unless_asked(make):
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in make().devices.flat)
    else:
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            make()
