"""The port's trace replay held against the JAX package's, on the CPU.

``repro_torch.sim.MultiTenantReplay`` (and its one-tenant facade
``TraceReplay``) must reproduce the JAX package's replay exactly:

  * the two replay goldens — ``GOLDEN_EXCLUSIVE_3T`` (TickStats stream) and
    ``GOLDEN_SERVING_3T`` (response stream) — hold through the port on the
    ``incremental``, ``vector`` and ``vector_torch`` (``device="cpu"``: the
    cap chain's plain PyTorch version) engines, the vector engines also at
    ``vector_scalar_cutoff=0``, where every front takes the batched route;
  * the TickStats streams, response streams and ``MultiTenantResult`` equal
    the JAX replay's on four configs (exclusive, shared with the histogram
    reclaim policy, serving, and the giga-replay combination at test
    scale), through a mid-wave failover and across a snapshot handed from
    one package's replay to the other's;
  * the config factories build the same configs, but for the port's
    engine default (``vector_torch`` on ``"cuda"``), and a replay asked for
    ``"cuda"`` where CUDA is absent raises instead of running on the CPU.

Every comparison is exact.
"""
import dataclasses
import json

import pytest
import torch

import repro.sim as jsim
import repro_torch.sim as tsim
from repro.sim.scale import giga_replay_config as jax_giga_replay_config
from repro_torch.sim.scale import giga_replay_config
from test_placement import GOLDEN_EXCLUSIVE_3T, _stream_hash
from test_request_serving import GOLDEN_SERVING_3T, _response_hash

GIGA = {jsim: jax_giga_replay_config, tsim: giga_replay_config}
KINDS = ("exclusive", "shared", "serving", "giga")


def make_cfg(pkg, kind: str, *, engine: str | None = None, cutoff: int = 64, **kw):
    """One replay config built in ``pkg`` (``repro.sim`` or ``repro_torch.sim``).

    ``exclusive`` and ``shared`` are ``tests/test_placement.py``'s
    ``_three_tenant_cfg`` (3 tenants x 250 VMs x 4 min), ``serving`` is
    ``tests/test_request_serving.py``'s ``_serving_3t_cfg`` (3 min, shared),
    and ``giga`` is ``giga_replay_config(0, n_tenants=4, minutes=2,
    scale=0.25)`` on a 300-VM pool (serving + blocks + a failover).  ``kw``
    sets further config fields.  ``engine=None`` keeps the package's own
    default; the port's wave always runs on ``"cpu"``.
    """
    if kind == "giga":
        cfg = GIGA[pkg](0, n_tenants=4, minutes=2, scale=0.25)
        cfg.vm_pool_size = 300
        for name, value in kw.items():
            setattr(cfg, name, value)
    else:
        dur = (3 if kind == "serving" else 4) * 60
        gaming = pkg.synthetic_gaming_trace()[10 * 60 : 10 * 60 + dur]
        if kind == "serving":
            kw.setdefault("serving", pkg.ServingConfig())
        cfg = pkg.MultiTenantConfig(
            tenants=[
                pkg.TenantConfig("gaming", gaming, seed=1),
                pkg.TenantConfig("diurnal", pkg.diurnal_trace(duration_s=dur, phase_s=300), seed=2),
                pkg.TenantConfig("steady", pkg.constant_trace(duration_s=dur), seed=3),
            ],
            system="faasnet",
            vm_pool_size=250,
            idle_reclaim_s=120.0,
            placement="exclusive" if kind == "exclusive" else "shared",
            check_partition=True,
            **kw,
        )
    if engine is not None:
        cfg.wave.engine = engine
    cfg.wave.vector_scalar_cutoff = cutoff
    if pkg is tsim:
        cfg.wave.device = "cpu"
    return cfg


def assert_same_replay(got, got_res, want, want_res):
    """Two finished replays (port, JAX) agree field by field, streams included."""
    for a, b in zip(got.tenants, want.tenants, strict=True):
        fid = b.cfg.function_id
        assert a.cfg.function_id == fid
        assert [dataclasses.astuple(x) for x in a.timeline] == [
            dataclasses.astuple(x) for x in b.timeline
        ], fid
        assert a.responses == b.responses, fid
        assert a.prov_latencies == b.prov_latencies, fid
    names = [f.name for f in dataclasses.fields(want_res)]
    assert [f.name for f in dataclasses.fields(got_res)] == names
    for name in names:
        g, w = getattr(got_res, name), getattr(want_res, name)
        if name == "per_tenant":
            assert list(g) == list(w)
            for fid in w:
                assert dataclasses.astuple(g[fid]) == dataclasses.astuple(w[fid]), fid
                assert [f.name for f in dataclasses.fields(g[fid])] == [
                    f.name for f in dataclasses.fields(w[fid])
                ]
        elif name == "timelines":
            assert list(g) == list(w)
            for fid in w:
                assert [dataclasses.astuple(x) for x in g[fid]] == [
                    dataclasses.astuple(x) for x in w[fid]
                ], fid
        else:
            assert g == w, name
    assert got_res.vm_hours() == want_res.vm_hours()


def _run(pkg, cfg):
    rep = pkg.MultiTenantReplay(cfg)
    return rep, rep.run()


# ----------------------------------------------------------------------
# The two replay goldens, on every engine of the port
# ----------------------------------------------------------------------
ENGINE_CASES = [
    ("incremental", 64),
    ("vector", 64),
    ("vector", 0),
    ("vector_torch", 64),
    ("vector_torch", 0),
]


@pytest.mark.parametrize("engine,cutoff", ENGINE_CASES)
@pytest.mark.parametrize("kind", ["exclusive", "serving"])
def test_golden_holds_through_port(kind, engine, cutoff):
    rep, res = _run(tsim, make_cfg(tsim, kind, engine=engine, cutoff=cutoff))
    if kind == "exclusive":
        assert _stream_hash(res) == GOLDEN_EXCLUSIVE_3T
    else:
        assert _response_hash(rep) == GOLDEN_SERVING_3T
    if engine != "incremental":
        ds = rep.sim.dispatch_stats
        assert ds["fronts_vector"] > 0
        if cutoff == 0:
            assert ds["fronts_scalar"] == 0
        if engine == "vector_torch":
            # every wide front went through the cap chain's plain version
            assert ds["fronts_torch"] == ds["fronts_vector"]
            assert ds["flows_torch"] == ds["flows_vector"]


def test_exclusive_golden_survives_failover_through_port():
    rep, res = _run(tsim, make_cfg(tsim, "exclusive", engine="vector_torch", failover_at=90))
    assert res.failovers == 1
    assert _stream_hash(res) == GOLDEN_EXCLUSIVE_3T


# ----------------------------------------------------------------------
# Same streams and results as the JAX replay
# ----------------------------------------------------------------------
SAME_CASES = [
    ("exclusive", {}),
    ("shared", {"reclaim": "histogram"}),
    ("serving", {}),
    ("giga", {}),
]


@pytest.mark.parametrize("cutoff", [64, 0])
@pytest.mark.parametrize("kind,kw", SAME_CASES, ids=[k for k, _ in SAME_CASES])
def test_replay_equals_reference(kind, kw, cutoff):
    want_rep, want = _run(jsim, make_cfg(jsim, kind, **kw))
    got_rep, got = _run(tsim, make_cfg(tsim, kind, engine="vector_torch", cutoff=cutoff, **kw))
    assert_same_replay(got_rep, got, want_rep, want)
    if kind == "giga":
        assert got.failovers == 1
        assert got.cold_starts == 216
        assert got_rep.sim.dispatch_stats["fronts_torch"] > 0


@pytest.mark.parametrize("kind", KINDS)
def test_failover_matches_uninterrupted_run(kind):
    # the giga config fails over mid-run on its own; the others at t=62
    failover = {} if kind == "giga" else {"failover_at": 62}
    failed_rep, failed = _run(tsim, make_cfg(tsim, kind, engine="vector_torch", **failover))
    plain_rep, plain = _run(tsim, make_cfg(tsim, kind, engine="vector_torch", failover_at=None))
    assert failed.failovers == 1 and plain.failovers == 0
    failed.failovers = plain.failovers
    assert_same_replay(failed_rep, failed, plain_rep, plain)


def _handed_over(src, dst, kind: str, at: int):
    """Run ``dst``'s replay with a failover at ``at`` that restores from the
    wire copy of ``src``'s replay's snapshot at the same tick."""
    wire = {}

    class Source(src.MultiTenantReplay):
        def snapshot(self):
            blob = super().snapshot()
            wire["blob"] = json.dumps(blob, sort_keys=True)
            return blob

    Source(make_cfg(src, kind, failover_at=at)).run()

    class Destination(dst.MultiTenantReplay):
        def snapshot(self):
            own = json.dumps(super().snapshot(), sort_keys=True)
            wire["own"] = own
            return json.loads(wire["blob"])

    rep = Destination(make_cfg(dst, kind, failover_at=at))
    return rep, rep.run(), wire


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind", ["shared", "serving"])
def test_snapshot_handed_between_packages(kind, direction):
    src, dst = (jsim, tsim) if direction == "jax_to_port" else (tsim, jsim)
    rep, res, wire = _handed_over(src, dst, kind, at=62)
    assert res.failovers == 1
    # both schedulers held the same control plane at the failover tick
    assert wire["own"] == wire["blob"]
    blob = json.loads(wire["blob"])
    if kind == "serving":
        assert blob["version"] == 3
        assert len(blob["serving"]["queues"]["gaming"]) > 0  # a parked herd crossed
    want_rep, want = _run(jsim, make_cfg(jsim, kind, failover_at=None))
    res.failovers = 0
    if dst is tsim:
        assert_same_replay(rep, res, want_rep, want)
    else:
        assert_same_replay(want_rep, want, rep, res)


def test_jax_snapshot_restores_into_fresh_port_replay():
    rep = jsim.MultiTenantReplay(make_cfg(jsim, "serving"))
    for t in range(63):
        rep.sim.run(until=float(t))
        for ts in rep.tenants:
            rep._step_tenant(ts, t, float(t))
    blob = json.loads(json.dumps(rep.snapshot(), sort_keys=True))
    fresh = tsim.MultiTenantReplay(make_cfg(tsim, "serving", engine="vector_torch"))
    fresh.restore_snapshot(blob)
    assert fresh.mgr.wave_locks == rep.mgr.wave_locks
    assert fresh.mgr.wave_locks.get("gaming", 0) > 0
    for a, b in zip(fresh.tenants, rep.tenants, strict=True):
        assert list(a.queue) == list(b.queue)
    assert json.dumps(fresh.snapshot(), sort_keys=True) == json.dumps(blob, sort_keys=True)


# ----------------------------------------------------------------------
# TraceReplay: the one-tenant facade, cases of tests/test_trace_replay.py
# ----------------------------------------------------------------------
def _trace_replay(pkg, system: str, minutes: int = 12, **kw):
    if pkg is tsim:
        kw["wave"] = tsim.WaveConfig(device="cpu")
    r = pkg.TraceReplay(pkg.ReplayConfig(system=system, idle_reclaim_s=420, vm_pool_size=300, **kw))
    r.run(pkg.iot_trace(scale=1 / 3)[: minutes * 60])
    return r


def _assert_same_trace_replay(got, want):
    assert [dataclasses.astuple(x) for x in got.timeline] == [
        dataclasses.astuple(x) for x in want.timeline
    ]
    assert got.responses == want.responses
    assert got.prov_latencies == want.prov_latencies
    assert got.prov_makespan_s() == want.prov_makespan_s()
    burst_t = 9 * 60
    for normal_s in (3.0, 3.5):
        assert got.recovery_time(burst_t + 60, normal_s=normal_s) == want.recovery_time(
            burst_t + 60, normal_s=normal_s
        )


@pytest.mark.parametrize("system", ["faasnet", "baseline", "on_demand"])
def test_trace_replay_equals_reference(system):
    got, want = _trace_replay(tsim, system), _trace_replay(jsim, system)
    _assert_same_trace_replay(got, want)
    assert got.sim.dispatch_stats["fronts_torch"] == got.sim.dispatch_stats["fronts_vector"]
    if system == "faasnet":
        heights = [ts.ft_height for ts in got.timeline]
        assert max(heights) >= 4 and max(heights[: 8 * 60]) < max(heights)
        assert got.mgr.tree_stats() == want.mgr.tree_stats()


def test_trace_replay_faasnet_beats_baseline_through_port():
    f, b = _trace_replay(tsim, "faasnet"), _trace_replay(tsim, "baseline")
    assert f.prov_makespan_s() < b.prov_makespan_s()
    assert max(f.prov_latencies) < max(b.prov_latencies)


def test_trace_replay_empty_is_zero_through_port():
    r = tsim.TraceReplay(tsim.ReplayConfig(system="faasnet", vm_pool_size=4, wave=tsim.WaveConfig(device="cpu")))
    r.run([0.0] * 10)
    assert r.prov_latencies == [] and r.prov_makespan_s() == 0.0


def test_single_tenant_shared_equals_exclusive_through_port():
    runs = {p: _trace_replay(tsim, "faasnet", minutes=8, placement=p) for p in ("shared", "exclusive")}
    _assert_same_trace_replay(runs["shared"], runs["exclusive"])
    _assert_same_trace_replay(runs["shared"], _trace_replay(jsim, "faasnet", minutes=8, placement="shared"))


# ----------------------------------------------------------------------
# Config factories
# ----------------------------------------------------------------------
def _same_config(got, want):
    """Every field equal, but for the wave's engine and device."""
    assert [dataclasses.astuple(t) for t in got.tenants] == [
        dataclasses.astuple(t) for t in want.tenants
    ]
    for f in dataclasses.fields(want):
        if f.name in ("tenants", "wave", "serving", "images", "registry"):
            continue
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    for name in ("serving", "registry"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None) and (w is None or dataclasses.astuple(g) == dataclasses.astuple(w))
    gw, ww = dataclasses.asdict(got.wave), dataclasses.asdict(want.wave)
    assert gw.pop("device") == "cuda" and gw.pop("engine") == "vector_torch"
    ww.pop("engine")
    assert gw == ww
    assert (got.images is None) == (want.images is None)
    if want.images is not None:
        assert list(got.images) == list(want.images)
        for fid in want.images:
            assert dataclasses.astuple(got.images[fid]) == dataclasses.astuple(want.images[fid])


@pytest.mark.parametrize(
    "factory,kw",
    [
        ("multi_tenant_config", {}),
        ("multi_tenant_config", {"seed": 3, "n_tenants": 5, "placement": "exclusive", "reclaim": "histogram"}),
        ("serving_config", {}),
        ("serving_config", {"herd_control": False, "cpu_slots": 4, "minutes": 20}),
    ],
)
def test_config_factories_equal_reference(factory, kw):
    got, want = getattr(tsim, factory)(**kw), getattr(jsim, factory)(**kw)
    _same_config(got, want)
    assert len(got.tenants) == kw.get("n_tenants", 8)
    assert {t.function_id[:3] for t in got.tenants} == {"iot", "gam", "diu", "con"}
    assert 0 < got.failover_at < got.duration_s()
    assert (got.serving is not None) == (factory == "serving_config")


def test_giga_replay_config_shape_in_port():
    cfg = giga_replay_config(0)
    _same_config(cfg, jax_giga_replay_config(0))
    assert cfg.serving is not None and cfg.images is not None
    assert set(cfg.images) == {t.function_id for t in cfg.tenants}
    assert cfg.wave.engine == "vector_torch" and cfg.wave.device == "cuda"
    assert cfg.wave.record_trace is False
    assert cfg.vm_pool_size == 100_000
    assert cfg.failover_at is not None and cfg.failover_at < cfg.duration_s()
    assert giga_replay_config(0, engine="vector").wave.engine == "vector"


# ----------------------------------------------------------------------
# No silent CPU
# ----------------------------------------------------------------------
def test_replay_on_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsim.MultiTenantReplay(giga_replay_config(0, n_tenants=4, minutes=2, scale=0.25))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsim.TraceReplay(tsim.ReplayConfig(vm_pool_size=4)).run([1.0] * 5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsim.MultiTenantReplay(tsim.serving_config(0))
