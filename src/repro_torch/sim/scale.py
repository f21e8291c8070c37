"""Cluster-scale scenario driver: N functions × M VMs in one burst (§4.2).

The paper's headline deployment result is provisioning 2500 function
containers across 1000 VMs in 8.3 s.  ``run_scale`` reproduces that shape:

  * an :class:`~repro_torch.core.ft_manager.FTManager` owns the VM pool and one
    FunctionTree per function (placement honours the ≤20 functions/VM
    production limit);
  * optional join/leave churn mutates the trees through the manager before
    the wave is planned (delete → AVL repair → re-insert at the frontier),
    exercising ``on_reparent`` exactly the way the provisioning layer does;
  * every function's :func:`~repro_torch.core.topology.faasnet_plan` is added to
    ONE shared :class:`~repro_torch.sim.engine.FlowSim`, so overlapping FTs
    contend for per-VM NICs and the registry exactly as in production;
  * the result reports provisioning makespan, simulator event throughput
    and peak registry egress.

Runs are bit-deterministic for a fixed :class:`ScaleConfig` (seeded RNG +
the engine's (time, seq) ordering), and bit-identical to the JAX package's
``repro.sim.scale.run_scale`` on the same config;
``tests/test_torch_vector_engine.py`` pins that against the reference and
its event-log SHA-256 golden.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

from repro_torch.core import FTManager, VMInfo
from repro_torch.core.registry import RegistrySpec, ShardResolver
from repro_torch.core.topology import faasnet_block_plan, faasnet_plan

from .cluster import WaveConfig
from .engine import SimConfig, make_sim


@dataclass
class ScaleConfig:
    """Workload shape + calibration for one cluster-scale burst."""

    n_vms: int = 1000
    n_functions: int = 5
    containers_per_function: int = 500  # 5 × 500 = the paper's 2500
    churn_ops: int = 0  # leave/re-join pairs applied before the wave
    stagger_s: float = 0.0  # inter-function wave arrival offset
    seed: int = 0
    max_functions_per_vm: int = 20  # production placement limit
    wave: WaveConfig = field(default_factory=WaveConfig)
    # Block-level provisioning: one ImageSpec per function (len ==
    # n_functions).  Each function's wave fetches its image's missing
    # blocks per layer and reports the runnable-prefix makespan alongside
    # full arrival.  ``None`` (default) keeps the scalar payload model
    # bit-identically.
    images: "list | None" = None  # list[repro_torch.core.image.ImageSpec]

    def total_containers(self) -> int:
        return self.n_functions * min(self.containers_per_function, self.n_vms)


def mega_burst_config(seed: int = 0, churn_ops: int = 200) -> ScaleConfig:
    """10× paper scale: 10k VMs, 25 functions, 100k containers, one burst.

    Exercises the O(log n) control plane (frontier/index FunctionTrees,
    incremental FTManager) far past the paper's §4.2 shape; the seed
    BFS-scan control plane could not stand this scenario up in minutes.
    """
    return ScaleConfig(
        n_vms=10_000,
        n_functions=25,
        containers_per_function=4_000,
        churn_ops=churn_ops,
        seed=seed,
        max_functions_per_vm=25,
    )


def giga_burst_config(
    seed: int = 0, churn_ops: int = 0, engine: str = "vector_torch"
) -> ScaleConfig:
    """100× paper scale: 100k VMs, 25 functions, 1M containers.

    The production-fleet tier the vectorized engine exists for (ROADMAP:
    "100k VMs / 1M containers ... in minutes").  The 25 function waves
    arrive as a burst train (``stagger_s=2.0``) — the §4.2 production
    regime where scale-out requests queue at the scheduler rather than
    landing in one instant — which keeps per-VM tree overlap low and the
    per-instant completion batches wide.  ~2M flow events; the
    per-event-Python incremental engine is far too slow for this tier,
    while the array-based backend batches the same-timestamp waves, so the
    tier defaults to ``engine="vector_torch"`` and drops the per-event text log
    (``record_trace=False`` — two million trace tuples are benchmark
    ballast, and golden hashes are pinned at the smaller tiers).
    """
    return ScaleConfig(
        n_vms=100_000,
        n_functions=25,
        containers_per_function=40_000,
        churn_ops=churn_ops,
        stagger_s=2.0,
        seed=seed,
        max_functions_per_vm=40,
        wave=WaveConfig(engine=engine, record_trace=False),
    )


def multi_tenant_config(
    seed: int = 0,
    *,
    n_tenants: int = 8,
    vm_pool_size: int = 2000,
    minutes: int = 25,
    scale: float = 0.25,
    system: str = "faasnet",
    failover_at: int | None = 12 * 60,
    check_partition: bool = False,
    registry: "RegistrySpec | None" = None,
    placement: str = "shared",
    ft_aware_placement: bool = True,
    reclaim: str = "fixed",
) -> "MultiTenantConfig":
    """The trace-driven companion of :func:`mega_burst_config` (§4.2 waves).

    N tenants cycle through the four trace shapes — IoT, synthetic gaming,
    diurnal (phase-staggered so peaks only partially overlap) and constant
    background — all contending for one 2000-VM pool, one registry and one
    FlowSim, with a scheduler failover mid-wave by default.  Each trace
    shape carries a distinct per-instance memory requirement (gaming 2048 MB
    … constant 256 MB), so under ``placement="shared"`` co-location on the
    4 GB VMs is genuinely memory-constrained; ``placement="exclusive"``
    reproduces the legacy one-VM-one-tenant leasing.  The returned config
    drives :class:`repro_torch.sim.multi_tenant.MultiTenantReplay`;
    ``examples/torch_trace_replay.py --multi`` is its CLI twin.  The wave
    keeps the port's default engine, ``vector_torch`` on ``"cuda"``; set
    ``cfg.wave.device = "cpu"`` to run the cap chain's plain version.
    """
    from .multi_tenant import MultiTenantConfig, TenantConfig
    from .traces import (
        constant_trace,
        diurnal_trace,
        iot_trace,
        synthetic_gaming_trace,
    )

    duration = minutes * 60
    tenants: list[TenantConfig] = []
    for i in range(n_tenants):
        kind = i % 4
        if kind == 0:
            trace = iot_trace(scale=scale)[:duration]
            name, mem_mb = "iot", 512
        elif kind == 1:
            trace = synthetic_gaming_trace(scale=4 * scale)[:duration]
            name, mem_mb = "gaming", 2048
        elif kind == 2:
            trace = diurnal_trace(
                duration_s=duration, phase_s=150 * i, scale=4 * scale
            )
            name, mem_mb = "diurnal", 1024
        else:
            trace = constant_trace(duration_s=duration, scale=4 * scale)
            name, mem_mb = "constant", 256
        tenants.append(
            TenantConfig(
                function_id=f"{name}{i}",
                trace=trace,
                seed=seed * 1000 + i,  # decorrelated arrival jitter per tenant
                mem_mb=mem_mb,
            )
        )
    return MultiTenantConfig(
        tenants=tenants,
        system=system,
        vm_pool_size=vm_pool_size,
        idle_reclaim_s=7 * 60.0,
        failover_at=failover_at,
        check_partition=check_partition,
        registry=registry,
        placement=placement,
        ft_aware_placement=ft_aware_placement,
        reclaim=reclaim,
    )


def serving_config(
    seed: int = 0,
    *,
    herd_control: bool = True,
    cpu_slots: int = 2,
    drain_budget_s: float = 15.0,
    rate_window_s: int = 30,
    **kwargs,
) -> "MultiTenantConfig":
    """The request-serving companion of :func:`multi_tenant_config`.

    Same 8-tenant diurnal mix against the shared 2000-VM pool, but with a
    :class:`repro_torch.sim.multi_tenant.ServingConfig` attached: arrivals are
    stamped at sub-second offsets, the per-function FIFO queues drain
    against instance free times (end-to-end p50/p99 response is the
    headline metric instead of provisioning makespan), co-located requests
    contend for per-VM CPU slots and scale-out runs in herd-controlled
    provisioning waves.  ``herd_control=False`` keeps sub-tick dispatch but
    reverts admission to the legacy one-reservation-per-deficit-unit rule —
    the comparison baseline of the serving benchmark.  Remaining ``kwargs``
    pass through to
    :func:`multi_tenant_config`.
    """
    from .multi_tenant import ServingConfig

    cfg = multi_tenant_config(seed, **kwargs)
    cfg.serving = ServingConfig(
        cpu_slots=cpu_slots,
        herd_control=herd_control,
        drain_budget_s=drain_budget_s,
        rate_window_s=rate_window_s,
    )
    return cfg


def giga_replay_config(
    seed: int = 0,
    *,
    n_tenants: int = 32,
    minutes: int = 8,
    scale: float = 0.5,
    engine: str = "vector_torch",
) -> "MultiTenantConfig":
    """Full trace replay at the giga tier: serving + blocks, 100k-VM pool.

    The end-to-end companion of :func:`giga_burst_config`: where the burst
    tier stresses raw flow-event throughput on isolated waves, this drives
    every subsystem at once through one shared vector engine —
    32 tenants of sub-tick request serving (CPU slots, herd-controlled
    scale-out), block-level on-demand provisioning against four shared base
    images, idle reclaim and a mid-run scheduler failover, all against the
    100k-VM fleet.  Exists to prove the wide-front vector engine under the
    replay loop's interleaved ``run(until=...)`` stepping rather than one
    monolithic ``run()``.  The JAX package records it as ``giga_replay`` in
    ``BENCH_scale.json``; ``chip_smoke.py``'s ``giga_replay`` phase runs it
    here on ``vector_torch``, ``"cuda"`` (the wave's default device), every
    wide front through the cap-chain kernel, and holds it equal to the numpy
    ``vector`` engine and to those counts.
    """
    from repro_torch.core.image import shared_base_images

    cfg = serving_config(
        seed,
        n_tenants=n_tenants,
        vm_pool_size=100_000,
        minutes=minutes,
        scale=scale,
        failover_at=(minutes * 60) // 2,  # default 720s outlives short replays
    )
    cfg.wave.engine = engine
    cfg.wave.record_trace = False
    images = shared_base_images(
        n_tenants, 4, image_bytes=cfg.wave.image_bytes
    )
    cfg.images = {
        t.function_id: img for t, img in zip(cfg.tenants, images)
    }
    return cfg


@dataclass
class ScaleResult:
    makespan: float  # sim seconds: last payload fully fetched
    provision_makespan: float  # + container start + image load
    per_function: dict[str, float]  # function id -> fetch makespan
    n_containers: int
    n_flows: int
    events: int  # engine events processed
    wall_s: float  # wall-clock seconds inside FlowSim.run
    events_per_s: float
    peak_registry_egress: float  # bytes/s, aggregate across shards
    reparents: int  # on_reparent notifications during churn
    tree_stats: dict[str, dict[str, int]]
    trace: list  # the engine's (time, event) log — golden-test fodder
    # Control-plane timings (wall-clock, seconds) ----------------------
    build_s: float = 0.0  # stand up VM pool + all FunctionTrees
    churn_s: float = 0.0  # apply_churn total
    churn_op_s: float = 0.0  # mean latency of one delete+reinsert churn op
    # Per-shard peak egress (shard id -> bytes/s); one entry per shard hit.
    peak_shard_egress: dict[str, float] = field(default_factory=dict)
    engine: str = "vector_torch"  # backend that produced this result
    # Block mode only (cfg.images set): sim time when the last container's
    # boot working set landed — the §3.2 runnable milestone.  0.0 otherwise.
    runnable_makespan: float = 0.0
    # Vector engines only ({} otherwise): per-run recompute dispatch
    # telemetry — scalar-vs-vector front counts, per-front flow totals, the
    # front-width histogram (bucket k = widths [2^(k-1), 2^k)) and the
    # retired per-depth sweep's dispatch count (``legacy_levels``), so
    # BENCH_scale.json can prove the wide-front batching claim from a run's
    # own numbers: ``legacy_levels / (fronts_scalar + fronts_vector)`` is
    # the dispatch-reduction factor.
    dispatch_stats: dict = field(default_factory=dict)


def _function_ids(cfg: ScaleConfig) -> list[str]:
    return [f"fn{i}" for i in range(cfg.n_functions)]


def build_manager(cfg: ScaleConfig) -> tuple[FTManager, dict[str, list[str]]]:
    """Stand up the VM pool and one FT per function via the manager API."""
    if cfg.n_vms < 1 or cfg.n_functions < 1 or cfg.containers_per_function < 1:
        raise ValueError(
            f"scale scenario needs >=1 VM, function and container per function "
            f"(got n_vms={cfg.n_vms}, n_functions={cfg.n_functions}, "
            f"containers_per_function={cfg.containers_per_function})"
        )
    rng = random.Random(cfg.seed)
    mgr = FTManager(max_functions_per_vm=cfg.max_functions_per_vm)
    vms = [f"vm{i:04d}" for i in range(cfg.n_vms)]
    for v in vms:
        mgr.add_free_vm(VMInfo(v))
    for _ in vms:  # whole pool reserved for the burst
        mgr.reserve_vm()
    members: dict[str, list[str]] = {}
    per_fn = min(cfg.containers_per_function, cfg.n_vms)
    for fid in _function_ids(cfg):
        chosen = rng.sample(vms, per_fn)
        mgr.bulk_insert(fid, chosen)
        members[fid] = chosen
    return mgr, members


def apply_churn(mgr: FTManager, members: dict[str, list[str]], cfg: ScaleConfig) -> int:
    """Leave/re-join churn through the manager; returns reparent count.

    Each op deletes a random member of a random tree (AVL repair fires
    ``on_reparent`` for every node whose upstream moved) and re-inserts it
    at the BFS frontier — the paper's VM reclaim + later re-activation.
    """
    if cfg.churn_ops <= 0:
        return 0
    rng = random.Random(cfg.seed + 1)
    reparents = 0

    def count(node, old_parent, new_parent):  # noqa: ANN001 - FT callback
        nonlocal reparents
        reparents += 1

    fids = _function_ids(cfg)
    for ft in mgr.trees.values():
        ft.on_reparent.append(count)
    try:
        for _ in range(cfg.churn_ops):
            fid = fids[rng.randrange(len(fids))]
            vms_in = members[fid]
            victim = vms_in[rng.randrange(len(vms_in))]
            mgr.delete(fid, victim)
            mgr.insert(fid, victim)
    finally:
        for ft in mgr.trees.values():
            if count in ft.on_reparent:
                ft.on_reparent.remove(count)
    return reparents


def run_scale(cfg: ScaleConfig | None = None) -> ScaleResult:
    """Provision ``n_functions`` × ``containers_per_function`` in one burst."""
    cfg = cfg or ScaleConfig()
    w = cfg.wave
    t_build0 = time.perf_counter()
    mgr, members = build_manager(cfg)
    build_s = time.perf_counter() - t_build0
    t_churn0 = time.perf_counter()
    reparents = apply_churn(mgr, members, cfg)
    churn_s = time.perf_counter() - t_churn0

    spec = w.registry_spec()
    # ONE resolver across all per-function plans: stateful placement policies
    # (least_loaded / replicated) see the whole burst's assignments.
    resolver = ShardResolver(spec)
    sim = make_sim(
        SimConfig(
            registry=spec,
            per_stream_cap=w.per_stream_cap,
            hop_latency=w.hop_latency,
            engine=w.engine,
            record_trace=w.record_trace,
            vector_scalar_cutoff=w.vector_scalar_cutoff,
            device=w.device,
        )
    )
    control = w.rpc.control_plane_total()
    images = cfg.images
    if images is not None and len(images) != cfg.n_functions:
        raise ValueError(
            f"need one ImageSpec per function: {len(images)} images, "
            f"{cfg.n_functions} functions"
        )
    cache = None
    if images is not None:
        from repro_torch.core.image import BlockCache

        cache = BlockCache()
    done_at: dict[tuple[str, str], float] = {}
    runnable_at: dict[tuple[str, str], float] = {}

    def accum_done(fid: str, vm: str, t: float) -> None:
        # block plans fire once per layer flow; the max is full arrival
        key = (fid, vm)
        if t > done_at.get(key, float("-inf")):
            done_at[key] = t

    n_flows = 0
    for i, fid in enumerate(_function_ids(cfg)):
        if images is not None:
            plan = faasnet_block_plan(
                mgr.trees[fid],
                image=images[i],
                cache=cache,
                manifest_latency=w.rpc.manifest_fetch,
                registry=resolver,
            )
            n_flows += len(plan.flows)
            sim.add_plan(
                plan,
                t0=control + i * cfg.stagger_s,
                on_node_done=lambda vm, t, fid=fid: accum_done(fid, vm, t),
                on_node_runnable=lambda vm, t, fid=fid: runnable_at.setdefault(
                    (fid, vm), t
                ),
            )
            continue
        plan = faasnet_plan(
            mgr.trees[fid],
            image_bytes=w.image_bytes,
            startup_fraction=w.startup_fraction,
            manifest_latency=w.rpc.manifest_fetch,
            piece=fid,
            registry=resolver,
        )
        n_flows += len(plan.flows)
        sim.add_plan(
            plan,
            t0=control + i * cfg.stagger_s,
            on_node_done=lambda vm, t, fid=fid: done_at.setdefault((fid, vm), t),
        )

    t0 = time.perf_counter()
    sim.run()
    wall = time.perf_counter() - t0

    expected = cfg.total_containers()
    complete = len(runnable_at) if images is not None else len(done_at)
    if complete != expected:  # pragma: no cover - indicates a sim bug
        raise RuntimeError(
            f"scale wave incomplete: {complete}/{expected} containers done"
        )
    per_function = {fid: 0.0 for fid in _function_ids(cfg)}
    for (fid, _vm), t in done_at.items():
        per_function[fid] = max(per_function[fid], t)
    makespan = max(per_function.values())
    return ScaleResult(
        makespan=makespan,
        provision_makespan=makespan + w.container_start + w.rpc.image_load,
        per_function=per_function,
        n_containers=expected,
        n_flows=n_flows,
        events=sim.events_processed,
        wall_s=wall,
        events_per_s=sim.events_processed / wall if wall > 0 else float("inf"),
        peak_registry_egress=sim.peak_registry_egress,
        peak_shard_egress=dict(sim.peak_shard_egress),
        reparents=reparents,
        tree_stats=mgr.tree_stats(),
        trace=sim.trace,
        build_s=build_s,
        churn_s=churn_s,
        churn_op_s=churn_s / cfg.churn_ops if cfg.churn_ops > 0 else 0.0,
        engine=w.engine,
        runnable_makespan=max(runnable_at.values()) if runnable_at else 0.0,
        dispatch_stats=_snapshot_dispatch_stats(sim),
    )


def _snapshot_dispatch_stats(sim) -> dict:
    """Deep-copied engine dispatch telemetry ({} for non-vector engines)."""
    ds = getattr(sim, "dispatch_stats", None)
    if not ds:
        return {}
    out = dict(ds)
    out["front_width_hist"] = dict(ds.get("front_width_hist", {}))
    fronts = out.get("fronts_scalar", 0) + out.get("fronts_vector", 0)
    out["dispatch_reduction"] = (
        out.get("legacy_levels", 0) / fronts if fronts else 0.0
    )
    return out
