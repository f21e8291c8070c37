"""Reproduce the paper's §4.2 burst on the port: 2500 containers across 1000 VMs.

The port's counterpart of ``benchmarks/bench_scale_1000.py``, with its keys
and structure: runs the ``repro_torch.sim.scale`` harness at deployment size
and writes ``BENCH_torch_scale.json`` with the provisioning makespan,
simulator event throughput and peak registry egress.  The paper reports
8.3 s for this wave on production infrastructure.

Engines, so that the card runs where the reference runs its fast tier:

  * each tier's main run keeps the reference's incremental engine
    (``engine="incremental"``, passed explicitly: the port's ``WaveConfig``
    defaults to ``vector_torch``);
  * each tier's twin runs ``vector_torch`` on ``--device``, every wide front
    through the cap-chain kernel (K1) on the card, so ``matches_incremental``
    is the card engine's bit-identity check and ``speedup_vs_incremental``
    the card engine's;
  * ``--giga`` runs ``giga_burst_config`` / ``giga_replay_config`` as the
    port defines them (``vector_torch``) on ``--device``;
  * the ``--profile`` queue microbenchmark keeps the numpy ``VectorFlowSim``
    and ``--compare-reference`` the full-recompute ``ReferenceFlowSim``.

Usage::

    PYTHONPATH=src python benchmarks_torch/bench_scale_1000.py          # on the card
    PYTHONPATH=src python benchmarks_torch/bench_scale_1000.py --quick --device cpu
    PYTHONPATH=src python benchmarks_torch/bench_scale_1000.py --mega --giga

Every run also records the control-plane microbenchmark (a 10,000-node
FunctionTree via ``FTManager.bulk_insert``, churn-op and ``pick_vm_for``
latency) and, under ``device``, the card's name and power limit and K1's
launches of each run.  The ``--giga`` burst's events/s is asserted against
``--min-giga-evs``, the reference's floor.
"""
from __future__ import annotations

import argparse
import json
import time


def _result_dict(cfg, res) -> dict:
    d = {
        "engine": res.engine,
        "n_vms": cfg.n_vms,
        "n_functions": cfg.n_functions,
        "containers_per_function": cfg.containers_per_function,
        "n_containers": res.n_containers,
        "churn_ops": cfg.churn_ops,
        "seed": cfg.seed,
        "fetch_makespan_s": res.makespan,
        "provision_makespan_s": res.provision_makespan,
        "per_function_makespan_s": res.per_function,
        "n_flows": res.n_flows,
        "events": res.events,
        "wall_s": res.wall_s,
        "events_per_s": res.events_per_s,
        "peak_registry_egress_bytes_per_s": res.peak_registry_egress,
        "peak_registry_egress_gbps": res.peak_registry_egress * 8 / 1e9,
        "reparents_during_churn": res.reparents,
        "control_plane_build_s": res.build_s,
        "churn_wall_s": res.churn_s,
        "churn_op_latency_s": res.churn_op_s,
        "ft_heights": {
            fid: st["height"] for fid, st in sorted(res.tree_stats.items())
        },
    }
    if res.dispatch_stats:
        # Vector engines: scalar-vs-vector front counts, the front-width
        # histogram and the retired per-depth sweep's dispatch count;
        # ``vector_torch`` adds its fronts and flows through K1.
        d["dispatch_stats"] = res.dispatch_stats
    return d


def _control_plane_micro(n: int = 10_000, churn: int = 500, picks: int = 1000) -> dict:
    """Time the control plane in isolation: FT build, churn ops, placement."""
    import random

    from repro_torch.core import FTManager, VMInfo

    mgr = FTManager(max_functions_per_vm=30)
    vm_ids = [f"vm{i:05d}" for i in range(n)]
    for v in vm_ids:
        mgr.add_free_vm(VMInfo(v))
    for _ in vm_ids:
        mgr.reserve_vm()
    t0 = time.perf_counter()
    ft = mgr.bulk_insert("bench", vm_ids)
    ft_build_s = time.perf_counter() - t0
    ft.check_invariants()

    rng = random.Random(0)
    t0 = time.perf_counter()
    for _ in range(churn):
        v = vm_ids[rng.randrange(n)]
        mgr.delete("bench", v)
        mgr.insert("bench", v)
    churn_op_s = (time.perf_counter() - t0) / churn

    t0 = time.perf_counter()
    for k in range(picks):
        mgr.pick_vm_for(f"pick{k}")
    pick_s = (time.perf_counter() - t0) / picks
    return {
        "ft_nodes": n,
        "ft_build_s": ft_build_s,
        "churn_op_latency_s": churn_op_s,
        "pick_vm_latency_s": pick_s,
    }


def _queue_micro(n: int = 200_000) -> dict:
    """Time the numpy vector engine's event-queue maintenance in isolation.

    ``_fold_events`` merges the staged ``schedule()`` backlog plus the live
    heap into one (t, seq)-sorted snapshot; ``_compact_done_heap`` rebuilds
    the completion heap without its stale (lazily-invalidated) entries.
    Both are host passes, the same in ``vector_torch``, which inherits them.
    """
    import heapq
    import random

    import numpy as np

    from repro_torch.sim.engine import SimConfig
    from repro_torch.sim.vector_engine import VectorFlowSim

    rng = random.Random(0)
    sim = VectorFlowSim(SimConfig(engine="vector", record_trace=False))
    # A half-consumed sorted snapshot plus a heap of fresh arrivals — the
    # state _fold_events sees mid-burst when a bulk schedule() lands.
    ts = sorted(rng.random() * 100.0 for _ in range(n))
    sim._sts = ts
    sim._sseq = list(range(n))
    sim._spay = [None] * n
    sim._sptr = n // 2
    heap = [(rng.random() * 100.0, n + i, None) for i in range(n // 4)]
    heapq.heapify(heap)
    sim._ev_heap = heap
    t0 = time.perf_counter()
    sim._fold_events()
    fold_s = time.perf_counter() - t0

    # A completion heap where half the entries are stale epochs — the
    # steady-state ratio the lazy-invalidation compaction runs against.
    m = n
    sim._fdone = np.zeros(m, dtype=bool)
    sim._fstarted = np.ones(m, dtype=bool)
    sim._epoch = np.zeros(m, dtype=np.int64)
    done = [
        (rng.random() * 100.0, fid, 1 if rng.random() < 0.5 else 0)
        for fid in range(m)
    ]
    heapq.heapify(done)
    sim._done_heap = done
    t0 = time.perf_counter()
    sim._compact_done_heap()
    compact_s = time.perf_counter() - t0
    return {
        "n_events": n + n // 4 - n // 2,
        "fold_events_s": fold_s,
        "done_heap_entries": m,
        "compact_done_heap_s": compact_s,
    }


def _time_reference(cfg) -> dict:
    """Time the full-recompute oracle on the same (scaled-down) scenario."""
    from repro_torch.core.topology import faasnet_plan
    from repro_torch.sim.engine import SimConfig
    from repro_torch.sim.reference import ReferenceFlowSim
    from repro_torch.sim.scale import _function_ids, apply_churn, build_manager

    w = cfg.wave
    mgr, members = build_manager(cfg)
    apply_churn(mgr, members, cfg)
    sim = ReferenceFlowSim(
        SimConfig(
            registry_out_cap=w.registry_out_cap,
            registry_qps=w.registry_qps,
            per_stream_cap=w.per_stream_cap,
            hop_latency=w.hop_latency,
        )
    )
    control = w.rpc.control_plane_total()
    for i, fid in enumerate(_function_ids(cfg)):
        plan = faasnet_plan(
            mgr.trees[fid],
            image_bytes=w.image_bytes,
            startup_fraction=w.startup_fraction,
            manifest_latency=w.rpc.manifest_fetch,
            piece=fid,
        )
        sim.add_plan(plan, t0=control + i * cfg.stagger_s)
    t0 = time.perf_counter()
    sim.run()
    return {"wall_s": time.perf_counter() - t0, "makespan_s": sim.now}


def _run_vector_twin(cfg, base, run_scale) -> dict:
    """Re-run a tier with ``engine="vector_torch"`` and record the comparison."""
    import dataclasses

    vcfg = dataclasses.replace(
        cfg, wave=dataclasses.replace(cfg.wave, engine="vector_torch")
    )
    t0 = time.perf_counter()
    vres = run_scale(vcfg)
    d = _result_dict(vcfg, vres)
    d["total_wall_s"] = time.perf_counter() - t0
    d["matches_incremental"] = (
        vres.makespan == base.makespan
        and vres.peak_registry_egress == base.peak_registry_egress
    )
    d["speedup_vs_incremental"] = (
        base.wall_s / vres.wall_s if vres.wall_s > 0 else float("inf")
    )
    return d


def main(argv: list[str] | None = None) -> None:
    from repro_torch.launch.device import describe, k1_launches, require
    from repro_torch.sim import ScaleConfig, WaveConfig, run_scale

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--vms", type=int, default=1000)
    ap.add_argument("--functions", type=int, default=5)
    ap.add_argument("--containers-per-function", type=int, default=500)
    ap.add_argument("--churn", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true", help="100 VMs / 250 containers")
    ap.add_argument("--compare-reference", action="store_true")
    ap.add_argument(
        "--mega",
        action="store_true",
        help="also run the 10k-VM / 25-function / 100k-container mega-burst",
    )
    ap.add_argument(
        "--giga",
        action="store_true",
        help="also run the 100k-VM / 1M-container burst train (vector_torch)",
    )
    ap.add_argument(
        "--profile",
        action="store_true",
        help="wrap the main run in cProfile and print the top-15 hotspots "
        "plus the _fold_events/_compact_done_heap queue microbenchmark",
    )
    ap.add_argument(
        "--min-giga-evs",
        type=float,
        default=60_000.0,
        help="events/s floor asserted on the --giga burst",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="BENCH_torch_scale.json")
    args = ap.parse_args(argv)
    require(args.device)

    if args.quick:
        args.vms, args.containers_per_function, args.churn = 100, 50, 10

    def incremental() -> WaveConfig:
        return WaveConfig(engine="incremental", device=args.device)

    launches: dict[str, int] = {}
    cfg = ScaleConfig(
        n_vms=args.vms,
        n_functions=args.functions,
        containers_per_function=args.containers_per_function,
        churn_ops=args.churn,
        seed=args.seed,
        wave=incremental(),
    )
    profiler = None
    if args.profile:
        import cProfile

        profiler = cProfile.Profile()
        profiler.enable()
    t0 = time.perf_counter()
    with k1_launches(launches, "main"):
        res = run_scale(cfg)
    total_wall = time.perf_counter() - t0
    if profiler is not None:
        import pstats

        profiler.disable()
        pstats.Stats(profiler).sort_stats("cumulative").print_stats(15)
        qm = _queue_micro()
        out_queue_micro = qm
        print(
            f"queue micro: _fold_events merges {qm['n_events']:,} events in "
            f"{qm['fold_events_s'] * 1e3:.1f} ms, _compact_done_heap rebuilds "
            f"{qm['done_heap_entries']:,} entries in "
            f"{qm['compact_done_heap_s'] * 1e3:.1f} ms"
        )
    else:
        out_queue_micro = None
    out = _result_dict(cfg, res)
    out["total_wall_s"] = total_wall
    if out_queue_micro is not None:
        out["queue_micro"] = out_queue_micro
    out["paper_reference_s"] = 8.3  # §4.2: 2500 containers / 1000 VMs
    with k1_launches(launches, "vector"):
        out["vector"] = _run_vector_twin(cfg, res, run_scale)

    micro = _control_plane_micro()
    out["control_plane_micro"] = micro
    out["ft_build_s"] = micro["ft_build_s"]  # 10k-node FT via bulk_insert

    if args.mega:
        from repro_torch.sim.scale import mega_burst_config

        mcfg = mega_burst_config(seed=args.seed)
        mcfg.wave = incremental()
        t0 = time.perf_counter()
        with k1_launches(launches, "mega_burst"):
            mres = run_scale(mcfg)
        mwall = time.perf_counter() - t0
        mega = _result_dict(mcfg, mres)
        mega["total_wall_s"] = mwall
        with k1_launches(launches, "mega_burst.vector"):
            mega["vector"] = _run_vector_twin(mcfg, mres, run_scale)
        out["mega_burst"] = mega

    if args.giga:
        from repro_torch.sim.multi_tenant import run_multi_tenant
        from repro_torch.sim.scale import giga_burst_config, giga_replay_config

        gcfg = giga_burst_config(seed=args.seed)
        gcfg.wave.device = args.device
        t0 = time.perf_counter()
        with k1_launches(launches, "giga_burst"):
            gres = run_scale(gcfg)
        gwall = time.perf_counter() - t0
        giga = _result_dict(gcfg, gres)
        giga["total_wall_s"] = gwall
        giga["floor_events_per_s"] = args.min_giga_evs
        mega_inc = out.get("mega_burst")
        if mega_inc:
            giga["speedup_vs_mega_incremental"] = (
                gres.events_per_s / mega_inc["events_per_s"]
            )
        out["giga_burst"] = giga

        # Full trace replay at the same fleet size: serving + block-level
        # provisioning + failover on one shared vector_torch engine.
        rcfg = giga_replay_config(seed=args.seed)
        rcfg.wave.device = args.device
        t0 = time.perf_counter()
        with k1_launches(launches, "giga_replay"):
            rres = run_multi_tenant(rcfg)
        rwall = time.perf_counter() - t0
        out["giga_replay"] = {
            "n_tenants": len(rcfg.tenants),
            "vm_pool_size": rcfg.vm_pool_size,
            "duration_s": rcfg.duration_s(),
            "engine": rcfg.wave.engine,
            "serving": rcfg.serving is not None,
            "blocks": rcfg.images is not None,
            "total_wall_s": rwall,
            "requests": sum(t.requests for t in rres.per_tenant.values()),
            "completed": sum(t.completed for t in rres.per_tenant.values()),
            "cold_starts": rres.cold_starts,
            "failovers": rres.failovers,
            "prov_makespan_s": rres.prov_makespan_s,
            "vm_hours": rres.vm_hours(),
            "peak_nic_utilization": rres.peak_nic_utilization,
            "worst_p99_response_s": max(
                t.p99_response_s for t in rres.per_tenant.values()
            ),
            "peak_registry_egress_gbps": rres.peak_registry_egress * 8 / 1e9,
        }

    if args.compare_reference:
        ref_cfg = ScaleConfig(
            n_vms=min(args.vms, 100),
            n_functions=args.functions,
            containers_per_function=min(args.containers_per_function, 50),
            churn_ops=0,
            seed=args.seed,
            wave=incremental(),
        )
        inc = run_scale(ref_cfg)
        ref = _time_reference(ref_cfg)
        out["reference_compare"] = {
            "n_vms": ref_cfg.n_vms,
            "n_containers": ref_cfg.total_containers(),
            "incremental_wall_s": inc.wall_s,
            "reference_wall_s": ref["wall_s"],
            "speedup": ref["wall_s"] / inc.wall_s if inc.wall_s > 0 else float("inf"),
            "makespan_delta_s": abs(inc.makespan - ref["makespan_s"]),
        }

    out["device"] = describe(args.device, launches)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2, sort_keys=True)
        f.write("\n")
    print(
        f"{res.n_containers} containers / {cfg.n_vms} VMs: "
        f"fetch makespan {res.makespan:.2f} s, provisioned {res.provision_makespan:.2f} s "
        f"(paper: 8.3 s), {res.events} events in {res.wall_s:.3f} s "
        f"({res.events_per_s:,.0f} ev/s), peak registry egress "
        f"{res.peak_registry_egress * 8 / 1e9:.2f} Gbps -> {args.out}"
    )
    v = out["vector"]
    print(
        f"vector_torch engine ({args.device}): {v['events_per_s']:,.0f} ev/s "
        f"({v['speedup_vs_incremental']:.1f}x incremental, "
        f"match={v['matches_incremental']}, K1 launches {launches['vector']})"
    )
    print(
        f"control plane: 10k-node FT build {micro['ft_build_s']*1e3:.1f} ms, "
        f"churn op {micro['churn_op_latency_s']*1e6:.1f} us, "
        f"pick_vm_for {micro['pick_vm_latency_s']*1e6:.1f} us"
    )
    if args.mega:
        m = out["mega_burst"]
        print(
            f"mega burst: {m['n_containers']} containers / {m['n_vms']} VMs "
            f"in {m['total_wall_s']:.1f} s wall (build {m['control_plane_build_s']:.2f} s, "
            f"engine {m['wall_s']:.2f} s), fetch makespan {m['fetch_makespan_s']:.2f} s; "
            f"vector_torch {m['vector']['events_per_s']:,.0f} ev/s "
            f"(match={m['vector']['matches_incremental']})"
        )
    if args.giga:
        g = out["giga_burst"]
        extra = (
            f", {g['speedup_vs_mega_incremental']:.1f}x the mega-tier "
            f"incremental events/s"
            if "speedup_vs_mega_incremental" in g
            else ""
        )
        print(
            f"giga burst: {g['n_containers']} containers / {g['n_vms']} VMs "
            f"in {g['total_wall_s']:.1f} s wall (engine {g['wall_s']:.2f} s, "
            f"{g['events_per_s']:,.0f} ev/s{extra})"
        )
        r = out["giga_replay"]
        print(
            f"giga replay: {r['n_tenants']} tenants / {r['vm_pool_size']} VM "
            f"pool / {r['duration_s']} s trace (serving+blocks) in "
            f"{r['total_wall_s']:.1f} s wall: {r['requests']:,} requests, "
            f"{r['cold_starts']} cold starts, {r['failovers']} failover(s), "
            f"worst p99 {r['worst_p99_response_s']:.2f} s"
        )
        if g["events_per_s"] < args.min_giga_evs:
            raise SystemExit(
                f"giga burst regression: {g['events_per_s']:,.0f} ev/s is "
                f"below the {args.min_giga_evs:,.0f} ev/s floor"
            )


if __name__ == "__main__":
    main()
