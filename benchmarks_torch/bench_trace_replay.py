"""Trace-driven multi-tenant replay on the port (paper §4.2, Figures 11-18).

The port's counterpart of ``benchmarks/bench_trace_replay.py``.  Replays N
overlapping tenant traces (IoT / synthetic gaming / diurnal / constant, via
``repro_torch.sim.scale.multi_tenant_config``) against ONE shared engine +
VM pool and writes ``BENCH_torch_trace.json`` with:

  * per-tenant request p99/mean response, provisioning latency p99/mean,
    provisioning makespan and peak VM footprint;
  * platform aggregates: whole-run provisioning makespan, total
    provisioning time, peak registry egress;
  * the faasnet-vs-baseline provisioning-time ratio (the paper reports
    75.2% less provisioning time, i.e. a ratio of ~0.248);
  * failover parity: the run (with its mid-wave FTManager
    snapshot/json/restore) re-executed without failover must produce a
    bit-identical TickStats stream;
  * two-run determinism of the failover run itself;
  * a ``device`` block: the card, torch, K1's launches of each replay.

Every replay runs the port's default engine, ``vector_torch``, on
``--device``: its wide fronts go through the cap-chain kernel (K1) on the
card.  Request-level serving is ON by default; ``--no-serving`` reverts to
the legacy tick-quantized dispatch loop.

Usage::

    PYTHONPATH=src python benchmarks_torch/bench_trace_replay.py           # 8 x 2000, on the card
    PYTHONPATH=src python benchmarks_torch/bench_trace_replay.py --quick --device cpu
    PYTHONPATH=src python benchmarks_torch/bench_trace_replay.py --no-serving
    PYTHONPATH=src python benchmarks_torch/bench_trace_replay.py --skip-checks
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time


def _run(args, *, system: str, failover_at):
    from repro_torch.sim import MultiTenantReplay, multi_tenant_config, serving_config

    factory = multi_tenant_config if args.no_serving else serving_config
    cfg = factory(
        args.seed,
        n_tenants=args.tenants,
        vm_pool_size=args.pool,
        minutes=args.minutes,
        scale=args.scale,
        system=system,
        failover_at=failover_at,
        check_partition=not args.skip_checks,
        placement=args.placement,
        reclaim=args.reclaim,
    )
    cfg.wave.device = args.device
    t0 = time.perf_counter()
    res = MultiTenantReplay(cfg).run()
    return res, time.perf_counter() - t0


def main(argv: list[str] | None = None) -> None:
    from repro_torch.launch.device import describe, k1_launches, require
    from repro_torch.sim import PLACEMENTS, RECLAIM_POLICIES

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--pool", type=int, default=2000)
    ap.add_argument("--minutes", type=int, default=25)
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--failover-at", type=int, default=12 * 60)
    ap.add_argument(
        "--placement",
        choices=PLACEMENTS,
        default="shared",
        help="shared = memory-aware cross-tenant pool (default); "
        "exclusive = legacy one-VM-one-tenant leasing",
    )
    ap.add_argument(
        "--reclaim",
        choices=RECLAIM_POLICIES,
        default="fixed",
        help="idle-instance reclaim policy",
    )
    ap.add_argument("--quick", action="store_true", help="3 tenants / 300 VMs / 8 min")
    ap.add_argument(
        "--no-serving",
        action="store_true",
        help="legacy tick-quantized dispatch (pre-serving response tails; "
        "p99 collapses to integer seconds)",
    )
    ap.add_argument(
        "--skip-checks",
        action="store_true",
        help="skip the parity/determinism re-runs and per-tick partition checks",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="BENCH_torch_trace.json")
    args = ap.parse_args(argv)
    require(args.device)
    if args.quick:
        args.tenants, args.pool, args.minutes = 3, 300, 8
        args.failover_at = min(args.failover_at, 4 * 60)

    launches: dict[str, int] = {}
    with k1_launches(launches, "faasnet"):
        res, wall = _run(args, system="faasnet", failover_at=args.failover_at)
    with k1_launches(launches, "baseline"):
        base, base_wall = _run(args, system="baseline", failover_at=args.failover_at)

    ratio = (
        res.total_prov_time_s / base.total_prov_time_s
        if base.total_prov_time_s > 0
        else float("nan")
    )
    out = {
        "n_tenants": args.tenants,
        "vm_pool_size": args.pool,
        "minutes": args.minutes,
        "trace_scale": args.scale,
        "seed": args.seed,
        "failover_at_s": args.failover_at,
        "placement": args.placement,
        "reclaim": args.reclaim,
        "serving": not args.no_serving,
        "vm_hours": res.vm_hours(),
        "peak_nic_utilization": res.peak_nic_utilization,
        "failovers": res.failovers,
        "wall_s": wall,
        "baseline_wall_s": base_wall,
        "per_tenant": {
            fid: dataclasses.asdict(tr) for fid, tr in sorted(res.per_tenant.items())
        },
        "prov_makespan_s": res.prov_makespan_s,
        "total_prov_time_s": res.total_prov_time_s,
        "peak_registry_egress_bytes_per_s": res.peak_registry_egress,
        "peak_registry_egress_gbps": res.peak_registry_egress * 8 / 1e9,
        "free_vms_at_end": res.free_vms,
        "manager_stats": res.manager_stats,
        "baseline_total_prov_time_s": base.total_prov_time_s,
        "baseline_prov_makespan_s": base.prov_makespan_s,
        "baseline_peak_registry_egress_gbps": base.peak_registry_egress * 8 / 1e9,
        "prov_time_ratio_vs_baseline": ratio,
        "prov_time_reduction_pct": (1.0 - ratio) * 100.0,
        "paper_reduction_pct": 75.2,  # §4.2: 75.2% less provisioning time
    }

    if not args.skip_checks:
        with k1_launches(launches, "uninterrupted"):
            uninterrupted, _ = _run(args, system="faasnet", failover_at=None)
        with k1_launches(launches, "rerun"):
            rerun, _ = _run(args, system="faasnet", failover_at=args.failover_at)
        out["failover_parity"] = res.timelines == uninterrupted.timelines
        out["two_run_deterministic"] = (
            res.timelines == rerun.timelines and res.per_tenant == rerun.per_tenant
        )
        assert out["failover_parity"], "failover run diverged from uninterrupted run"
        assert out["two_run_deterministic"], "replay is not two-run deterministic"

    out["device"] = describe(args.device, launches)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2, sort_keys=True)
        f.write("\n")
    print(
        f"{args.tenants} tenants / {args.pool} VMs / {args.minutes} min: "
        f"faasnet total prov {res.total_prov_time_s:.0f} s vs baseline "
        f"{base.total_prov_time_s:.0f} s -> ratio {ratio:.3f} "
        f"({(1-ratio)*100:.1f}% less; paper: 75.2%) -> {args.out}"
    )
    print(
        f"peak registry egress {res.peak_registry_egress*8/1e9:.2f} Gbps "
        f"(baseline {base.peak_registry_egress*8/1e9:.2f} Gbps), "
        f"failovers={res.failovers}"
        + (
            f", parity={out['failover_parity']}, "
            f"deterministic={out['two_run_deterministic']}"
            if not args.skip_checks
            else ""
        )
        + f"; K1 launches {launches}"
    )
    for fid, tr in sorted(res.per_tenant.items()):
        print(
            f"  {fid:12s} req={tr.requests:6d} p99resp={tr.p99_response_s:6.2f}s "
            f"p99prov={tr.p99_prov_s:6.2f}s makespan={tr.prov_makespan_s:7.1f}s "
            f"peak_vms={tr.peak_vms}"
        )


if __name__ == "__main__":
    main()
