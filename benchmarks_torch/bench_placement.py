"""Shared-pool placement on the port (paper §3.1 + §5).

The port's counterpart of ``benchmarks/bench_placement.py``.  Replays
``multi_tenant_config()`` (8 mixed-trace tenants, one 2000-VM pool) under
four scheduler configurations and writes ``BENCH_torch_placement.json``:

  * **exclusive** — the legacy leasing: every instance takes a whole VM;
  * **shared** — memory-aware cross-tenant placement through
    ``FTManager.pick_vm_for`` with the §5 FT-aware refinement;
  * **shared_binpack** — same shared pool, pure binpack placement
    (fullest-VM-first), the §5 comparison baseline;
  * **shared_histogram** — shared + the predictive keep-alive-histogram
    reclaim policy (vs the fixed idle-TTL the other rows use).

Reported per row: VM-hours (∫ pool-out-of-free dt), cold-start count,
per-tenant p99 provisioning latency, peak per-VM NIC utilization and peak
registry egress; under ``device``, the card, torch and K1's launches of each
row.  Every replay runs the port's default engine, ``vector_torch``, on
``--device`` (its wide fronts through the cap-chain kernel on the card).
Two claims are asserted in-bench:

  1. the shared pool spends fewer VM-hours than exclusive leasing;
  2. FT-aware placement matches or beats binpack on the worst tenant's
     p99 provisioning latency (the §5 refinement, measured on a shared
     pool under the trace mix).

Usage::

    PYTHONPATH=src python benchmarks_torch/bench_placement.py            # 8 x 2000, on the card
    PYTHONPATH=src python benchmarks_torch/bench_placement.py --quick --device cpu
    PYTHONPATH=src python benchmarks_torch/bench_placement.py --skip-checks
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time


def _run(args, **kw):
    from repro_torch.sim import MultiTenantReplay, multi_tenant_config

    cfg = multi_tenant_config(
        args.seed,
        n_tenants=args.tenants,
        vm_pool_size=args.pool,
        minutes=args.minutes,
        scale=args.scale,
        failover_at=args.failover_at,
        check_partition=not args.skip_checks,
        **kw,
    )
    cfg.wave.device = args.device
    t0 = time.perf_counter()
    res = MultiTenantReplay(cfg).run()
    return res, time.perf_counter() - t0


def _row(res, wall: float) -> dict:
    return {
        "wall_s": wall,
        "vm_hours": res.vm_hours(),
        "cold_starts": res.cold_starts,
        "prov_makespan_s": res.prov_makespan_s,
        "total_prov_time_s": res.total_prov_time_s,
        "peak_nic_utilization": res.peak_nic_utilization,
        "peak_registry_egress_gbps": res.peak_registry_egress * 8 / 1e9,
        "manager_stats": dict(res.manager_stats),
        "per_tenant_p99_prov_s": {
            fid: tr.p99_prov_s for fid, tr in sorted(res.per_tenant.items())
        },
        "worst_p99_prov_s": max(tr.p99_prov_s for tr in res.per_tenant.values()),
        "per_tenant": {
            fid: dataclasses.asdict(tr) for fid, tr in sorted(res.per_tenant.items())
        },
    }


def main(argv: list[str] | None = None) -> None:
    from repro_torch.launch.device import describe, k1_launches, require

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--pool", type=int, default=2000)
    ap.add_argument("--minutes", type=int, default=25)
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--failover-at", type=int, default=12 * 60)
    ap.add_argument("--quick", action="store_true", help="3 tenants / 300 VMs / 8 min")
    ap.add_argument(
        "--skip-checks",
        action="store_true",
        help="skip the per-tick shared-pool invariant checks and assertions",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="BENCH_torch_placement.json")
    args = ap.parse_args(argv)
    require(args.device)
    if args.quick:
        args.tenants, args.pool, args.minutes = 3, 300, 8
        args.failover_at = min(args.failover_at, 4 * 60)

    launches: dict[str, int] = {}
    rows: dict[str, dict] = {}
    with k1_launches(launches, "exclusive"):
        excl, wall = _run(args, placement="exclusive")
    rows["exclusive"] = _row(excl, wall)
    with k1_launches(launches, "shared"):
        shared, wall = _run(args, placement="shared")
    rows["shared"] = _row(shared, wall)
    with k1_launches(launches, "shared_binpack"):
        binpack, wall = _run(args, placement="shared", ft_aware_placement=False)
    rows["shared_binpack"] = _row(binpack, wall)
    with k1_launches(launches, "shared_histogram"):
        hist, wall = _run(args, placement="shared", reclaim="histogram")
    rows["shared_histogram"] = _row(hist, wall)

    vm_hours_saved_pct = (
        (1.0 - shared.vm_seconds / excl.vm_seconds) * 100.0
        if excl.vm_seconds > 0
        else float("nan")
    )
    out = {
        "n_tenants": args.tenants,
        "vm_pool_size": args.pool,
        "minutes": args.minutes,
        "trace_scale": args.scale,
        "seed": args.seed,
        "failover_at_s": args.failover_at,
        "rows": rows,
        "shared_vs_exclusive_vm_hours_saved_pct": vm_hours_saved_pct,
        "ft_aware_vs_binpack_worst_p99_prov": {
            "ft_aware_s": rows["shared"]["worst_p99_prov_s"],
            "binpack_s": rows["shared_binpack"]["worst_p99_prov_s"],
        },
        "histogram_vs_fixed_reclaim": {
            "vm_hours_fixed": rows["shared"]["vm_hours"],
            "vm_hours_histogram": rows["shared_histogram"]["vm_hours"],
            "cold_starts_fixed": rows["shared"]["cold_starts"],
            "cold_starts_histogram": rows["shared_histogram"]["cold_starts"],
        },
    }

    if not args.skip_checks:
        assert shared.vm_seconds < excl.vm_seconds, (
            f"shared pool did NOT save VM-hours: shared={shared.vm_hours():.1f} "
            f"vs exclusive={excl.vm_hours():.1f}"
        )
        assert (
            rows["shared"]["worst_p99_prov_s"]
            <= rows["shared_binpack"]["worst_p99_prov_s"]
        ), (
            f"FT-aware placement lost to binpack on worst-tenant p99 "
            f"provisioning: {rows['shared']['worst_p99_prov_s']:.2f}s vs "
            f"{rows['shared_binpack']['worst_p99_prov_s']:.2f}s"
        )
        out["checks_passed"] = True

    out["device"] = describe(args.device, launches)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2, sort_keys=True)
        f.write("\n")

    print(
        f"{args.tenants} tenants / {args.pool} VMs / {args.minutes} min "
        f"({'quick' if args.quick else 'full'}):"
    )
    hdr = (
        f"{'row':18s} {'vm_hours':>9s} {'cold':>6s} {'worst_p99prov':>13s} "
        f"{'peak_nic':>8s} {'peak_reg':>8s} {'K1':>6s}"
    )
    print(hdr)
    for name, r in rows.items():
        print(
            f"{name:18s} {r['vm_hours']:9.1f} {r['cold_starts']:6d} "
            f"{r['worst_p99_prov_s']:12.2f}s {r['peak_nic_utilization']:8.2f} "
            f"{r['peak_registry_egress_gbps']:6.2f}Gb {launches[name]:6d}"
        )
    print(
        f"shared saves {vm_hours_saved_pct:.1f}% VM-hours vs exclusive; "
        f"FT-aware worst p99 prov {rows['shared']['worst_p99_prov_s']:.2f}s "
        f"vs binpack {rows['shared_binpack']['worst_p99_prov_s']:.2f}s; "
        f"histogram reclaim {rows['shared_histogram']['vm_hours']:.1f} VM-h "
        f"vs fixed {rows['shared']['vm_hours']:.1f} VM-h -> {args.out}"
    )


if __name__ == "__main__":
    main()
