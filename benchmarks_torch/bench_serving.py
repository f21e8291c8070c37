"""Request-level serving on the port (sub-tick dispatch + cold-start herd control).

The port's counterpart of ``benchmarks/bench_serving.py``.  Two scenarios,
one artifact (``BENCH_torch_serving.json``):

  * **mix** — the 8-tenant production mix (``repro_torch.sim.scale.serving_config``)
    replayed through the request-level serving layer: per-tenant p50/p99
    response latency, pooled platform percentiles, and the faasnet-vs-baseline
    platform p99 (full-image pulls stretch every cold request under baseline).
  * **cold_burst** — a 10k-request scale-from-zero burst (whole-VM memory
    footprint) landing next to a diurnal background tenant whose daily ramp
    starts right after the burst.  Herd control admits ONE provisioning wave
    sized to sustainable throughput; the naive per-tick deficit rule grabs
    the entire free pool, starving the background tenant's ramp.

Every replay runs the port's default engine, ``vector_torch``, on
``--device`` (its wide fronts through the cap-chain kernel on the card);
the artifact adds a ``device`` block with K1's launches of each replay.

Asserted IN-BENCH (not just reported): with herd control on, the platform
provisions strictly fewer instances, wastes fewer (an instance is "wasted"
when its lifetime service time never repays its provisioning latency), and
holds equal-or-better platform p99 (worst tenant) than the naive rule.

Usage::

    PYTHONPATH=src python benchmarks_torch/bench_serving.py           # on the card
    PYTHONPATH=src python benchmarks_torch/bench_serving.py --quick --device cpu
    PYTHONPATH=src python benchmarks_torch/bench_serving.py --skip-asserts
"""
from __future__ import annotations

import argparse
import json
import time


def _pctl(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1, int(q * len(sorted_vals)))]


def _tenant_row(tr) -> dict:
    return {
        "requests": tr.requests,
        "completed": tr.completed,
        "p50_response_s": tr.p50_response_s,
        "p99_response_s": tr.p99_response_s,
        "peak_vms": tr.peak_vms,
        "provisioned": tr.provisioned,
        "wasted_provisions": tr.wasted_provisions,
    }


def _platform_row(res, replay) -> dict:
    lats = sorted(
        lat for ts in replay.tenants for (_, lat) in ts.responses
    )
    return {
        "per_tenant": {
            fid: _tenant_row(tr) for fid, tr in sorted(res.per_tenant.items())
        },
        "total_provisioned": sum(tr.provisioned for tr in res.per_tenant.values()),
        "total_wasted": sum(tr.wasted_provisions for tr in res.per_tenant.values()),
        # worst tenant tail: the starvation-sensitive platform SLO
        "platform_p99_s": max(tr.p99_response_s for tr in res.per_tenant.values()),
        # pooled request population (what a platform-wide dashboard shows)
        "pooled_p50_s": _pctl(lats, 0.50),
        "pooled_p99_s": _pctl(lats, 0.99),
        "waves": res.manager_stats.get("waves", 0),
        "vm_hours": res.vm_hours(),
    }


# ----------------------------------------------------------------------
# Scenario 1: the 8-tenant production mix under request-level serving
# ----------------------------------------------------------------------
def run_mix(args, launches: dict) -> dict:
    from repro_torch.launch.device import k1_launches
    from repro_torch.sim import MultiTenantReplay, serving_config

    out: dict = {"minutes": args.minutes, "seed": args.seed}
    for system in ("faasnet", "baseline"):
        cfg = serving_config(
            args.seed,
            minutes=args.minutes,
            system=system,
            failover_at=None,
            check_partition=not args.skip_asserts,
        )
        cfg.wave.device = args.device
        t0 = time.perf_counter()
        with k1_launches(launches, f"mix.{system}"):
            replay = MultiTenantReplay(cfg)
            res = replay.run()
        row = _platform_row(res, replay)
        row["wall_s"] = time.perf_counter() - t0
        out[system] = row
    out["n_tenants"] = len(out["faasnet"]["per_tenant"])
    return out


# ----------------------------------------------------------------------
# Scenario 2: scale-from-zero cold burst, herd control vs naive deficit rule
# ----------------------------------------------------------------------
def _cold_burst_cfg(herd: bool, *, burst: int, pool: int, dur_s: int, check: bool,
                    device: str):
    from repro_torch.sim import WaveConfig
    from repro_torch.sim.multi_tenant import (
        MultiTenantConfig,
        ServingConfig,
        TenantConfig,
    )
    from repro_torch.sim.traces import diurnal_trace

    # Background sits at its 50-RPS night until t=40, then ramps to a
    # 400-RPS peak at t=70 — i.e. AFTER the burst tenant's t=20 pool grab.
    bg = diurnal_trace(
        duration_s=dur_s, base_rps=50.0, peak_rps=400.0, period_s=120, phase_s=80
    )
    burst_trace = [0.0] * 20 + [float(burst)] + [0.0] * (dur_s - 21)
    return MultiTenantConfig(
        tenants=[
            TenantConfig("background", bg, seed=1),
            # Whole-VM memory footprint: the cold tenant cannot co-locate,
            # so every instance it grabs is a VM the background loses.
            TenantConfig(
                "coldstart",
                burst_trace,
                seed=3,
                mem_mb=4096,
                function_duration_s=1.0,
                max_reserve_per_tick=100_000,
            ),
        ],
        vm_pool_size=pool,
        serving=ServingConfig(herd_control=herd),
        check_partition=check,
        wave=WaveConfig(device=device),
    )


def run_cold_burst(args, launches: dict) -> dict:
    from repro_torch.launch.device import k1_launches
    from repro_torch.sim import MultiTenantReplay

    out: dict = {
        "burst_requests": args.burst,
        "vm_pool_size": args.pool,
        "duration_s": args.dur,
    }
    for herd in (True, False):
        name = "herd" if herd else "naive"
        cfg = _cold_burst_cfg(
            herd,
            burst=args.burst,
            pool=args.pool,
            dur_s=args.dur,
            check=not args.skip_asserts,
            device=args.device,
        )
        t0 = time.perf_counter()
        with k1_launches(launches, f"cold_burst.{name}"):
            replay = MultiTenantReplay(cfg)
            res = replay.run()
        row = _platform_row(res, replay)
        row["wall_s"] = time.perf_counter() - t0
        out[name] = row
    h, n = out["herd"], out["naive"]
    out["herd_fewer_provisions"] = h["total_provisioned"] < n["total_provisioned"]
    out["herd_p99_not_worse"] = h["platform_p99_s"] <= n["platform_p99_s"]
    out["herd_fewer_wasted"] = h["total_wasted"] < n["total_wasted"]
    if not args.skip_asserts:
        assert out["herd_fewer_provisions"], (
            f"herd provisioned {h['total_provisioned']} >= "
            f"naive {n['total_provisioned']}"
        )
        assert out["herd_p99_not_worse"], (
            f"herd platform p99 {h['platform_p99_s']:.2f} s worse than "
            f"naive {n['platform_p99_s']:.2f} s"
        )
        assert out["herd_fewer_wasted"], (
            f"herd wasted {h['total_wasted']} >= naive {n['total_wasted']}"
        )
    return out


def main(argv: list[str] | None = None) -> None:
    from repro_torch.launch.device import describe, require

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--minutes", type=int, default=8, help="mix replay length")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--burst", type=int, default=10_000)
    ap.add_argument("--pool", type=int, default=3000)
    ap.add_argument("--dur", type=int, default=180, help="cold-burst replay length (s)")
    ap.add_argument("--quick", action="store_true", help="smaller burst + shorter mix")
    ap.add_argument(
        "--skip-asserts",
        action="store_true",
        help="skip per-tick partition checks and the herd-vs-naive assertions",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="BENCH_torch_serving.json")
    args = ap.parse_args(argv)
    require(args.device)
    if args.quick:
        args.minutes, args.burst, args.pool, args.dur = 4, 4000, 1500, 150

    launches: dict[str, int] = {}
    mix = run_mix(args, launches)
    cold = run_cold_burst(args, launches)
    out = {"mix": mix, "cold_burst": cold, "device": describe(args.device, launches)}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2, sort_keys=True)
        f.write("\n")

    fa, ba = mix["faasnet"], mix["baseline"]
    print(
        f"mix: {mix['n_tenants']} tenants x {mix['minutes']} min: faasnet "
        f"pooled p50/p99 {fa['pooled_p50_s']:.2f}/{fa['pooled_p99_s']:.2f} s, "
        f"platform p99 {fa['platform_p99_s']:.2f} s "
        f"(baseline {ba['platform_p99_s']:.2f} s) -> {args.out}"
    )
    h, n = cold["herd"], cold["naive"]
    print(
        f"cold burst {cold['burst_requests']} reqs / {cold['vm_pool_size']} VMs: "
        f"herd prov {h['total_provisioned']} wasted {h['total_wasted']} "
        f"plat p99 {h['platform_p99_s']:.2f} s  vs  naive prov "
        f"{n['total_provisioned']} wasted {n['total_wasted']} plat p99 "
        f"{n['platform_p99_s']:.2f} s"
    )
    for fid in sorted(h["per_tenant"]):
        ht, nt = h["per_tenant"][fid], n["per_tenant"][fid]
        print(
            f"  {fid:12s} herd done {ht['completed']:6d}/{ht['requests']:6d} "
            f"p99 {ht['p99_response_s']:7.2f}s | naive done "
            f"{nt['completed']:6d}/{nt['requests']:6d} p99 {nt['p99_response_s']:7.2f}s"
        )
    print(f"K1 launches {launches}")


if __name__ == "__main__":
    main()
