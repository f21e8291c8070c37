"""Replay the paper's production traces against three systems (§4.2), on the
PyTorch + CUDA port.

The replay's flow engine defaults to ``vector_torch`` on ``cuda``: every wide
recompute front of the shared flow simulation goes through the CUDA
cap-chain kernel.  On a machine without a GPU, pass ``--device cpu`` (the
kernel's plain PyTorch version) or ``--engine vector`` (numpy); asking for
``cuda`` where CUDA is absent raises.  Results are identical on every engine
and device, and to the JAX package's ``examples/trace_replay.py``.

Single tenant (IoT trace, the paper's Figure 11 shape)::

    PYTHONPATH=src python examples/torch_trace_replay.py [--minutes 35]

Multi-tenant (overlapping IoT/gaming/diurnal/constant waves on one shared
registry + VM pool, with a mid-wave scheduler failover)::

    PYTHONPATH=src python examples/torch_trace_replay.py --multi [--tenants 8]

Either mode accepts a sharded registry — e.g. 4 replicas with round-robin
fetchers (each shard keeps the full per-replica egress/QPS, so shards add
capacity)::

    PYTHONPATH=src python examples/torch_trace_replay.py \
        --registry-shards 4 --shard-policy replicated

Multi-tenant mode shares the VM pool across tenants by default (memory-aware
co-location, paper §3.1); compare against the legacy exclusive leasing or
the predictive reclaim policy with::

    PYTHONPATH=src python examples/torch_trace_replay.py --multi \
        --placement exclusive
    PYTHONPATH=src python examples/torch_trace_replay.py --multi \
        --reclaim histogram

Request-level serving (sub-tick dispatch, per-VM CPU slots, cold-start herd
control) reports end-to-end p50/p99 response instead of tick-quantized
latencies::

    PYTHONPATH=src python examples/torch_trace_replay.py --multi --serving
"""
import argparse
import sys

sys.path.insert(0, "src")

import statistics as st

from repro_torch.core.registry import PLACEMENT_POLICIES
from repro_torch.sim import (
    PLACEMENTS,
    RECLAIM_POLICIES,
    ENGINES,
    RegistrySpec,
    ReplayConfig,
    TraceReplay,
    WaveConfig,
    iot_trace,
)


def _registry_spec(args, base) -> "RegistrySpec | None":
    """None for the stock 1-shard registry (bit-identical legacy path).

    ``base`` is the mode's own config (ReplayConfig / MultiTenantConfig):
    each shard keeps that config's full per-replica egress cap and QPS.
    """
    if args.registry_shards == 1 and args.shard_policy == "hash_by_function":
        return None
    return RegistrySpec(
        shards=args.registry_shards,
        egress_cap=base.registry_out_cap,
        qps=base.registry_qps,
        policy=args.shard_policy,
    )


def single_tenant(args) -> None:
    trace = iot_trace(scale=args.scale)[: args.minutes * 60]
    burst_t = 9 * 60
    spec = _registry_spec(args, ReplayConfig())
    print(f"IoT trace: {args.minutes} min at {args.scale:.2f} scale "
          f"(peak {max(trace):.0f} RPS)")
    if spec is not None:
        print(f"registry: {spec.shards} shard(s), policy={spec.policy}")
    print(f"{'system':12s} {'peak resp':>10s} {'recovery':>9s} "
          f"{'prov mean':>10s} {'VMs used':>9s}")
    for system in ("faasnet", "on_demand", "baseline"):
        r = TraceReplay(
            ReplayConfig(system=system, idle_reclaim_s=420, registry=spec,
                         wave=WaveConfig(engine=args.engine, device=args.device))
        )
        tl = r.run(trace)
        peak = max(ts.mean_response_s for ts in tl if ts.t >= burst_t)
        rec = r.recovery_time(burst_t + 60, normal_s=3.5)
        pm = st.mean(r.prov_latencies) if r.prov_latencies else 0.0
        vms = max(ts.active_vms for ts in tl)
        print(f"{system:12s} {peak:9.1f}s {rec:8.0f}s {pm:9.1f}s {vms:9d}")
    print("paper:       faasnet 6s / 28s recovery; baseline 28s / 113s")


def multi_tenant(args) -> None:
    from repro_torch.sim import (
        MultiTenantConfig,
        MultiTenantReplay,
        multi_tenant_config,
        serving_config,
    )

    spec = _registry_spec(args, MultiTenantConfig())
    factory = serving_config if args.serving else multi_tenant_config
    results = {}
    for system in ("faasnet", "baseline"):
        cfg = factory(
            args.seed,
            n_tenants=args.tenants,
            vm_pool_size=args.pool,
            minutes=args.minutes,
            scale=args.multi_scale,
            system=system,
            failover_at=args.minutes * 30,  # mid-run scheduler failover
            registry=spec,
            placement=args.placement,
            reclaim=args.reclaim,
        )
        cfg.wave.engine, cfg.wave.device = args.engine, args.device
        results[system] = MultiTenantReplay(cfg).run()
    res = results["faasnet"]
    shards = spec.shards if spec is not None else 1
    print(f"{args.tenants} tenants sharing {args.pool} VMs + a "
          f"{shards}-shard registry ({args.placement} placement, "
          f"{args.reclaim} reclaim), "
          f"{args.minutes} min, scheduler failover at t={args.minutes * 30}s "
          f"(failovers={res.failovers})")
    if args.serving:
        print(f"{'tenant':12s} {'requests':>8s} {'p50 resp':>9s} "
              f"{'p99 resp':>9s} {'wasted':>7s} {'peak VMs':>8s}")
        for fid, tr in sorted(res.per_tenant.items()):
            print(f"{fid:12s} {tr.requests:8d} {tr.p50_response_s:8.2f}s "
                  f"{tr.p99_response_s:8.2f}s {tr.wasted_provisions:7d} "
                  f"{tr.peak_vms:8d}")
    else:
        print(f"{'tenant':12s} {'requests':>8s} {'p99 resp':>9s} "
              f"{'p99 prov':>9s} {'peak VMs':>8s}")
        for fid, tr in sorted(res.per_tenant.items()):
            print(f"{fid:12s} {tr.requests:8d} {tr.p99_response_s:8.1f}s "
                  f"{tr.p99_prov_s:8.1f}s {tr.peak_vms:8d}")
    base_prov = results["baseline"].total_prov_time_s
    ratio = res.total_prov_time_s / base_prov if base_prov > 0 else float("nan")
    print(f"total provisioning time: faasnet {res.total_prov_time_s:.0f}s vs "
          f"baseline {base_prov:.0f}s "
          f"-> {(1 - ratio) * 100:.1f}% less (paper: 75.2%)")
    print(f"pool footprint: {res.vm_hours():.1f} VM-hours, "
          f"{res.cold_starts} cold starts, peak NIC utilization "
          f"{res.peak_nic_utilization:.2f}")


def main() -> None:
    ap = argparse.ArgumentParser(
        description="Trace replay on the PyTorch + CUDA port.  On a machine "
                    "without a GPU run it with --device cpu, e.g. "
                    "PYTHONPATH=src python examples/torch_trace_replay.py "
                    "--device cpu --minutes 12")
    ap.add_argument("--minutes", type=int, default=35)
    ap.add_argument("--scale", type=float, default=1 / 3)
    ap.add_argument("--multi", action="store_true",
                    help="overlapping multi-tenant waves instead of one tenant")
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--pool", type=int, default=2000)
    ap.add_argument("--multi-scale", type=float, default=0.25,
                    help="trace scale for --multi (the IoT tenant's factor)")
    ap.add_argument("--registry-shards", type=int, default=1,
                    help="registry shard/replica count (each shard keeps the "
                         "full per-replica egress cap and QPS)")
    ap.add_argument("--shard-policy", default="hash_by_function",
                    choices=PLACEMENT_POLICIES,
                    help="blob placement across shards")
    ap.add_argument("--placement", default="shared",
                    choices=PLACEMENTS,
                    help="--multi: shared = memory-aware co-location "
                         "(default); exclusive = legacy per-tenant leasing")
    ap.add_argument("--reclaim", default="fixed",
                    choices=RECLAIM_POLICIES,
                    help="--multi: idle-instance reclaim policy")
    ap.add_argument("--serving", action="store_true",
                    help="--multi: request-level serving (sub-tick dispatch, "
                         "per-VM CPU slots, herd-controlled admission); "
                         "reports end-to-end p50/p99 response per tenant")
    ap.add_argument("--seed", type=int, default=0)
    # the reference oracle keeps no NIC telemetry and cannot drive a replay
    ap.add_argument("--engine", default="vector_torch",
                    choices=[e for e in ENGINES if e != "reference"],
                    help="flow engine (default vector_torch: wide fronts "
                         "through the cap-chain kernel on --device)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="vector_torch's device (default cuda; cpu runs the "
                         "kernel's plain PyTorch version, for machines "
                         "without a GPU)")
    args = ap.parse_args()
    if args.multi:
        multi_tenant(args)
    else:
        single_tenant(args)


if __name__ == "__main__":
    main()
