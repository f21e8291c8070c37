"""Registry shard sweep on the port: the paper's bottleneck-removal claim.

The port's counterpart of ``benchmarks/bench_registry_sweep.py``.  Paper
§4.3's central claim is that FaaSNet makes provisioning latency
*insensitive* to registry bandwidth, while ``docker pull`` (baseline) and
on-demand fetch scale only as fast as the registry does.  This benchmark
sweeps the registry from 1 to 8 shards (replicas) for
{faasnet, baseline, on_demand} and writes ``BENCH_torch_registry.json``
showing both directions of the claim:

  * baseline / on_demand provisioning makespan improves ~monotonically as
    shards are added (their throughput is registry-bound);
  * faasnet's makespan moves < 5 % across the whole sweep (only the tree
    root ever touches the registry, and it is NIC-bound, not registry-bound).

Every wave runs the port's default engine, ``vector_torch``, on
``--device``: its wide fronts go through the cap-chain kernel (K1) on the
card.  The artifact carries the reference's keys plus a ``device`` block
(the card, torch, K1's launches of each system's sweep).

The sweep uses the ``replicated`` placement policy — every shard holds every
image and fetchers round-robin across replicas — which is exactly the
"add registry replicas" configuration the paper's claim is about
(``hash_by_function`` would pin one function's image to one shard and
measure blob *sharding*, not replica scaling).  ``per_stream_cap`` is lifted
for the sweep so the registry (not the 30 MB/s app-level stream cap) is the
binding resource for the registry-bound systems; VM NICs stay at 1 Gbps.

Usage::

    PYTHONPATH=src python benchmarks_torch/bench_registry_sweep.py     # 128 VMs, on the card
    PYTHONPATH=src python benchmarks_torch/bench_registry_sweep.py --device cpu
    PYTHONPATH=src python benchmarks_torch/bench_registry_sweep.py --no-check
"""
from __future__ import annotations

import argparse
import json
import statistics as st
import time

SHARD_COUNTS = (1, 2, 4, 8)
SYSTEMS = ("faasnet", "baseline", "on_demand")


def run_cell(system: str, shards: int, args) -> dict:
    from repro_torch.sim import GBPS, RegistrySpec, WaveConfig, provision_wave

    cfg = WaveConfig(
        per_stream_cap=float("inf"),
        registry=RegistrySpec(
            shards=shards,
            egress_cap=args.shard_gbps * GBPS,
            qps=args.shard_qps,
            policy=args.policy,
        ),
        device=args.device,
    )
    t0 = time.perf_counter()
    lat = sorted(provision_wave(system, args.vms, cfg).values())
    return {
        "makespan_s": lat[-1],
        "mean_s": st.mean(lat),
        "p50_s": lat[len(lat) // 2],
        "wall_s": time.perf_counter() - t0,
    }


def main(argv: list[str] | None = None) -> None:
    from repro_torch.launch.device import describe, k1_launches, require

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--vms", type=int, default=128)
    ap.add_argument("--shard-gbps", type=float, default=9.5,
                    help="per-shard egress in Gbit/s (paper §4.1 calibration)")
    ap.add_argument("--shard-qps", type=float, default=1100.0,
                    help="per-shard block-request throttle")
    ap.add_argument("--policy", default="replicated",
                    choices=("replicated", "least_loaded", "hash_by_function"))
    ap.add_argument("--no-check", action="store_true",
                    help="skip the bottleneck-removal assertions")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="BENCH_torch_registry.json")
    args = ap.parse_args(argv)
    require(args.device)

    launches: dict[str, int] = {}
    sweep: dict[str, dict[str, dict]] = {}
    for system in SYSTEMS:
        with k1_launches(launches, system):
            sweep[system] = {str(s): run_cell(system, s, args) for s in SHARD_COUNTS}

    def makespans(system: str) -> list[float]:
        return [sweep[system][str(s)]["makespan_s"] for s in SHARD_COUNTS]

    f = makespans("faasnet")
    faasnet_variation_pct = (max(f) - min(f)) / min(f) * 100.0
    checks = {
        "baseline_monotone_improving": all(
            a > b for a, b in zip(makespans("baseline"), makespans("baseline")[1:])
        ),
        "on_demand_monotone_improving": all(
            a > b for a, b in zip(makespans("on_demand"), makespans("on_demand")[1:])
        ),
        "faasnet_variation_pct": faasnet_variation_pct,
        "faasnet_flat_within_5pct": faasnet_variation_pct < 5.0,
    }
    out = {
        "n_vms": args.vms,
        "shard_counts": list(SHARD_COUNTS),
        "per_shard_egress_gbps": args.shard_gbps,
        "per_shard_qps": args.shard_qps,
        "policy": args.policy,
        "sweep": sweep,
        "speedup_vs_1_shard": {
            system: {
                str(s): sweep[system]["1"]["makespan_s"]
                / sweep[system][str(s)]["makespan_s"]
                for s in SHARD_COUNTS
            }
            for system in SYSTEMS
        },
        "checks": checks,
        "paper_claim": (
            "§4.3: baseline/on-demand provisioning scales with registry "
            "bandwidth; FaaSNet is insensitive to it"
        ),
        "device": describe(args.device, launches),
    }
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=2, sort_keys=True)
        fh.write("\n")

    print(f"{args.vms} VMs, {args.shard_gbps} Gbps x {args.policy} shards "
          f"-> {args.out}")
    print(f"{'system':10s} " + " ".join(f"{s:>4d}sh" for s in SHARD_COUNTS)
          + "   speedup@8")
    for system in SYSTEMS:
        m = makespans(system)
        print(f"{system:10s} " + " ".join(f"{x:6.1f}" for x in m)
              + f"   {m[0] / m[-1]:6.2f}x")
    print(f"faasnet variation across sweep: {faasnet_variation_pct:.2f}% "
          f"(claim: < 5%); K1 launches {launches}")

    if not args.no_check:
        assert checks["baseline_monotone_improving"], makespans("baseline")
        assert checks["on_demand_monotone_improving"], makespans("on_demand")
        assert checks["faasnet_flat_within_5pct"], faasnet_variation_pct


if __name__ == "__main__":
    main()
