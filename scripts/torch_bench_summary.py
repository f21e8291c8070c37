#!/usr/bin/env python
"""Print the headline numbers from every BENCH_torch_*.json in one table.

The port's counterpart of ``scripts/bench_summary.py``.  Consolidates the
six artifacts that ``benchmarks_torch/`` writes —

  * ``BENCH_torch_scale.json``     (bench_scale_1000.py: §4.2 burst)
  * ``BENCH_torch_trace.json``     (bench_trace_replay.py: §4.2 traces)
  * ``BENCH_torch_registry.json``  (bench_registry_sweep.py: §4.3)
  * ``BENCH_torch_placement.json`` (bench_placement.py: §3.1/§5 pool)
  * ``BENCH_torch_serving.json``   (bench_serving.py: request serving)
  * ``BENCH_torch_blocks.json``    (bench_blocks.py: §3.1–§3.2 blocks)

— into one terminal summary, each section with the device it ran on (the
card's name and power limit, or ``cpu``) and the cap-chain kernel's (K1)
launches.  Missing files are reported and skipped, never fatal.

Usage::

    python scripts/torch_bench_summary.py            # reads ./BENCH_torch_*.json
    python scripts/torch_bench_summary.py --dir path/to/artifacts
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path


def _load(root: Path, name: str) -> dict | None:
    p = root / name
    if not p.exists():
        print(f"  [missing] {name} — run its benchmark to produce it")
        return None
    with open(p) as f:
        return json.load(f)


def summarize_device(d: dict) -> None:
    dev = d["device"]
    where = "cpu" if dev["name"] == "cpu" else f"{dev['name']}, {dev['power_limit']}"
    print(
        f"  device: {where} (torch {dev['torch']}); K1 launches "
        f"{sum(dev['k1_launches'].values())} "
        + " ".join(f"{k}={v}" for k, v in dev["k1_launches"].items())
    )


def summarize_scale(d: dict) -> None:
    print(
        f"  {d['n_vms']} VMs x {d['n_functions']} fns x "
        f"{d['containers_per_function']}/fn: fetch makespan "
        f"{d['fetch_makespan_s']:.1f} s (paper §4.2: {d['paper_reference_s']} s), "
        f"{d['events_per_s']:,.0f} events/s, FT build {d['ft_build_s']*1e3:.0f} ms"
    )
    vec = d.get("vector")
    if vec:
        print(
            f"  {vec['engine']} engine: {vec['events_per_s']:,.0f} events/s "
            f"({vec['speedup_vs_incremental']:.1f}x incremental, "
            f"match={vec['matches_incremental']})"
        )
    mega = d.get("mega_burst")
    if mega:
        mv = mega.get("vector")
        mv_s = (
            f", {mv['engine']} {mv['events_per_s']:,.0f} events/s" if mv else ""
        )
        print(
            f"  mega-burst {mega['n_vms']} VMs / {mega['n_containers']} "
            f"containers: {mega['total_wall_s']:.1f} s wall, control-plane "
            f"build {mega['control_plane_build_s']:.1f} s, "
            f"{mega['events_per_s']:,.0f} events/s{mv_s}"
        )
    giga = d.get("giga_burst")
    if giga:
        sp = giga.get("speedup_vs_mega_incremental")
        sp_s = f" ({sp:.1f}x mega-tier incremental)" if sp else ""
        print(
            f"  giga-burst {giga['n_vms']} VMs / {giga['n_containers']} "
            f"containers [{giga['engine']}]: "
            f"{giga['total_wall_s']:.1f} s wall, engine {giga['wall_s']:.1f} s, "
            f"{giga['events_per_s']:,.0f} events/s{sp_s}"
        )


def summarize_trace(d: dict) -> None:
    print(
        f"  {d['n_tenants']} tenants x {d['vm_pool_size']} VMs x "
        f"{d['minutes']} min: prov-time ratio vs baseline "
        f"{d['prov_time_ratio_vs_baseline']:.3f} "
        f"({d['prov_time_reduction_pct']:.1f}% less; paper: "
        f"{d['paper_reduction_pct']}%), peak registry "
        f"{d['peak_registry_egress_gbps']:.2f} Gbps, "
        f"failovers={d['failovers']}"
    )


def summarize_registry(d: dict) -> None:
    top = str(max(int(s) for s in d["shard_counts"]))
    sp = d["speedup_vs_1_shard"]
    print(
        f"  {top} replicated shards: baseline {sp['baseline'][top]:.2f}x, "
        f"on_demand {sp['on_demand'][top]:.2f}x faster, faasnet "
        f"{sp['faasnet'][top]:.2f}x (insensitive — §4.3 bottleneck removed)"
    )


def summarize_placement(d: dict) -> None:
    rows = d["rows"]
    ft = d["ft_aware_vs_binpack_worst_p99_prov"]
    rec = d["histogram_vs_fixed_reclaim"]
    print(
        f"  {d['n_tenants']} tenants x {d['vm_pool_size']} VMs x "
        f"{d['minutes']} min: shared pool "
        f"{rows['shared']['vm_hours']:.1f} VM-h vs exclusive "
        f"{rows['exclusive']['vm_hours']:.1f} VM-h "
        f"({d['shared_vs_exclusive_vm_hours_saved_pct']:.1f}% saved)"
    )
    print(
        f"  §5 FT-aware worst p99 prov {ft['ft_aware_s']:.2f} s vs binpack "
        f"{ft['binpack_s']:.2f} s; histogram reclaim "
        f"{rec['vm_hours_histogram']:.1f} VM-h / {rec['cold_starts_histogram']} "
        f"cold starts vs fixed {rec['vm_hours_fixed']:.1f} VM-h / "
        f"{rec['cold_starts_fixed']}"
    )


def summarize_serving(d: dict) -> None:
    mix, cold = d["mix"], d["cold_burst"]
    fa, ba = mix["faasnet"], mix["baseline"]
    print(
        f"  mix: {mix['n_tenants']} tenants x {mix['minutes']} min: pooled "
        f"p50/p99 response {fa['pooled_p50_s']:.2f}/{fa['pooled_p99_s']:.2f} s, "
        f"platform p99 {fa['platform_p99_s']:.2f} s "
        f"(baseline {ba['platform_p99_s']:.2f} s)"
    )
    h, n = cold["herd"], cold["naive"]
    print(
        f"  cold burst {cold['burst_requests']} reqs: herd "
        f"{h['total_provisioned']} provisioned / {h['total_wasted']} wasted / "
        f"p99 {h['platform_p99_s']:.2f} s vs naive {n['total_provisioned']} / "
        f"{n['total_wasted']} / {n['platform_p99_s']:.2f} s"
    )


def summarize_blocks(d: dict) -> None:
    sh, rp = d["layer_sharing"], d["runnable_at_prefix"]
    amp = d["read_amplification"]["by_block_size"]
    k512 = str(512 * 1024)
    print(
        f"  {sh['n_functions']} fns on {sh['n_bases']} shared bases: "
        f"{sh['runnable_speedup_shared_vs_disjoint']:.2f}x faster to runnable "
        f"than disjoint ({sh['shared_runnable_total_s']:.1f}s vs "
        f"{sh['disjoint_runnable_total_s']:.1f}s)"
    )
    print(
        f"  runnable at boot prefix {rp['runnable_makespan_s']:.2f}s vs full "
        f"arrival {rp['full_arrival_makespan_s']:.2f}s "
        f"({rp['runnable_vs_full_ratio']:.0%}); Fig. 20 @ 512 KB blocks: "
        f"amp {amp[k512]['read_amplification']:.3f}, boot fetch "
        f"{amp[k512]['fetched_fraction_of_image']:.1%} of the image"
    )


SECTIONS = (
    ("BENCH_torch_scale.json", "scale burst (§4.2)", summarize_scale),
    ("BENCH_torch_trace.json", "multi-tenant traces (§4.2)", summarize_trace),
    ("BENCH_torch_registry.json", "registry shard sweep (§4.3)", summarize_registry),
    ("BENCH_torch_placement.json", "shared pool placement (§3.1/§5)", summarize_placement),
    ("BENCH_torch_serving.json", "request-level serving (§4.4)", summarize_serving),
    ("BENCH_torch_blocks.json", "block-level provisioning (§3.1–§3.2)", summarize_blocks),
)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--dir", default=".", help="directory holding the BENCH_torch_*.json artifacts"
    )
    args = ap.parse_args(argv)
    root = Path(args.dir)
    for fname, title, fn in SECTIONS:
        print(f"{title} [{fname}]")
        d = _load(root, fname)
        if d is not None:
            try:
                fn(d)
                summarize_device(d)
            except KeyError as e:  # stale artifact from an older bench version
                print(f"  [stale] {fname} lacks {e}; re-run its benchmark")
        print()


if __name__ == "__main__":
    main()
