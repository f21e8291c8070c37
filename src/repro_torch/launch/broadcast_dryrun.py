"""Dry run of the FaaSNet weight-broadcast schedules on the production mesh.

The checkpoint payload (an arch's bf16 parameters, model-sharded) must
reach every data replica.  For each schedule this counts, with no card and
no allocation, the collectives the schedule issues per device and models
the serialized link time: rounds are serialized, and the sends of one round
run concurrently on disjoint links (the schedule generators guarantee
single-port validity).  The JAX package compiles the ``ppermute`` program
and parses the same counts from its HLO (``repro/launch/broadcast_dryrun.py``);
the port takes them from its own round lists (``distributed/broadcast.py``),
one collective per round:

  * ``naive``     — DP-1 permutes of the device's shard;
  * ``binomial``  — one permute of the shard per round of ``binomial_rounds``;
  * ``pipelined`` — one permute of a block per round of ``faasnet_rounds``;
  * ``allgather`` — one all-gather of the shard;

each priced as its operand's bytes in the payload's dtype (bf16, or int8
with ``--compress``).  ``modeled_time_s`` puts the serialized bytes on one
NVLink 4 link (``hlo_analysis.LINK_BW``).

    python -m repro_torch.launch.broadcast_dryrun --arch jamba_v01_52b --mesh both
"""
from __future__ import annotations

import argparse
import json
import os
import time


def run_one(arch: str, mesh_kind: str, schedule: str, n_blocks: int,
            outdir: str, compress: bool = False) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.distributed.broadcast import binomial_rounds, faasnet_rounds
    from repro_torch.launch.hlo_analysis import LINK_BW, HloStats
    from repro_torch.launch.mesh import make_production_mesh

    t0 = time.time()
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device="meta")
    axes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    dp = int(np.prod([mesh.shape[a] for a in axes]))
    tp = mesh.shape["model"]

    cfg = get_config(arch)
    n_items = cfg.param_count()  # one element per parameter
    itemsize = 1 if compress else 2  # int8 compression halves wire bytes
    payload_bytes = n_items * itemsize
    # pad so the per-model-shard slice splits evenly into blocks
    per_shard = -(-n_items // tp)
    per_shard = -(-per_shard // n_blocks) * n_blocks
    shard_bytes = per_shard * itemsize
    block_bytes = shard_bytes // n_blocks

    stats = HloStats()
    if schedule == "pipelined":
        rounds = len(faasnet_rounds(dp, n_blocks))
        ser_bytes = rounds * block_bytes
        stats.add_collective("collective-permute", rounds * block_bytes, rounds)
    elif schedule == "binomial":
        rounds = len(binomial_rounds(dp))
        ser_bytes = rounds * shard_bytes
        stats.add_collective("collective-permute", rounds * shard_bytes, rounds)
    elif schedule == "naive":
        rounds = dp - 1
        ser_bytes = rounds * shard_bytes
        stats.add_collective("collective-permute", rounds * shard_bytes, rounds)
    elif schedule == "allgather":
        rounds = 1
        ser_bytes = dp * shard_bytes
        stats.add_collective("all-gather", shard_bytes)
    else:
        raise ValueError(schedule)

    out = {
        "arch": arch,
        "mesh": mesh_kind,
        "schedule": schedule + ("_int8" if compress else ""),
        "dp": dp,
        "n_blocks": n_blocks,
        "payload_gb": payload_bytes / 1e9,
        "per_device_shard_gb": shard_bytes / 1e9,
        "rounds": rounds,
        "collective_bytes": stats.collective_bytes,
        "collective_ops": stats.count_by_kind,
        "serialized_bytes_per_link": ser_bytes,
        "modeled_time_s": ser_bytes / LINK_BW,
        "link_bw": LINK_BW,
        "host_s": round(time.time() - t0, 4),
    }
    os.makedirs(outdir, exist_ok=True)
    name = f"{arch}__{mesh_kind}__{out['schedule']}__b{n_blocks}.json"
    with open(os.path.join(outdir, name), "w") as f:
        json.dump(out, f, indent=1)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="jamba_v01_52b")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--schedules", default="naive,allgather,binomial,pipelined")
    ap.add_argument("--n-blocks", type=int, default=32)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--out", default="results/broadcast_torch")
    args = ap.parse_args()
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for mk in meshes:
        for sched in args.schedules.split(","):
            r = run_one(args.arch, mk, sched, args.n_blocks, args.out)
            print(
                f"OK {args.arch} {mk:6s} {sched:10s} rounds={r['rounds']:3d} "
                f"coll={r['collective_bytes']/1e9:8.2f}GB "
                f"modeled={r['modeled_time_s']:7.3f}s",
                flush=True,
            )
            if args.compress and sched == "pipelined":
                r = run_one(args.arch, mk, sched, args.n_blocks, args.out,
                            compress=True)
                print(
                    f"OK {args.arch} {mk:6s} {sched}_int8 rounds={r['rounds']:3d} "
                    f"coll={r['collective_bytes']/1e9:8.2f}GB "
                    f"modeled={r['modeled_time_s']:7.3f}s",
                    flush=True,
                )


if __name__ == "__main__":
    main()
