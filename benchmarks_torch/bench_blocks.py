"""Block-level provisioning on the port: layer sharing, runnable-at-prefix, Fig. 20.

The port's counterpart of ``benchmarks/bench_blocks.py``.  Three experiments
against the block/layer image model (:mod:`repro_torch.core.image` + the
block plans of ``repro_torch.core.topology``), written to ``BENCH_torch_blocks.json``:

  * **layer sharing** — 25 functions deployed as consecutive waves onto one
    warm VM pool, built from 3 shared base images vs 25 disjoint ones.
    Shared bases dedup in the per-VM block caches, so only each function's
    private app layer travels after the first wave per base; the bench
    asserts the shared stack is >= 2x faster on total time-to-runnable.
  * **runnable at prefix** — one cold FaaSNet wave on the paper's 758 MB
    image: the §3.2 boot-working-set milestone (`runnable`) must land well
    before full image arrival (`done`), and the incremental and
    ``vector_torch`` engines must agree bit-for-bit on both.
  * **read amplification** — paper Fig. 20: the boot working set is rounded
    up to whole blocks per layer, so fetched/useful grows with block size;
    the sweep records the curve and asserts monotonicity.

The waves run ``vector_torch`` on ``--device``.  Their fronts are at most
a few flows wide, under the engine's scalar cutoff, so layer sharing never
reaches the cap-chain kernel (K1); the runnable-at-prefix engine check runs
its ``vector_torch`` side with ``vector_scalar_cutoff=0``, every front
through K1 on the card.  The artifact carries the reference's keys plus a
``device`` block with K1's launches; the check's are counted under
``runnable_at_prefix.engine_check_cutoff_0``, as launches that cutoff forces
and the waves at the default cutoff never make.

Usage::

    PYTHONPATH=src python benchmarks_torch/bench_blocks.py           # full size, on the card
    PYTHONPATH=src python benchmarks_torch/bench_blocks.py --quick --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

MB = 1 << 20


def layer_sharing(n_functions: int, n_bases: int, n_vms: int, device: str) -> dict:
    """Sequential deployment waves on one pool: shared bases vs disjoint."""
    from repro_torch.core import BlockCache, disjoint_images, shared_base_images
    from repro_torch.sim import WaveConfig, block_wave

    image_bytes = 256 * MB
    # production runc start (RPCCosts)
    cfg = WaveConfig(container_start=0.5, device=device)

    def deploy(images) -> tuple[float, float]:
        cache = BlockCache()
        runnable = done = 0.0
        for img in images:
            res = block_wave("faasnet", n_vms, cfg, images=img, cache=cache)
            runnable += max(v["runnable"] for v in res.values())
            done += max(v["done"] for v in res.values())
        return runnable, done

    sr, sd = deploy(shared_base_images(n_functions, n_bases, image_bytes=image_bytes))
    dr, dd = deploy(disjoint_images(n_functions, image_bytes=image_bytes))
    speedup = dr / sr
    assert speedup >= 2.0, (
        f"layer sharing only {speedup:.2f}x on time-to-runnable "
        f"(shared {sr:.1f}s vs disjoint {dr:.1f}s) — block-cache dedup of "
        f"shared base layers is not paying"
    )
    return {
        "n_functions": n_functions,
        "n_bases": n_bases,
        "n_vms_per_wave": n_vms,
        "image_bytes": image_bytes,
        "shared_runnable_total_s": sr,
        "shared_done_total_s": sd,
        "disjoint_runnable_total_s": dr,
        "disjoint_done_total_s": dd,
        "runnable_speedup_shared_vs_disjoint": speedup,
        "done_speedup_shared_vs_disjoint": dd / sd,
    }


def runnable_at_prefix(n_vms: int, device: str) -> dict:
    """Cold FaaSNet wave, paper-size image: runnable beats full arrival."""
    from repro_torch.core import ImageSpec, LayerSpec
    from repro_torch.sim import WaveConfig, block_wave

    # The paper's 758 MB PyStan image as a 4-layer stack, 512 KB blocks
    # (the block size Fig. 20 picks), 15 % boot working set.
    sizes = (256 * MB, 256 * MB, 128 * MB, 758 * MB - 640 * MB)
    img = ImageSpec(
        "pystan",
        tuple(LayerSpec(f"pystan:L{i}", s) for i, s in enumerate(sizes)),
        block_size=512 * 1024,
        boot_fraction=0.15,
    )
    # The wave's fronts are at most a few flows wide, under the scalar
    # cutoff, so the vector_torch side runs with cutoff 0: every front goes
    # through K1, and the engine check holds the card's route bit for bit.
    engines = {
        "incremental": WaveConfig(engine="incremental", device=device),
        "vector_torch": WaveConfig(device=device, vector_scalar_cutoff=0),
    }
    res = {
        eng: block_wave("faasnet", n_vms, cfg, images=img)
        for eng, cfg in engines.items()
    }
    assert res["incremental"] == res["vector_torch"], (
        "engine divergence on the block wave"
    )
    r = max(v["runnable"] for v in res["incremental"].values())
    d = max(v["done"] for v in res["incremental"].values())
    assert r < d, (
        f"runnable-at-prefix milestone ({r:.2f}s) did not beat full-image "
        f"arrival ({d:.2f}s)"
    )
    return {
        "n_vms": n_vms,
        "image_bytes": img.total_bytes(),
        "boot_fraction": img.boot_fraction,
        "block_size": img.block_size,
        "runnable_makespan_s": r,
        "full_arrival_makespan_s": d,
        "runnable_vs_full_ratio": r / d,
        "engines_match": True,
    }


def read_amplification_sweep() -> dict:
    """Paper Fig. 20: fetched/useful bytes of the boot set vs block size."""
    from repro_torch.core import ImageSpec, LayerSpec

    sizes = (256 * MB, 256 * MB, 128 * MB, 758 * MB - 640 * MB)
    points = {}
    for bs in (128 * 1024, 256 * 1024, 512 * 1024, MB, 2 * MB, 4 * MB, 8 * MB):
        img = ImageSpec(
            "pystan",
            tuple(LayerSpec(f"pystan:L{i}", s) for i, s in enumerate(sizes)),
            block_size=bs,
            boot_fraction=0.15,
        )
        points[str(bs)] = {
            "read_amplification": img.boot_read_amplification(),
            "boot_fetched_bytes": sum(
                img.boot_prefix_bytes(la.digest) for la in img.layers
            ),
            "fetched_fraction_of_image": sum(
                img.boot_prefix_bytes(la.digest) for la in img.layers
            )
            / img.total_bytes(),
        }
    amps = [p["read_amplification"] for p in points.values()]
    assert amps == sorted(amps), f"read amplification not monotone: {amps}"
    # Fig. 20's operating point: at 512 KB blocks the boot fetch stays a
    # small fraction of the image (the paper reports ~84 % I/O reduction).
    frac_512k = points[str(512 * 1024)]["fetched_fraction_of_image"]
    assert frac_512k < 0.2, f"512 KB boot fetch is {frac_512k:.1%} of the image"
    return {"boot_fraction": 0.15, "by_block_size": points}


def main(argv: list[str] | None = None) -> None:
    from repro_torch.launch.device import describe, k1_launches, require

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true", help="8 functions, 4 VMs")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="BENCH_torch_blocks.json")
    args = ap.parse_args(argv)
    require(args.device)
    n_fns, n_vms = (8, 4) if args.quick else (25, 8)

    launches: dict[str, int] = {}
    t0 = time.perf_counter()
    with k1_launches(launches, "layer_sharing"):
        sharing = layer_sharing(n_fns, 3, n_vms, args.device)
    # Counted apart: these launches come only from the engine check's
    # cutoff 0; the waves at the default cutoff launch none.
    with k1_launches(launches, "runnable_at_prefix.engine_check_cutoff_0"):
        prefix = runnable_at_prefix(16, args.device)
    fig20 = read_amplification_sweep()
    out = {
        "quick": args.quick,
        "wall_s": time.perf_counter() - t0,
        "layer_sharing": sharing,
        "runnable_at_prefix": prefix,
        "read_amplification": fig20,
        "device": describe(args.device, launches),
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(
        f"layer sharing: {sharing['n_functions']} fns on {sharing['n_bases']} "
        f"bases {sharing['runnable_speedup_shared_vs_disjoint']:.2f}x faster "
        f"to runnable than disjoint "
        f"({sharing['shared_runnable_total_s']:.1f}s vs "
        f"{sharing['disjoint_runnable_total_s']:.1f}s)"
    )
    print(
        f"runnable at prefix: {prefix['runnable_makespan_s']:.2f}s vs full "
        f"arrival {prefix['full_arrival_makespan_s']:.2f}s "
        f"({prefix['runnable_vs_full_ratio']:.0%}) on "
        f"{prefix['image_bytes'] / MB:.0f} MB x {prefix['n_vms']} VMs"
    )
    amp = fig20["by_block_size"]
    lo, hi = str(128 * 1024), str(8 * MB)
    print(
        f"read amplification (Fig. 20): {amp[lo]['read_amplification']:.3f} @ "
        f"128 KB -> {amp[hi]['read_amplification']:.3f} @ 8 MB blocks; "
        f"512 KB boot fetch = "
        f"{amp[str(512 * 1024)]['fetched_fraction_of_image']:.1%} of the image"
    )
    print(f"wrote {args.out} in {out['wall_s']:.1f}s; K1 launches {launches}")


if __name__ == "__main__":
    main()
