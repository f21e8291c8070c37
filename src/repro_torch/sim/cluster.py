"""Provisioning-wave simulation for FaaSNet and the paper's baselines.

``provision_wave`` reproduces the microbenchmark methodology of paper §4.3:
N concurrent invocations, each creating one container on its own VM, timed
from request to container-created.  Per-system behaviour and the calibrated
constants (paper §4.1: 2-CPU / 4 GB / 1 Gbps VMs, 758 MB PyStan image,
512 KB blocks) live here; EXPERIMENTS.md records the calibration.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core import FunctionTree, RPCCosts
from repro_torch.core.registry import RegistrySpec, ShardResolver
from repro_torch.core.topology import (
    baseline_block_plan,
    baseline_plan,
    dadi_plan,
    faasnet_block_plan,
    faasnet_plan,
    kraken_plan,
    on_demand_block_plan,
    on_demand_plan,
)

from .engine import GBPS, SimConfig, make_sim

MB = 1e6


@dataclass
class WaveConfig:
    """Workload + calibration knobs for one provisioning wave."""

    image_bytes: int = int(758 * MB)  # paper's default PyStan image
    # Fraction of the image a container must hold before it can start.
    # Paper Fig. 20: 512 KB blocks give an 83.9 % network-I/O reduction on
    # the 728 MB Alibaba base image => ~15-16 % fetched.
    startup_fraction: float = 0.15
    # App-level per-stream throughput (paper Fig. 16: ~30 MB/s outbound
    # split across 2 children; ~15 MB/s inbound per stream while seeding,
    # ~30 MB/s when only fetching).
    per_stream_cap: float = 30 * MB
    # Store-and-forward + decompress cost per tree hop (drives the 1.5 s
    # first-to-last spread of paper Fig. 15).
    hop_latency: float = 0.2
    container_start: float = 2.5  # runc + runtime init once blocks are local
    image_extract_rate: float = 100 * MB  # docker-pull layer extraction
    # Per-VM memory budget (paper §4.1: 2-CPU / 4 GB VMs) — the admission
    # denominator for shared-pool placement.
    vm_mem_mb: int = 4096
    n_layers: int = 10  # layer count for layer-granular systems (Kraken)
    registry_out_cap: float = 9.5 * GBPS
    # Registry request throttling for block-granular (on-demand) fetchers.
    registry_qps: float = 1100.0
    # Sharded registry: ``None`` means one shard with the two caps above
    # (bit-identical to the pre-sharding simulator); an explicit spec wins
    # outright — its per-shard egress/qps replace the legacy knobs.
    registry: RegistrySpec | None = None
    rpc: RPCCosts = field(default_factory=RPCCosts)
    kraken_coord_s: float = 0.070  # origin CPU per (node, layer) announce
    dadi_coord_s: float = 0.160  # DADI root CPU per joining node
    seed: int = 0
    # Engine backend for the wave's FlowSim ("vector_torch" | "vector" |
    # "incremental"), whether it keeps the per-event text log, and the torch
    # device of "vector_torch"; threaded into SimConfig by every wave entry
    # point.
    engine: str = "vector_torch"
    record_trace: bool = True
    device: str = "cuda"
    # Vector engines: closures whose ready set is at most this many flows
    # take the scalar per-flow path instead of the batched numpy/torch one
    # (small-front fixed-cost crossover; see SimConfig.vector_scalar_cutoff).
    vector_scalar_cutoff: int = 64
    # Block-level provisioning (paper §3.1–§3.2): when set, provision_wave
    # fetches this image's missing blocks per layer instead of the scalar
    # ``image_bytes * startup_fraction`` payload, and a container is ready
    # at its *runnable prefix* (boot working set), not full arrival.
    # ``None`` (the default) keeps the scalar model bit-identically.
    image: "object | None" = None  # repro_torch.core.image.ImageSpec

    def registry_spec(self) -> RegistrySpec:
        return RegistrySpec.resolve(
            self.registry, egress_cap=self.registry_out_cap, qps=self.registry_qps
        )


SYSTEMS = ("faasnet", "baseline", "on_demand", "kraken", "dadi_p2p")


def provision_wave(
    system: str,
    n: int,
    cfg: WaveConfig | None = None,
    *,
    warm_roots: int = 0,
    slow_vms: dict[str, float] | None = None,
    straggler_mitigation: bool = False,
) -> dict[str, float]:
    """Provision ``n`` containers concurrently; return vm_id -> latency (s).

    ``warm_roots`` > 0 models the paper's 1→N (rather than 0→N) burst: that
    many VMs already hold the image and only seed.  ``slow_vms`` injects
    stragglers (vm_id -> egress cap in bytes/s); with
    ``straggler_mitigation`` the FT manager demotes a detected slow interior
    node to a leaf (delete + re-insert) before the wave is planned —
    FaaSNet's adaptivity applied to stragglers.
    """
    cfg = cfg or WaveConfig()
    if cfg.image is not None and system in ("faasnet", "baseline", "on_demand"):
        # Block-level provisioning: a container is ready once its boot
        # working set (runnable prefix) landed, not at full arrival.
        if warm_roots or slow_vms or straggler_mitigation:
            raise ValueError(
                "block-level waves (cfg.image) do not support warm_roots/"
                "slow_vms/straggler_mitigation"
            )
        res = block_wave(system, n, cfg, images=cfg.image)
        return {vm: v["runnable"] for vm, v in res.items()}
    nodes = [f"vm{i}" for i in range(n)]
    coord_cost = {"kraken": cfg.kraken_coord_s, "dadi_p2p": cfg.dadi_coord_s}.get(
        system, 0.0
    )
    spec = cfg.registry_spec()
    resolver = ShardResolver(spec)  # one resolver per wave: stateful policies
    sim = make_sim(
        SimConfig(
            registry=spec,
            per_stream_cap=cfg.per_stream_cap,
            hop_latency=cfg.hop_latency,
            coordinator_cost_s=coord_cost,
            engine=cfg.engine,
            record_trace=cfg.record_trace,
            vector_scalar_cutoff=cfg.vector_scalar_cutoff,
            device=cfg.device,
        )
    )
    for vm, cap in (slow_vms or {}).items():
        sim.set_slow_vm(vm, cap)

    control = cfg.rpc.control_plane_total()
    lat: dict[str, float] = {}
    done_at: dict[str, float] = {}

    def on_done(vm: str, t: float) -> None:
        done_at[vm] = t

    if system == "faasnet":
        ft = FunctionTree("f")
        for i in range(warm_roots):
            ft.insert(f"warm{i}")
        for vmid in nodes:
            ft.insert(vmid)
        if straggler_mitigation and slow_vms:
            for vmid in slow_vms:
                if vmid in ft and ft.children_of(vmid):
                    ft.delete(vmid)
                    ft.insert(vmid)  # re-attach at the frontier => leaf
        plan = faasnet_plan(
            ft,
            image_bytes=cfg.image_bytes,
            startup_fraction=cfg.startup_fraction,
            manifest_latency=cfg.rpc.manifest_fetch,
            registry=resolver,
        )
        # warm roots already have the payload: zero-byte flows
        plan = _mark_warm(plan, {f"warm{i}" for i in range(warm_roots)})
        extra = cfg.container_start + cfg.rpc.image_load
    elif system == "baseline":
        plan = baseline_plan(nodes, image_bytes=cfg.image_bytes, registry=resolver)
        extra = cfg.container_start + cfg.image_bytes / cfg.image_extract_rate
    elif system == "on_demand":
        plan = on_demand_plan(
            nodes,
            image_bytes=cfg.image_bytes,
            startup_fraction=cfg.startup_fraction,
            manifest_latency=cfg.rpc.manifest_fetch,
            registry=resolver,
        )
        extra = cfg.container_start + cfg.rpc.image_load
    elif system == "kraken":
        layer = cfg.image_bytes // cfg.n_layers
        plan = kraken_plan(
            nodes,
            layer_bytes=[layer] * cfg.n_layers,
            origin="origin",
            seed=cfg.seed,
        )
        extra = cfg.container_start + cfg.image_bytes / cfg.image_extract_rate
    elif system == "dadi_p2p":
        plan = dadi_plan(
            nodes,
            image_bytes=cfg.image_bytes,
            root="vm0",
            startup_fraction=cfg.startup_fraction,
            registry=resolver,
        )
        extra = cfg.container_start + cfg.rpc.image_load
    else:
        raise ValueError(f"unknown system {system!r}; one of {SYSTEMS}")

    sim.add_plan(plan, t0=control, on_node_done=on_done)
    sim.run()
    for vm in nodes:
        if vm not in done_at:  # pragma: no cover - indicates a sim bug
            raise RuntimeError(f"{system}: {vm} never finished its fetch")
        lat[vm] = done_at[vm] + extra
    return lat


def _mark_warm(plan, warm: set[str]):
    """Zero out inbound flows of warm nodes (they already hold the image)."""
    from repro_torch.core.topology import DistributionPlan, Flow

    flows = [
        Flow(f.src, f.dst, f.piece, 0 if f.dst in warm else f.bytes)
        for f in plan.flows
    ]
    return DistributionPlan(
        flows=flows,
        control_latency=plan.control_latency,
        coordinator=plan.coordinator,
        streaming=plan.streaming,
    )


BLOCK_SYSTEMS = ("faasnet", "baseline", "on_demand")


def block_wave(
    system: str,
    n: int,
    cfg: WaveConfig | None = None,
    *,
    images=None,
    cache=None,
) -> dict[str, dict[str, float]]:
    """Block-granular provisioning wave: per-VM runnable + full-arrival times.

    ``images`` is one :class:`~repro_torch.core.image.ImageSpec` for all ``n`` VMs
    or a per-VM list; ``cache`` is the cross-wave
    :class:`~repro_torch.core.image.BlockCache` (fresh by default) — pass the same
    cache across consecutive waves to model warm block reuse, and distinct
    images sharing base layers to model cross-function dedup.  Returns
    ``vm_id -> {"runnable": t, "done": t}``: *runnable* is the paper's §3.2
    boot-working-set milestone plus container start, *done* is full image
    materialization plus the same tail.  Each VM's fetched image is recorded
    in ``cache`` after the wave.
    """
    from repro_torch.core.image import BlockCache, ImageSpec

    cfg = cfg or WaveConfig()
    if images is None:
        images = cfg.image
    if images is None:
        raise ValueError("block_wave needs an ImageSpec (images= or cfg.image)")
    if isinstance(images, ImageSpec):
        images = [images] * n
    if len(images) != n:
        raise ValueError(f"need one image per VM: {len(images)} images, {n} VMs")
    cache = cache if cache is not None else BlockCache()
    nodes = [f"vm{i}" for i in range(n)]
    img_of = dict(zip(nodes, images))
    spec = cfg.registry_spec()
    resolver = ShardResolver(spec)
    sim = make_sim(
        SimConfig(
            registry=spec,
            per_stream_cap=cfg.per_stream_cap,
            hop_latency=cfg.hop_latency,
            engine=cfg.engine,
            record_trace=cfg.record_trace,
            vector_scalar_cutoff=cfg.vector_scalar_cutoff,
            device=cfg.device,
        )
    )
    control = cfg.rpc.control_plane_total()
    runnable_at: dict[str, float] = {}
    done_at: dict[str, float] = {}

    def on_runnable(vm: str, t: float) -> None:
        runnable_at.setdefault(vm, t)

    def on_done(vm: str, t: float) -> None:
        done_at[vm] = max(done_at.get(vm, 0.0), t)  # last layer = full image

    # One plan per distinct image: FT fan-out stays within an image's VMs.
    groups: dict[str, list[str]] = {}
    for vm in nodes:
        groups.setdefault(img_of[vm].name, []).append(vm)
    for vms in groups.values():
        img = img_of[vms[0]]
        if system == "faasnet":
            ft = FunctionTree(img.name)
            for vm in vms:
                ft.insert(vm)
            plan = faasnet_block_plan(
                ft,
                image=img,
                cache=cache,
                manifest_latency=cfg.rpc.manifest_fetch,
                registry=resolver,
            )
        elif system == "on_demand":
            plan = on_demand_block_plan(
                vms,
                image=img,
                cache=cache,
                manifest_latency=cfg.rpc.manifest_fetch,
                registry=resolver,
            )
        elif system == "baseline":
            plan = baseline_block_plan(
                vms, image=img, cache=cache, registry=resolver
            )
        else:
            raise ValueError(
                f"unknown block system {system!r}; one of {BLOCK_SYSTEMS}"
            )
        sim.add_plan(
            plan, t0=control, on_node_done=on_done, on_node_runnable=on_runnable
        )
    sim.run()
    out: dict[str, dict[str, float]] = {}
    for vm in nodes:
        img = img_of[vm]
        if vm not in runnable_at or vm not in done_at:  # pragma: no cover
            raise RuntimeError(f"{system}: {vm} never finished its block fetch")
        if system == "baseline":
            extra = cfg.container_start + img.total_bytes() / cfg.image_extract_rate
        else:
            extra = cfg.container_start + cfg.rpc.image_load
        out[vm] = {
            "runnable": runnable_at[vm] + extra,
            "done": done_at[vm] + extra,
        }
        cache.add_image(vm, img)
    return out


def scalability_table(
    systems: tuple[str, ...] = SYSTEMS,
    ns: tuple[int, ...] = (8, 16, 32, 64, 128),
    cfg: WaveConfig | None = None,
) -> dict[str, dict[int, dict[str, float]]]:
    """Paper Figure 14(a): mean/min/max provisioning latency vs concurrency."""
    out: dict[str, dict[int, dict[str, float]]] = {}
    for system in systems:
        out[system] = {}
        for n in ns:
            lat = list(provision_wave(system, n, cfg).values())
            lat.sort()
            out[system][n] = {
                "mean": sum(lat) / len(lat),
                "min": lat[0],
                "max": lat[-1],
                "p50": lat[len(lat) // 2],
            }
    return out


def startup_timeline(system: str, n: int, cfg: WaveConfig | None = None) -> list[float]:
    """Paper Figure 15: sorted wall-clock start times of the N functions."""
    return sorted(provision_wave(system, n, cfg).values())
