"""Single-tenant trace replay (paper §4.2, Figures 11-13).

:class:`TraceReplay` replays one RPS timeline against the simulated FaaS
platform.  It is a thin facade over
:class:`repro_torch.sim.multi_tenant.MultiTenantReplay` with exactly one tenant —
ONE code path implements arrivals, FIFO serving, scale-out, per-system
provisioning over the shared :class:`FlowSim`, and idle reclaim, so the
single-tenant figures and the multi-tenant harness can never diverge.

Resolution is one-second ticks for arrivals/serving; provisioning data
flows evolve in continuous time inside the FlowSim.  ``ReplayConfig.wave``
picks the engine and its device (the port's default: ``vector_torch`` on
``"cuda"``); ``tests/test_torch_multi_tenant.py`` holds the replay equal to
the JAX package's ``TraceReplay``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.registry import RegistrySpec

from .cluster import WaveConfig
from .engine import GBPS
from .multi_tenant import (
    MultiTenantConfig,
    MultiTenantReplay,
    ServingConfig,
    TenantConfig,
    TickStats,
)

__all__ = ["ReplayConfig", "TickStats", "TraceReplay"]


@dataclass
class ReplayConfig:
    system: str = "faasnet"  # faasnet | baseline | on_demand
    function_id: str = "app"
    function_duration_s: float = 2.0
    vm_pool_size: int = 1000
    idle_reclaim_s: float = 7 * 60.0  # scaled-down 15-min production policy
    # The trace tests run against the region-scale production registry, not
    # the 128-VM devcluster one the microbenchmarks were calibrated against
    # (paper §4.1 vs §4.2 use different deployments).
    registry_out_cap: float = 52 * GBPS  # bytes/s (52 Gbps region registry)
    registry_qps: float = 700.0
    # Sharded registry (None = legacy 1 shard built from the caps above).
    registry: Optional[RegistrySpec] = None
    # Pool placement mode + per-instance memory (MB).  With one tenant,
    # "shared" degenerates to exclusive leasing bit-identically (every warm
    # VM already hosts the function, so pick_vm_for always falls back to a
    # fresh reservation — pinned by tests/test_torch_multi_tenant.py), but pays a
    # full heap drain per reservation doing so; a single-tenant replay IS
    # exclusive, so that is the default here (multi-tenant defaults stay
    # "shared").
    placement: str = "exclusive"
    mem_mb: int = 512
    # Reclaim policy: "fixed" (idle_reclaim_s TTL) or "histogram".
    reclaim: str = "fixed"
    max_reserve_per_tick: int = 64  # scheduler VM-reservation rate limit
    # Scale-out target: reserve until (instances + provisioning) reaches
    # ~target_factor × observed RPS (the paper's scheduler grows the IoT
    # burst to ~82 VMs at 100 RPS rather than one VM per queued request).
    vm_target_factor: float = 1.2
    wave: WaveConfig = field(default_factory=WaveConfig)
    # Request-level serving knobs (sub-tick dispatch, CPU slots, herd
    # control); ``None`` keeps the legacy tick-quantized dispatch loop
    # bit-identically — see :class:`repro_torch.sim.multi_tenant.ServingConfig`.
    serving: Optional[ServingConfig] = None
    seed: int = 0


class TraceReplay:
    """Replay one tenant's RPS trace; see :class:`MultiTenantReplay`."""

    def __init__(self, cfg: ReplayConfig) -> None:
        self.cfg = cfg
        self.timeline: list[TickStats] = []
        self.responses: list[tuple[float, float]] = []  # (completion_t, latency)
        self.prov_latencies: list[float] = []
        self._first_req_t: float = float("inf")
        self._last_ready_t: float = float("-inf")
        self.sim = None  # the shared FlowSim, exposed after run()
        self.mgr = None  # the FTManager, exposed after run()

    # ------------------------------------------------------------------
    def run(self, rps_trace: list[float]) -> list[TickStats]:
        cfg = self.cfg
        replay = MultiTenantReplay(
            MultiTenantConfig(
                tenants=[
                    TenantConfig(
                        function_id=cfg.function_id,
                        trace=list(rps_trace),
                        seed=cfg.seed,
                        function_duration_s=cfg.function_duration_s,
                        vm_target_factor=cfg.vm_target_factor,
                        max_reserve_per_tick=cfg.max_reserve_per_tick,
                        mem_mb=cfg.mem_mb,
                    )
                ],
                system=cfg.system,
                vm_pool_size=cfg.vm_pool_size,
                idle_reclaim_s=cfg.idle_reclaim_s,
                registry_out_cap=cfg.registry_out_cap,
                registry_qps=cfg.registry_qps,
                registry=cfg.registry,
                placement=cfg.placement,
                reclaim=cfg.reclaim,
                wave=cfg.wave,
                serving=cfg.serving,
            )
        )
        replay.run()
        tenant = replay.tenants[0]
        self.sim, self.mgr = replay.sim, replay.mgr
        self.timeline = tenant.timeline
        self.responses = tenant.responses
        self.prov_latencies = tenant.prov_latencies
        self._first_req_t = tenant.first_req_t
        self._last_ready_t = tenant.last_ready_t
        return self.timeline

    def prov_makespan_s(self) -> float:
        """First reservation -> last container ready (0 if nothing provisioned)."""
        if not self.prov_latencies:
            return 0.0
        return self._last_ready_t - self._first_req_t

    # ------------------------------------------------------------------
    def recovery_time(self, burst_t: int, normal_s: float = 3.0) -> float:
        """Seconds after ``burst_t`` until mean response returns ≤ normal_s."""
        for ts in self.timeline:
            if ts.t > burst_t and ts.mean_response_s > 0 and ts.mean_response_s <= normal_s:
                return ts.t - burst_t
        return float("inf")
