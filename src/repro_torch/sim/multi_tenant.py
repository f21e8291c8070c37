"""Multi-tenant trace replay: overlapping waves on one shared platform (§4.2).

The paper's end-to-end claim is not a single burst but *trace-driven*
behaviour: FaaSNet sustains the scaled IoT and gaming traces while growing
and reclaiming function trees as load moves between tenants.  This module
drives N tenants — each with its own RPS trace, function id, arrival-jitter
seed and an :class:`~repro_torch.core.ft_manager.FTManager`-owned FunctionTree —
against ONE shared :class:`~repro_torch.sim.engine.FlowSim` and ONE shared VM
pool, so overlapping waves contend for registry egress/QPS and per-VM NICs
exactly as in production.

Shared pool (paper §3.1 + §5)
-----------------------------
With ``placement="shared"`` (the default) the VM pool is genuinely shared
across tenants: scale-out goes through
:meth:`~repro_torch.core.ft_manager.FTManager.pick_vm_for`, which admits a
function onto an already-warm VM by **memory** (each tenant's ``mem_mb``
requirement charged against the VM's 4 GB budget) before falling back to a
fresh reservation.  One VM then participates in several FunctionTrees at
once — exactly the paper's §3.1 design — and its NIC carries cross-tree
flows (fetching one tenant's image while seeding another's), which is the
co-location pressure the §5 FT-aware placement refinement balances.
Reclaim is evaluated per function-instance through the manager's pluggable
:class:`~repro_torch.core.reclaim.ReclaimPolicy` (fixed idle-TTL by default, or
the keep-alive-histogram predictive policy via ``reclaim="histogram"``),
and a VM returns to the free pool only when its *last* instance is
reclaimed.  ``placement="exclusive"`` preserves the legacy one-VM-one-tenant
leasing bit-identically (pinned by ``GOLDEN_EXCLUSIVE_3T`` in
``tests/test_torch_multi_tenant.py``).

Scheduler failover (ROADMAP: scheduler-shard metadata sync)
-----------------------------------------------------------
At a configurable tick the replay serializes the whole control plane with
:meth:`MultiTenantReplay.snapshot` — the :meth:`FTManager.snapshot` plus the
registry shard map (:class:`~repro_torch.core.registry.RegistrySpec` and the
:class:`~repro_torch.core.registry.ShardResolver` assignment state) — round-trips
it through ``json.dumps`` (proving it is wire-serializable, the etcd-style
sync the paper describes), discards the manager object and continues on
:meth:`restore_snapshot` (legacy bare-manager snapshots restore with a
1-shard registry).  Because the snapshot captures tree topologies, the free
pool in FIFO order, the VM registration order, the telemetry counters and
the shard map, the failed-over run emits a
**bit-identical** :class:`TickStats` stream versus an uninterrupted run — pinned by ``tests/test_torch_multi_tenant.py``,
which also hands snapshots between this replay and the JAX package's.

Request-level serving (ROADMAP: end-to-end p50/p99 response)
------------------------------------------------------------
Attaching a :class:`ServingConfig` (``serving=``) swaps the tick-quantized
one-request-per-instance-per-tick dispatch loop for a request-level one:
arrivals are stamped at sub-second offsets, a per-function FIFO queue is
drained against instance *free times* (so response latency is continuous,
not a multiple of 1 s), co-located requests contend for per-VM CPU slots,
and scale-out happens in herd-controlled provisioning *waves* — a cold
function hit by a 10k-request burst issues exactly one wave under the
per-function in-flight-wave lock instead of a reservation per queued
request.  ``serving=None`` (the default) keeps the pre-serving path
bit-identically — pinned by the differential goldens that
``tests/test_torch_multi_tenant.py`` holds on every engine.

Determinism: arrivals come from the pure LCG in ``repro_torch.sim.traces``,
tenants are stepped in registration order each tick, and the engine orders
events by (time, seq) — two runs of the same config are bit-identical.

``check_partition=True`` asserts the pool invariant at every tick: in
exclusive mode, free_pool + the per-tenant trees *partition* the pool; in
shared mode, every placed instance's memory fits its VM and the occupancy
sets agree across the FTManager (trees + per-VM records), the replay's
instance/provisioning maps, and — across a failover — the restored
snapshot.

Device: the replay builds its one shared sim from ``cfg.wave``, its engine
*and* its ``device`` (``WaveConfig.device`` threaded into the
:class:`SimConfig`, as ``sim/cluster.py`` does), so ``vector_torch`` runs
its wide fronts' cap-chain kernel on the caller's device — the CUDA kernel
on ``"cuda"`` (raising where CUDA is absent), its plain PyTorch version on
``"cpu"``.  ``tests/test_torch_multi_tenant.py`` holds every stream and
result equal to the JAX package's replay on the same config.
"""
from __future__ import annotations

import heapq
import json
import math
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core import FTManager, VMInfo
from repro_torch.core.reclaim import ReclaimPolicy, resolve_reclaim_policy
from repro_torch.core.registry import RegistrySpec, ShardResolver, is_registry_node
from repro_torch.core.topology import DistributionPlan, Flow

from .cluster import WaveConfig
from .engine import GBPS, SimConfig, make_sim
from .traces import arrival_offsets, arrivals_for_second


@dataclass
class TickStats:
    """One second of one tenant's replay (the golden-pinned stream)."""

    t: int
    rps: float
    arrivals: int
    completed: int
    mean_response_s: float
    p99_response_s: float
    active_vms: int
    provisioning_vms: int
    ft_height: int


@dataclass
class TenantConfig:
    """One tenant: a function id, its RPS trace and its scheduler knobs."""

    function_id: str
    trace: list[float]
    seed: int = 0  # arrival-jitter seed (per tenant, so waves decorrelate)
    function_duration_s: float = 2.0
    vm_target_factor: float = 1.2
    max_reserve_per_tick: int = 64
    # Per-instance memory requirement (MB) charged against the hosting VM's
    # budget under shared placement; must fit a single VM.
    mem_mb: int = 512


PLACEMENTS = ("shared", "exclusive")


@dataclass
class ServingConfig:
    """Request-level serving knobs (``None`` on the config = legacy path).

    With a ``ServingConfig`` attached, the replay measures *end-to-end
    request latency* instead of tick-quantized provisioning echoes:

    * **Sub-tick dispatch** — arrivals are stamped at ``t + offset`` (the
      LCG in :func:`repro_torch.sim.traces.arrival_offsets`) and the per-function
      FIFO queue is drained against instance *free times*, not 1 s quanta,
      so the response-latency distribution is continuous.
    * **Per-VM CPU slots** (``cpu_slots``, paper §4.1: 2-CPU VMs) — a VM
      running ``k`` concurrent requests at dispatch time stretches the new
      request's service time by ``max(1, k / cpu_slots)``: co-located busy
      instances contend for the CPU, not just the NIC.
    * **Cold-start herd control** (``herd_control``) — scale-out happens in
      provisioning *waves* guarded by the per-function in-flight-wave lock
      (:meth:`repro_torch.core.ft_manager.FTManager.wave_open` /
      :meth:`~repro_torch.core.ft_manager.FTManager.wave_landed`; the lock rides
      the failover snapshot).  While a wave is in flight the request herd
      parks in the queue and drains as containers land.  A wave is sized to
      sustain the **median** arrival rate over the trailing
      ``rate_window_s`` (median, not instantaneous: a one-tick 10k-request
      burst must not buy a VM per queued request) plus enough instances to
      drain the current backlog within ``drain_budget_s``.  With
      ``herd_control=False`` admission reproduces the pre-serving
      scheduler's naive one-reservation-per-deficit-unit rule (still with
      sub-tick dispatch) — the bench's comparison baseline.
    """

    cpu_slots: int = 2
    herd_control: bool = True
    drain_budget_s: float = 15.0
    rate_window_s: int = 30

    def __post_init__(self) -> None:
        if self.cpu_slots < 1:
            raise ValueError(f"cpu_slots must be >= 1, got {self.cpu_slots}")
        if self.drain_budget_s <= 0:
            raise ValueError(
                f"drain_budget_s must be > 0, got {self.drain_budget_s}"
            )
        if self.rate_window_s < 1:
            raise ValueError(
                f"rate_window_s must be >= 1, got {self.rate_window_s}"
            )


@dataclass
class MultiTenantConfig:
    tenants: list[TenantConfig] = field(default_factory=list)
    system: str = "faasnet"  # faasnet | baseline | on_demand
    vm_pool_size: int = 2000
    idle_reclaim_s: float = 7 * 60.0
    registry_out_cap: float = 52 * GBPS  # region-scale registry (see workload.py)
    registry_qps: float = 700.0
    # Sharded registry: ``None`` keeps the legacy 1-shard registry built from
    # the two caps above (bit-identical streams); an explicit spec wins.
    registry: Optional[RegistrySpec] = None
    wave: WaveConfig = field(default_factory=WaveConfig)
    # Pool sharing: "shared" admits tenants onto warm VMs by memory through
    # pick_vm_for (one VM, many trees — paper §3.1); "exclusive" reproduces
    # the legacy one-VM-one-tenant leasing bit-identically.
    placement: str = "shared"
    # §5 FT-aware placement refinement (False = pure binpack) — only
    # meaningful under shared placement.
    ft_aware_placement: bool = True
    # Reclaim policy: "fixed" (idle-TTL = idle_reclaim_s, the legacy
    # behaviour), "histogram" (predictive keep-alive), or an instance.
    reclaim: "str | ReclaimPolicy" = "fixed"
    # Request-level serving (sub-tick dispatch, CPU slots, herd control).
    # ``None`` keeps the pre-serving one-request-per-instance-per-tick
    # dispatch loop BIT-identically (goldens pinned in
    # tests/test_torch_multi_tenant.py).
    serving: Optional[ServingConfig] = None
    # Block-level provisioning (paper §3.1–§3.2): function_id -> ImageSpec.
    # When set, provisioning emits per-layer flows that skip blocks already
    # resident in the shared per-VM BlockCache, instances activate at the
    # boot-working-set (runnable) milestone instead of full arrival, full
    # materialization lands in the cache for later waves to dedup against,
    # a VM's cache is evicted when it returns to the free pool, and root
    # election prefers VMs already holding the image's blobs.  ``None``
    # (default) keeps the scalar payload model bit-identically.
    images: "Optional[dict]" = None  # dict[str, repro_torch.core.image.ImageSpec]
    # Scheduler failover: snapshot/json-round-trip/restore the FTManager at
    # the *start* of this tick (None = never).  The replay must be
    # bit-identical either way.
    failover_at: Optional[int] = None
    check_partition: bool = False  # assert the pool invariant every tick

    def duration_s(self) -> int:
        return max((len(t.trace) for t in self.tenants), default=0)

    def reclaim_policy(self) -> ReclaimPolicy:
        # A policy *instance* in the config is copied (snapshot round-trip)
        # so each replay owns fresh state — otherwise one run's learned
        # histograms would leak into the next run of the same config and
        # break two-run bit-identity.
        if isinstance(self.reclaim, ReclaimPolicy):
            from repro_torch.core.reclaim import restore_reclaim_policy

            return restore_reclaim_policy(
                self.reclaim.snapshot(), default_ttl_s=self.idle_reclaim_s
            )
        return resolve_reclaim_policy(self.reclaim, default_ttl_s=self.idle_reclaim_s)

    def registry_spec(self) -> RegistrySpec:
        return RegistrySpec.resolve(
            self.registry, egress_cap=self.registry_out_cap, qps=self.registry_qps
        )


@dataclass
class TenantResult:
    function_id: str
    requests: int
    completed: int
    mean_response_s: float
    p99_response_s: float
    mean_prov_s: float
    p99_prov_s: float
    prov_makespan_s: float  # first reservation -> last container ready
    peak_vms: int
    provisioned: int
    # Serving-era telemetry (p50 also populated on legacy runs) ----------
    p50_response_s: float = 0.0
    # Instances whose lifetime service time never paid back the
    # provisioning latency they cost (serving mode only) — the
    # herd-control bench's headline waste metric.
    wasted_provisions: int = 0


@dataclass
class MultiTenantResult:
    system: str
    per_tenant: dict[str, TenantResult]
    timelines: dict[str, list[TickStats]]
    peak_registry_egress: float  # bytes/s, aggregate across shards + tenants
    peak_shard_egress: dict[str, float]  # shard id -> peak egress (bytes/s)
    prov_makespan_s: float  # whole-platform first reservation -> last ready
    total_prov_time_s: float  # sum of all provisioning latencies
    failovers: int
    manager_stats: dict[str, int]
    free_vms: int
    # Shared-pool economics / pressure telemetry ------------------------
    vm_seconds: float = 0.0  # ∫ (VMs out of the free pool) dt over the run
    cold_starts: int = 0  # total provisions (every placement is a cold start)
    peak_nic_utilization: float = 0.0  # peak per-VM NIC rate / capacity

    def vm_hours(self) -> float:
        return self.vm_seconds / 3600.0


@dataclass
class _Instance:
    vm_id: str
    busy_until: float = 0.0
    idle_since: float = 0.0
    served: bool = False  # has handled >=1 request (gates reuse-gap learning)
    prov_cost_s: float = 0.0  # provisioning latency this instance cost
    busy_total_s: float = 0.0  # lifetime service time delivered (serving mode)


class _TenantState:
    """Mutable per-tenant replay state (scheduler side)."""

    def __init__(self, cfg: TenantConfig) -> None:
        self.cfg = cfg
        self.instances: dict[str, _Instance] = {}  # warm, by vm_id
        self.provisioning: dict[str, float] = {}  # vm_id -> request time
        self.flow_of: dict[str, object] = {}  # vm_id -> _FlowState
        # Block mode: vm_id -> {layer digest -> _FlowState} for per-piece
        # cross-wave streaming chains (a child fetches a layer from the
        # parent's in-flight stream of the SAME layer, never another's).
        self.block_flow_of: dict[str, dict[str, object]] = {}
        self.queue: deque[float] = deque()
        self.responses: list[tuple[float, float]] = []  # (completion_t, latency)
        self.prov_latencies: list[float] = []
        self.first_req_t: float = float("inf")
        self.last_ready_t: float = float("-inf")
        self.requests: int = 0
        self.peak_vms: int = 0
        self.timeline: list[TickStats] = []
        # Serving-mode state (unused on the legacy dispatch path) ----------
        self.dispatch_log: list[tuple[float, float]] = []  # (arrival, start)
        self.in_flight: list[float] = []  # min-heap of completion times
        self.completed_done: int = 0  # completions popped from in_flight
        self.wasted: int = 0  # reclaimed instances that never served
        self.arrival_window: deque[int] = deque()  # last rate_window_s counts
        self.stretch_window: deque[float] = deque()  # per-tick mean CPU stretch


def _pctl(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[int(q * (len(sorted_vals) - 1))]


class MultiTenantReplay:
    """N tenants replayed against one FlowSim + one FTManager-owned VM pool."""

    def __init__(self, cfg: MultiTenantConfig) -> None:
        if not cfg.tenants:
            raise ValueError("multi-tenant replay needs at least one tenant")
        fids = [t.function_id for t in cfg.tenants]
        if len(set(fids)) != len(fids):
            raise ValueError(f"duplicate tenant function ids: {fids}")
        if cfg.placement not in PLACEMENTS:
            raise ValueError(
                f"unknown placement {cfg.placement!r}; one of {PLACEMENTS}"
            )
        w = cfg.wave
        for t in cfg.tenants:
            if t.mem_mb > w.vm_mem_mb:
                raise ValueError(
                    f"tenant {t.function_id!r} needs {t.mem_mb} MB but VMs "
                    f"have {w.vm_mem_mb} MB"
                )
        self.cfg = cfg
        spec = cfg.registry_spec()
        self.sim = make_sim(
            SimConfig(
                registry=spec,
                per_stream_cap=w.per_stream_cap,
                hop_latency=w.hop_latency,
                engine=w.engine,
                record_trace=w.record_trace,
                vector_scalar_cutoff=w.vector_scalar_cutoff,
                device=w.device,
            )
        )
        # Shard assignment is scheduler state (it rides the failover snapshot
        # alongside the FTManager, so a restored scheduler keeps placing
        # blobs exactly where the failed one would have).
        self.resolver = ShardResolver(spec)
        self.mgr = self._new_manager()
        for i in range(cfg.vm_pool_size):
            self.mgr.add_free_vm(VMInfo(f"vm{i}", mem_mb=w.vm_mem_mb))
        for t in cfg.tenants:
            self.mgr.set_function_mem(t.function_id, t.mem_mb)
        self.tenants: list[_TenantState] = [_TenantState(t) for t in cfg.tenants]
        # Block mode: ONE shared per-VM block cache across all tenants —
        # data-plane state (it lives with the VMs, not the scheduler), so it
        # survives failover without riding the snapshot.
        self.block_cache = None
        if cfg.images is not None:
            from repro_torch.core.image import BlockCache

            missing = [
                t.function_id
                for t in cfg.tenants
                if t.function_id not in cfg.images
            ]
            if missing:
                raise ValueError(f"cfg.images missing tenants: {missing}")
            self.block_cache = BlockCache()
            self.mgr.set_content_affinity(
                self._image_affinity, candidates=self.block_cache.vms
            )
        self.failovers = 0
        self.vm_seconds = 0.0
        # Serving mode: per-VM completion times of in-flight requests across
        # ALL tenants (lazily pruned) — the CPU-slot contention denominator.
        self._vm_busy: dict[str, list[float]] = {}

    def _new_manager(self) -> FTManager:
        return FTManager(
            vm_idle_reclaim_s=self.cfg.idle_reclaim_s,
            ft_aware_placement=self.cfg.ft_aware_placement,
            reclaim=self.cfg.reclaim_policy(),
        )

    def _image_affinity(self, function_id: str, vm_id: str) -> int:
        """Content-aware root-election score: image bytes resident on the VM."""
        return self.block_cache.resident_bytes(
            vm_id, self.cfg.images[function_id]
        )

    # ------------------------------------------------------------------
    # Scheduler failover (the tentpole's mid-wave snapshot/restore)
    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """Wire-serializable control-plane state: trees + registry layout.

        The registry spec and the shard resolver's assignment state are part
        of the snapshot so a restored scheduler keeps the same shard map.
        Under request serving (version 3) the per-function FIFO request
        queues cross the wire too — a parked herd must survive the failover
        — alongside the wave locks inside the manager snapshot.
        """
        blob = {
            "version": 2,
            "manager": self.mgr.snapshot(),
            "registry": self.resolver.snapshot(),
        }
        if self.cfg.serving is not None:
            blob["version"] = 3
            blob["serving"] = {
                "queues": {
                    ts.cfg.function_id: list(ts.queue) for ts in self.tenants
                }
            }
        return blob

    def restore_snapshot(self, blob: dict) -> None:
        """Rebuild the control plane from :meth:`snapshot` output.

        Legacy snapshots (a bare pre-sharding ``FTManager.snapshot()`` dict,
        no ``manager``/``registry`` envelope) restore with a 1-shard registry
        built from the config's legacy caps.  Snapshots that predate
        pluggable reclaim / per-function memory restore with the *config's*
        policy and memory requirements re-applied — the snapshot is
        authoritative when it carries that state, the config is when it
        does not (a legacy restore must not silently disable memory
        admission or swap the requested policy for the fixed default).
        """
        if "manager" in blob:
            mgr_blob = blob["manager"]
            self.resolver = ShardResolver.restore(blob["registry"])
        else:  # legacy pre-sharding snapshot: single-shard registry
            mgr_blob = blob
            self.resolver = ShardResolver(
                RegistrySpec.resolve(
                    None,
                    egress_cap=self.cfg.registry_out_cap,
                    qps=self.cfg.registry_qps,
                )
            )
        self.mgr = FTManager.restore(
            mgr_blob,
            vm_idle_reclaim_s=self.cfg.idle_reclaim_s,
            ft_aware_placement=self.cfg.ft_aware_placement,
            # honored only when the snapshot lacks a recorded policy
            reclaim=self.cfg.reclaim_policy(),
        )
        if "function_mem" not in mgr_blob:  # pre-memory snapshot
            for t in self.cfg.tenants:
                self.mgr.set_function_mem(t.function_id, t.mem_mb)
            # re-charge already-placed instances at today's requirements so
            # admission accounting resumes (legacy runs were exclusive —
            # one function per VM — so the budget can never be exceeded)
            for vm in self.mgr.vms.values():
                for fid in vm.functions:
                    if fid not in vm.func_mem_mb:
                        need = self.mgr.mem_need(fid)
                        vm.func_mem_mb[fid] = need
                        vm.mem_used_mb += need
        # Serving snapshots (version 3) carry the parked request queues;
        # a legacy snapshot restored into a serving replay keeps the live
        # queues (nothing recorded, nothing to overwrite).
        if "serving" in blob:
            queues = blob["serving"]["queues"]
            for ts in self.tenants:
                ts.queue = deque(queues.get(ts.cfg.function_id, []))
        # The block cache is data-plane state: it never crossed the wire,
        # but the restored manager needs the scorer re-attached.
        if self.block_cache is not None:
            self.mgr.set_content_affinity(
                self._image_affinity, candidates=self.block_cache.vms
            )

    def _failover(self) -> None:
        """Kill the scheduler: serialize, discard, restore from the wire copy.

        The FlowSim (data plane) keeps running — in production the in-flight
        image streams do not care which scheduler shard owns the metadata.
        Only the control plane (trees, pool, counters, shard map) crosses
        the wire.
        """
        blob = json.dumps(self.snapshot(), sort_keys=True)
        if self.cfg.serving is not None:
            # The parked herd dies with the failed scheduler: only the wire
            # copy can bring the queues back (proves the snapshot complete).
            for ts in self.tenants:
                ts.queue.clear()
        self.restore_snapshot(json.loads(blob))
        self.failovers += 1

    # ------------------------------------------------------------------
    # Provisioning (same per-system behaviour as workload.TraceReplay)
    # ------------------------------------------------------------------
    def _provision(self, ts: _TenantState, vm_id: str, now: float) -> None:
        cfg, w = self.cfg, self.cfg.wave
        fid = ts.cfg.function_id
        if cfg.images is not None:
            self._provision_blocks(ts, vm_id, now, cfg.images[fid])
            return
        payload = int(w.image_bytes * w.startup_fraction)
        control = w.rpc.control_plane_total()
        if cfg.system == "faasnet":
            upstream = self.mgr.insert(fid, vm_id, now)
            src = (
                upstream
                if upstream is not None
                else self.resolver.source_for(fid, nbytes=payload)
            )
            streaming = True
        elif cfg.system in ("baseline", "on_demand"):
            if cfg.system == "baseline":
                payload = w.image_bytes
            src = self.resolver.source_for(fid, nbytes=payload)
            streaming = cfg.system == "on_demand"
            # keep the FT for height reporting + pool-partition parity
            self.mgr.insert(fid, vm_id, now)
        else:
            raise ValueError(cfg.system)
        plan = DistributionPlan(
            flows=[Flow(src, vm_id, fid, payload)],
            control_latency={vm_id: control},
            streaming=streaming,
        )
        ts.provisioning[vm_id] = now
        ts.first_req_t = min(ts.first_req_t, now)

        def on_done(vm: str, t: float) -> None:
            extract = (
                w.image_bytes / w.image_extract_rate
                if cfg.system == "baseline"
                else w.rpc.image_load
            )
            ready = t + extract + w.container_start
            self.sim.schedule(ready, lambda: self._activate(ts, vm, ready))

        states = self.sim.add_plan(plan, t0=now, on_node_done=on_done)
        if streaming and not is_registry_node(src) and src in ts.flow_of:
            up = ts.flow_of[src]
            if not up.done:  # type: ignore[attr-defined]
                self.sim.set_parent(states[0], up)  # type: ignore[arg-type]
        ts.flow_of[vm_id] = states[0]

    def _provision_blocks(
        self, ts: _TenantState, vm_id: str, now: float, img
    ) -> None:
        """Block-granular provisioning: per-layer flows, runnable-driven start.

        The instance activates once the boot working set lands (§3.2); full
        materialization continues in the background and is recorded in the
        shared :class:`~repro_torch.core.image.BlockCache`, where later waves of
        ANY tenant sharing the base layers skip the resident blocks.  The
        VM's cache is evicted when the VM returns to the free pool.
        """
        cfg, w = self.cfg, self.cfg.wave
        fid = ts.cfg.function_id
        cache = self.block_cache
        control = w.rpc.control_plane_total()
        upstream = None
        if cfg.system == "faasnet":
            upstream = self.mgr.insert(fid, vm_id, now)
            streaming = True
        elif cfg.system in ("baseline", "on_demand"):
            streaming = cfg.system == "on_demand"
            # keep the FT for height reporting + pool-partition parity
            self.mgr.insert(fid, vm_id, now)
        else:
            raise ValueError(cfg.system)
        flows: list[Flow] = []
        for la in img.layers:
            if cfg.system == "baseline":
                # docker's layer cache is all-or-nothing; a container cannot
                # start before the full pull
                if cache.resident_blocks(vm_id, la.digest) >= img.layer_blocks(
                    la.digest
                ):
                    continue
                need, boot = la.size, la.size
            else:
                need, boot = cache.missing_layer_bytes(vm_id, img, la.digest)
                if need <= 0:
                    continue
            src = (
                upstream
                if upstream is not None
                else self.resolver.source_for(la.digest, nbytes=need)
            )
            flows.append(Flow(src, vm_id, la.digest, need, runnable_bytes=boot))
        if not flows:
            # fully cached: zero-byte marker so the milestones still fire
            src = (
                upstream
                if upstream is not None
                else self.resolver.source_for(img.name, nbytes=0)
            )
            flows.append(Flow(src, vm_id, f"{img.name}:cached", 0))
        plan = DistributionPlan(
            flows=flows, control_latency={vm_id: control}, streaming=streaming
        )
        ts.provisioning[vm_id] = now
        ts.first_req_t = min(ts.first_req_t, now)
        extract = (
            img.total_bytes() / w.image_extract_rate
            if cfg.system == "baseline"
            else w.rpc.image_load
        )
        pending = len(plan.flows)

        def on_runnable(vm: str, t: float) -> None:
            ready = t + extract + w.container_start
            self.sim.schedule(ready, lambda: self._activate(ts, vm, ready))

        def on_done(vm: str, t: float) -> None:
            nonlocal pending
            pending -= 1
            # last layer landed: the whole image is resident.  Skip the
            # cache write if the instance was reclaimed before the stream
            # finished — eviction wins over a straggling materialization.
            if pending == 0 and (vm in ts.instances or vm in ts.provisioning):
                cache.add_image(vm, img)

        states = self.sim.add_plan(
            plan, t0=now, on_node_done=on_done, on_node_runnable=on_runnable
        )
        if streaming and upstream is not None:
            ups = ts.block_flow_of.get(upstream)
            if ups:
                for st in states:
                    up = ups.get(st.flow.piece)
                    if up is not None and not up.done:  # type: ignore[attr-defined]
                        self.sim.set_parent(st, up)  # type: ignore[arg-type]
        ts.block_flow_of[vm_id] = {st.flow.piece: st for st in states}

    def _activate(self, ts: _TenantState, vm_id: str, now: float) -> None:
        t_req = ts.provisioning.pop(vm_id, now)
        ts.prov_latencies.append(now - t_req)
        ts.last_ready_t = max(ts.last_ready_t, now)
        ts.instances[vm_id] = _Instance(
            vm_id, busy_until=now, idle_since=now, prov_cost_s=now - t_req
        )
        sv = self.cfg.serving
        if sv is not None and sv.herd_control:
            # one container of the function's in-flight wave landed; when
            # the whole wave is down the lock lifts and scale-out may resume
            self.mgr.wave_landed(ts.cfg.function_id)

    def _reclaim(self, ts: _TenantState, now: float) -> None:
        """Ask the manager's ReclaimPolicy about every idle instance.

        Accounting goes through :meth:`FTManager.reclaim_instance` — the
        same path ``FTManager.reclaim_idle`` uses — so the ``reclaims``
        counter (and the release-when-empty rule of the shared pool) cannot
        drift between the replay and the manager's own reclaim loop.
        """
        fid = ts.cfg.function_id
        policy = self.mgr.reclaim
        for vm_id, inst in list(ts.instances.items()):
            if inst.busy_until <= now and policy.should_reclaim(
                fid, now - inst.idle_since, now
            ):
                if (
                    self.cfg.serving is not None
                    and inst.busy_total_s < inst.prov_cost_s
                ):
                    # economically wasted: the instance never served enough
                    # to pay back the provisioning latency it cost
                    ts.wasted += 1
                del ts.instances[vm_id]
                ts.flow_of.pop(vm_id, None)
                ts.block_flow_of.pop(vm_id, None)
                released = self.mgr.reclaim_instance(fid, vm_id)
                if released and self.block_cache is not None:
                    # the VM returned to the free pool: its block cache
                    # (every tenant's layers) goes with it
                    self.block_cache.evict(vm_id)

    # ------------------------------------------------------------------
    def _step_tenant(self, ts: _TenantState, t: int, now: float) -> None:
        if self.cfg.serving is not None:
            self._step_tenant_serving(ts, t, now)
            return
        tc = ts.cfg
        rps = tc.trace[t] if t < len(tc.trace) else 0.0
        dur = tc.function_duration_s
        n_arr = arrivals_for_second(rps, t, tc.seed)
        ts.requests += n_arr
        for _ in range(n_arr):
            ts.queue.append(now)
        completed = 0
        lat_samples: list[float] = []
        fid = tc.function_id
        for inst in ts.instances.values():
            if not ts.queue:
                break
            if inst.busy_until <= now:
                arrival = ts.queue.popleft()
                resp = (now - arrival) + dur
                # a *reused* instance was idle (now - idle_since): predictive
                # reclaim policies learn from this gap.  The first-ever
                # dispatch after a cold start is provisioning slack, not a
                # reuse gap — feeding it to the histogram would teach a
                # bogus ~0 s keep-alive to every freshly provisioned fn.
                if inst.served:
                    self.mgr.reclaim.observe_gap(fid, now - inst.idle_since)
                inst.served = True
                self.mgr.touch_instance(fid, inst.vm_id, now)
                inst.busy_until = now + dur
                inst.idle_since = now + dur
                ts.responses.append((now + dur, resp))
                lat_samples.append(resp)
                completed += 1
        # scale out against the *shared* pool (see workload.TraceReplay.run)
        deficit = (
            len(ts.queue)
            - sum(1 for i in ts.instances.values() if i.busy_until <= now)
            - len(ts.provisioning)
        )
        target = int(tc.vm_target_factor * max(rps, n_arr) * dur) + 1
        headroom = target - (len(ts.instances) + len(ts.provisioning))
        deficit = min(deficit, max(0, headroom))
        shared = self.cfg.placement == "shared"
        for _ in range(min(max(0, deficit), tc.max_reserve_per_tick)):
            # Shared pool: co-locate onto a warm VM with memory headroom
            # (pick_vm_for falls back to reserving a free VM); exclusive
            # leasing always takes a fresh VM.
            vm = self.mgr.pick_vm_for(fid, now) if shared else self.mgr.reserve_vm(now)
            if vm is None:
                break  # pool exhausted and no co-location headroom: wait
            self._provision(ts, vm.vm_id, now)
        self._reclaim(ts, now)
        ts.peak_vms = max(ts.peak_vms, len(ts.instances) + len(ts.provisioning))
        ft = self.mgr.trees.get(tc.function_id)
        lat_samples.sort()
        ts.timeline.append(
            TickStats(
                t=t,
                rps=rps,
                arrivals=n_arr,
                completed=completed,
                mean_response_s=(
                    sum(lat_samples) / len(lat_samples) if lat_samples else 0.0
                ),
                p99_response_s=_pctl(lat_samples, 0.99),
                active_vms=len(ts.instances) + len(ts.provisioning),
                provisioning_vms=len(ts.provisioning),
                ft_height=ft.height if ft is not None else 0,
            )
        )

    # ------------------------------------------------------------------
    # Request-level serving (ServingConfig attached): sub-tick dispatch,
    # per-VM CPU slots and cold-start herd control.
    # ------------------------------------------------------------------
    def _step_tenant_serving(self, ts: _TenantState, t: int, now: float) -> None:
        tc, sv = ts.cfg, self.cfg.serving
        assert sv is not None
        rps = tc.trace[t] if t < len(tc.trace) else 0.0
        n_arr = arrivals_for_second(rps, t, tc.seed)
        ts.requests += n_arr
        # Arrivals are stamped inside the second (sorted offsets keep the
        # FIFO queue globally ordered by arrival time).
        for off in arrival_offsets(n_arr, t, tc.seed):
            ts.queue.append(now + off)
        ts.arrival_window.append(n_arr)
        while len(ts.arrival_window) > sv.rate_window_s:
            ts.arrival_window.popleft()
        # Requests dispatched in earlier ticks whose service finished by now
        # leave the in-flight set (conservation: completed + in_flight +
        # queued == requests, asserted by _check_partition).
        while ts.in_flight and ts.in_flight[0] <= now:
            heapq.heappop(ts.in_flight)
            ts.completed_done += 1
        completed, lat_samples = self._drain_queue(ts, now)
        self._scale_out_serving(ts, t, now, rps, n_arr)
        self._reclaim(ts, now)
        ts.peak_vms = max(ts.peak_vms, len(ts.instances) + len(ts.provisioning))
        ft = self.mgr.trees.get(tc.function_id)
        lat_samples.sort()
        ts.timeline.append(
            TickStats(
                t=t,
                rps=rps,
                arrivals=n_arr,
                completed=completed,
                mean_response_s=(
                    sum(lat_samples) / len(lat_samples) if lat_samples else 0.0
                ),
                p99_response_s=_pctl(lat_samples, 0.99),
                active_vms=len(ts.instances) + len(ts.provisioning),
                provisioning_vms=len(ts.provisioning),
                ft_height=ft.height if ft is not None else 0,
            )
        )

    def _drain_queue(self, ts: _TenantState, now: float) -> tuple[int, list[float]]:
        """FIFO-dispatch queued requests against instance *free times*.

        Each instance serves one request at a time; the earliest-free
        instance takes the head of the queue at ``start = max(arrival,
        free)`` (a start inside the previous second is a request the
        scheduler would have dispatched between ticks — the discrete replay
        settles it here, retroactively but deterministically).  Service
        time stretches by the hosting VM's CPU-slot contention: ``k``
        requests already running on the VM (across ALL tenants) at start
        time make the new one take ``dur * max(1, (k+1)/cpu_slots)``.
        Dispatch stops at the tick horizon — an instance not free before
        ``now + 1`` parks the rest of the queue for the next tick.
        """
        sv = self.cfg.serving
        assert sv is not None
        tc = ts.cfg
        fid, dur = tc.function_id, tc.function_duration_s
        if not ts.instances or not ts.queue:
            return 0, []
        horizon = now + 1.0
        # (free_time, insertion_order, vm_id): insertion order breaks ties
        # deterministically and matches the legacy scan order.
        heap: list[tuple[float, int, str]] = [
            (inst.busy_until, i, vm_id)
            for i, (vm_id, inst) in enumerate(ts.instances.items())
        ]
        heapq.heapify(heap)
        completed = 0
        stretch_sum = 0.0
        lat_samples: list[float] = []
        while ts.queue:
            free, order, vm_id = heap[0]
            if free >= horizon:
                break  # nobody frees up inside this tick: herd stays parked
            arrival = ts.queue.popleft()
            start = max(arrival, free)
            busy = self._vm_busy.setdefault(vm_id, [])
            # lazily prune requests that finished before this start
            if busy:
                busy[:] = [f for f in busy if f > start]
            stretch = max(1.0, (len(busy) + 1) / sv.cpu_slots)
            finish = start + dur * stretch
            busy.append(finish)
            inst = ts.instances[vm_id]
            if inst.served:
                # reuse gap for predictive reclaim (same gating as legacy:
                # the first post-cold-start dispatch is provisioning slack)
                self.mgr.reclaim.observe_gap(
                    fid, max(0.0, start - inst.idle_since)
                )
            inst.served = True
            self.mgr.touch_instance(fid, vm_id, start)
            inst.busy_until = finish
            inst.idle_since = finish
            inst.busy_total_s += finish - start
            ts.responses.append((finish, finish - arrival))
            ts.dispatch_log.append((arrival, start))
            heapq.heappush(ts.in_flight, finish)
            lat_samples.append(finish - arrival)
            completed += 1
            stretch_sum += stretch
            heapq.heapreplace(heap, (finish, order, vm_id))
        if completed:
            # Feed the observed contention back to the admission gate: wave
            # sizing uses the *effective* service time (nominal duration x
            # median observed stretch), so a tenant squeezed by a
            # neighbour's burst provisions its way back to stability.
            ts.stretch_window.append(stretch_sum / completed)
            while len(ts.stretch_window) > sv.rate_window_s:
                ts.stretch_window.popleft()
        return completed, lat_samples

    def _scale_out_serving(
        self, ts: _TenantState, t: int, now: float, rps: float, n_arr: int
    ) -> None:
        """Admission gate: wave-sized scale-out under the in-flight-wave lock.

        ``herd_control=False`` reproduces the pre-serving scheduler's naive
        one-reservation-per-deficit-unit rule verbatim (the bench baseline).
        With herd control, a cold function hit by a 10k-request burst issues
        exactly ONE provisioning wave: while the wave is in flight
        (:meth:`FTManager.wave_active`) no further reservations happen — the
        herd parks in the FIFO queue and drains as containers land.  The
        wave is sized for the *median* arrival rate over the trailing
        window (spike-immune) plus enough instances to drain the current
        backlog within ``drain_budget_s``, capped by the contention-adjusted
        target (legacy target scaled by the median observed CPU stretch).
        """
        tc, sv = ts.cfg, self.cfg.serving
        assert sv is not None
        fid, dur = tc.function_id, tc.function_duration_s
        shared = self.cfg.placement == "shared"
        target = int(tc.vm_target_factor * max(rps, n_arr) * dur) + 1
        if not sv.herd_control:
            deficit = (
                len(ts.queue)
                - sum(1 for i in ts.instances.values() if i.busy_until <= now)
                - len(ts.provisioning)
            )
            headroom = target - (len(ts.instances) + len(ts.provisioning))
            deficit = min(deficit, max(0, headroom))
            for _ in range(min(max(0, deficit), tc.max_reserve_per_tick)):
                vm = (
                    self.mgr.pick_vm_for(fid, now)
                    if shared
                    else self.mgr.reserve_vm(now)
                )
                if vm is None:
                    break
                self._provision(ts, vm.vm_id, now)
            return
        if self.mgr.wave_active(fid):
            return  # one wave at a time: the herd stays parked
        window = sorted(ts.arrival_window)
        median = float(window[len(window) // 2]) if window else 0.0
        # Size by the effective service time: co-located busy instances
        # stretch execution, so nominal-duration capacity math undershoots
        # exactly when a neighbouring tenant bursts onto shared VMs.  The
        # median observed per-tick stretch (1.0 when nothing has been
        # dispatched yet — a cold burst sizes its one wave unstretched)
        # scales sustain, backlog AND the target cap; without the last one
        # the legacy cap would pin a squeezed tenant below offered load
        # forever.
        sw = sorted(ts.stretch_window)
        eff_dur = dur * (sw[len(sw) // 2] if sw else 1.0)
        sustain = (
            int(tc.vm_target_factor * median * eff_dur) + 1 if median > 0 else 0
        )
        backlog = math.ceil(len(ts.queue) * eff_dur / sv.drain_budget_s)
        desired = min(
            max(sustain, backlog),
            int(tc.vm_target_factor * max(rps, n_arr) * eff_dur) + 1,
        )
        current = len(ts.instances) + len(ts.provisioning)
        issued = 0
        for _ in range(max(0, desired - current)):
            vm = (
                self.mgr.pick_vm_for(fid, now)
                if shared
                else self.mgr.reserve_vm(now)
            )
            if vm is None:
                break  # pool exhausted: the wave is what we could get
            self._provision(ts, vm.vm_id, now)
            issued += 1
        if issued:
            self.mgr.wave_open(fid, issued)

    def _check_partition(self) -> None:
        """Per-tick pool invariant (mode-dispatched).

        Exclusive mode: free_pool + per-tenant {warm, provisioning} sets
        partition the VM pool (legacy leasing — a VM belongs to at most one
        tenant).  Shared mode: tenants may overlap on a VM, so the
        invariant becomes memory-fit + occupancy consistency — see
        :meth:`check_shared_invariants`.
        """
        free = list(self.mgr.free_pool)
        free_set = set(free)
        if len(free) != len(free_set):
            raise AssertionError("duplicate vm ids in free_pool")
        owned: set[str] = set()
        for ts in self.tenants:
            mine = set(ts.instances) | set(ts.provisioning)
            if self.cfg.placement == "exclusive":
                overlap = mine & owned
                if overlap:
                    raise AssertionError(
                        f"vm owned by two tenants: {sorted(overlap)}"
                    )
            ft = self.mgr.trees.get(ts.cfg.function_id)
            members = set(ft.vm_ids()) if ft is not None else set()
            if members != mine:
                raise AssertionError(
                    f"{ts.cfg.function_id}: tree/{{warm,provisioning}} mismatch: "
                    f"tree-only={sorted(members - mine)} "
                    f"tenant-only={sorted(mine - members)}"
                )
            owned |= mine
        leak = owned & free_set
        if leak:
            raise AssertionError(f"vm both free and tenant-owned: {sorted(leak)}")
        missing = set(self.mgr.vms) - owned - free_set
        if missing:
            raise AssertionError(f"vm lost (neither free nor owned): {sorted(missing)}")
        if self.cfg.placement == "shared":
            self.check_shared_invariants()
        if self.cfg.serving is not None:
            self._check_conservation()

    def _check_conservation(self) -> None:
        """Serving-mode request conservation (per tenant, every tick).

        Every request ever admitted is exactly one of: dispatched (it has a
        response record) or still queued — and every dispatched request is
        either done or in flight.  A dropped or double-counted request
        breaks one of the two equalities.
        """
        for ts in self.tenants:
            fid = ts.cfg.function_id
            if ts.requests != len(ts.responses) + len(ts.queue):
                raise AssertionError(
                    f"{fid}: requests={ts.requests} != dispatched="
                    f"{len(ts.responses)} + queued={len(ts.queue)}"
                )
            if ts.completed_done + len(ts.in_flight) != len(ts.responses):
                raise AssertionError(
                    f"{fid}: completed={ts.completed_done} + in_flight="
                    f"{len(ts.in_flight)} != dispatched={len(ts.responses)}"
                )

    def check_shared_invariants(self) -> None:
        """Shared-pool invariant: memory fits and occupancy is consistent.

        For every VM: the charged per-function memory sums to
        ``mem_used_mb`` and fits the budget; the manager's per-VM function
        set, the per-function trees and the replay's instance/provisioning
        maps all name exactly the same occupancy.  A VM holding instances
        must not sit in the free pool.
        """
        mgr = self.mgr
        # replay-side occupancy: fid -> vms (instances ∪ provisioning)
        replay_occ: dict[str, set[str]] = {
            ts.cfg.function_id: set(ts.instances) | set(ts.provisioning)
            for ts in self.tenants
        }
        vm_occ: dict[str, set[str]] = {}  # vm -> fids per the replay
        for fid, vms in replay_occ.items():
            for v in vms:
                vm_occ.setdefault(v, set()).add(fid)
        for vm in mgr.vms.values():
            if set(vm.func_mem_mb) != vm.functions:
                raise AssertionError(
                    f"{vm.vm_id}: charged-memory keys {sorted(vm.func_mem_mb)} "
                    f"!= functions {sorted(vm.functions)}"
                )
            if vm.mem_used_mb != sum(vm.func_mem_mb.values()):
                raise AssertionError(
                    f"{vm.vm_id}: mem_used_mb={vm.mem_used_mb} drifted from "
                    f"Σ charges {sum(vm.func_mem_mb.values())}"
                )
            if vm.mem_used_mb > vm.mem_mb:
                raise AssertionError(
                    f"{vm.vm_id}: {vm.mem_used_mb} MB placed on a "
                    f"{vm.mem_mb} MB VM"
                )
            for fid, charged in vm.func_mem_mb.items():
                if charged != mgr.mem_need(fid):
                    raise AssertionError(
                        f"{vm.vm_id}/{fid}: charged {charged} MB, "
                        f"requirement is {mgr.mem_need(fid)} MB"
                    )
            if vm.functions != vm_occ.get(vm.vm_id, set()):
                raise AssertionError(
                    f"{vm.vm_id}: manager hosts {sorted(vm.functions)}, replay "
                    f"has {sorted(vm_occ.get(vm.vm_id, set()))}"
                )

    # ------------------------------------------------------------------
    def run(self) -> MultiTenantResult:
        cfg = self.cfg
        for t in range(cfg.duration_s()):
            now = float(t)
            if cfg.failover_at is not None and t == cfg.failover_at:
                self._failover()
            self.sim.run(until=now)  # advance flows/activations to this tick
            for ts in self.tenants:  # fixed registration order: deterministic
                self._step_tenant(ts, t, now)
            # VM-hours: one second per VM currently out of the free pool
            self.vm_seconds += float(cfg.vm_pool_size - len(self.mgr.free_pool))
            if cfg.check_partition:
                self._check_partition()
        return self._result()

    def _result(self) -> MultiTenantResult:
        per_tenant: dict[str, TenantResult] = {}
        first_req = float("inf")
        last_ready = float("-inf")
        total_prov = 0.0
        for ts in self.tenants:
            resp = sorted(lat for _, lat in ts.responses)
            prov = sorted(ts.prov_latencies)
            total_prov += sum(prov)
            first_req = min(first_req, ts.first_req_t)
            last_ready = max(last_ready, ts.last_ready_t)
            per_tenant[ts.cfg.function_id] = TenantResult(
                function_id=ts.cfg.function_id,
                requests=ts.requests,
                completed=len(resp),
                mean_response_s=sum(resp) / len(resp) if resp else 0.0,
                p99_response_s=_pctl(resp, 0.99),
                mean_prov_s=sum(prov) / len(prov) if prov else 0.0,
                p99_prov_s=_pctl(prov, 0.99),
                prov_makespan_s=(
                    ts.last_ready_t - ts.first_req_t if prov else 0.0
                ),
                peak_vms=ts.peak_vms,
                provisioned=len(prov),
                p50_response_s=_pctl(resp, 0.50),
                wasted_provisions=ts.wasted
                + (
                    sum(
                        1
                        for i in ts.instances.values()
                        if i.busy_total_s < i.prov_cost_s
                    )
                    if self.cfg.serving is not None
                    else 0
                ),
            )
        return MultiTenantResult(
            system=self.cfg.system,
            per_tenant=per_tenant,
            timelines={ts.cfg.function_id: ts.timeline for ts in self.tenants},
            peak_registry_egress=self.sim.peak_registry_egress,
            peak_shard_egress=dict(self.sim.peak_shard_egress),
            prov_makespan_s=(
                last_ready - first_req if last_ready > float("-inf") else 0.0
            ),
            total_prov_time_s=total_prov,
            failovers=self.failovers,
            manager_stats=dict(self.mgr.stats),
            free_vms=len(self.mgr.free_pool),
            vm_seconds=self.vm_seconds,
            cold_starts=sum(len(ts.prov_latencies) for ts in self.tenants),
            peak_nic_utilization=self.sim.peak_nic_utilization,
        )


def run_multi_tenant(cfg: MultiTenantConfig) -> MultiTenantResult:
    """One-shot convenience wrapper (mirrors ``repro_torch.sim.scale.run_scale``)."""
    return MultiTenantReplay(cfg).run()
