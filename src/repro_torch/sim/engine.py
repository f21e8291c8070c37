"""Deterministic discrete-event fluid-flow network simulator.

Models a pool of VMs (full-duplex NICs with separate in/out capacity), a
sharded registry (N capped-egress, QPS-throttled sources — see
:class:`repro_torch.core.registry.RegistrySpec`), and a set of data flows produced
by a :class:`repro_torch.core.topology.DistributionPlan`.  Used to time provisioning
waves for FaaSNet and the paper's comparison systems, to replay the
application-level traces (Figures 11-18), and — via ``repro_torch.sim.scale`` —
to reproduce the paper's §4.2 1000-VM burst at full size.

Rate model (documented approximation)
-------------------------------------
At any instant, an active flow's rate is

    rate(f) = min( per_stream_cap,
                   src_out_cap / #active flows leaving src,
                   dst_in_cap  / #active flows entering dst,
                   rate(parent flow)  if f streams behind a parent )

i.e. equal split at each NIC without redistribution of unused shares.  For
tree topologies every NIC carries ≤1 inbound and ≤2 outbound flows, so the
split is exact; for registry-centric baselines all flows are symmetric so it
is exact as well; for the Kraken all-to-all mesh it is mildly pessimistic,
which matches the paper's qualitative finding.  Streaming children start one
block-time after their parent and are rate-capped by the parent's inbound
rate, which bounds the approximation error at ≤ one block-time per hop.

Incremental-rate engine
-----------------------
Under equal split, ``rate(f)`` depends only on (a) the *count* of active
flows on f's source and destination NICs and (b) the parent flow's rate.  So
when a flow starts or completes, only the flows sharing one of its two NICs
— plus, transitively, their streaming descendants — can change rate.  The
engine keeps per-NIC active-flow registries and a completion heap with
lazily-invalidated entries (per-flow epoch counters); each event settles and
re-rates just that dirty closure instead of every active flow, and batches
all same-timestamp completions into a single settle pass.  ``remaining``
bytes are settled lazily (per-flow ``t_last``), and each flow's streaming
depth is cached on its state (maintained by ``set_parent``, which also
refreshes the downstream chain) rather than re-derived by walking parent
chains, so an event costs O(degree · log F) instead of O(F), turning the
previously quadratic run into an ~O(F log F) one.

Determinism: events are (time, seq) ordered and every internal registry is
keyed by a densely-assigned flow id (``fid``), so iteration order — and
therefore the event log — is bit-reproducible across runs.  The original
full-recompute engine survives as :class:`repro_torch.sim.reference.ReferenceFlowSim`
and the two are differential-tested in ``tests/test_torch_reference.py``.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core.registry import GBPS, RegistrySpec, is_registry_node, shard_index
from repro_torch.core.topology import DistributionPlan, Flow

__all__ = [
    "GBPS",  # canonical home of the shared bytes/s constant
    "ENGINES",
    "NICConfig",
    "SimConfig",
    "FlowSim",
    "make_sim",
    "plan_releases",
    "wire_runnable",
]

#: Engine backends selectable via :attr:`SimConfig.engine`.  They form an
#: oracle chain — ``reference`` (full recompute, trivially correct) polices
#: ``incremental`` (per-NIC dirty sets), which polices ``vector`` (flat
#: numpy arrays, wide-front recompute), which in turn polices
#: ``vector_torch`` (the same engine with the CUDA cap-chain kernel from
#: ``repro_torch.kernels.cap_chain`` on its wide fronts) — all
#: differential-tested to produce bit-identical event logs and rates within
#: 1e-9 (``tests/test_torch_vector_engine.py``,
#: ``tests/test_torch_reference.py``).
ENGINES = ("incremental", "vector", "vector_torch", "reference")


@dataclass
class NICConfig:
    in_cap: float = 1.0 * GBPS
    out_cap: float = 1.0 * GBPS


@dataclass
class SimConfig:
    vm_nic: NICConfig = field(default_factory=NICConfig)
    registry_out_cap: float = 5.0 * GBPS  # calibrated to paper §4.3 baselines
    per_stream_cap: float = float("inf")  # app-level throughput cap per stream
    block_size: int = 512 * 1024
    hop_latency: float = 0.0  # store-and-forward + decompress cost per tree hop
    coordinator_cost_s: float = 0.008  # CPU time a root/origin burns per request
    decompress_rate: float = 2e9  # bytes/s; >> network, so rarely binding
    # Registry request throttling (paper §4.3: "image pulls are throttled at
    # the registry").  Block-granular fetchers issue one range request per
    # block; each registry shard serves at most ``qps`` such requests/s,
    # which caps that shard's block-mode egress at block_size * qps shared
    # across the streams currently hitting it.
    registry_qps: float = float("inf")
    # Sharded registry.  ``None`` builds a 1-shard spec from the two legacy
    # knobs above, which keeps every pre-sharding configuration bit-exact;
    # a multi-shard spec makes each shard an independent capped source.
    registry: Optional[RegistrySpec] = None
    # Engine backend: "vector_torch" (default; the vector engine with its
    # wide fronts on ``device``), "vector" (flat numpy arrays, the 100k-VM
    # backend), "incremental" or "reference" (full-recompute oracle).  All
    # produce identical results; see ``make_sim``.
    engine: str = "vector_torch"
    # Large fleets can drop the per-event text log (the giga-burst tier
    # would otherwise materialize millions of trace tuples).
    record_trace: bool = True
    # Vector engine only: fronts at or below this width run the scalar
    # fast path (~40 fixed-cost numpy dispatches cost more than a handful
    # of Python-float min chains); wider fronts take the vectorized path.
    # Both paths are bit-identical, so this is purely a performance knob.
    vector_scalar_cutoff: int = 64
    # "vector_torch" only: the torch device its cap-chain kernel runs on.
    # "cuda" launches the CUDA kernel; "cpu" runs its plain PyTorch version.
    device: str = "cuda"

    def registry_spec(self) -> RegistrySpec:
        """The effective spec (legacy knobs become a 1-shard registry)."""
        return RegistrySpec.resolve(
            self.registry, egress_cap=self.registry_out_cap, qps=self.registry_qps
        )


def plan_releases(
    plan: DistributionPlan,
    cfg: SimConfig,
    t0: float,
    coordinator_queues: dict[str, float],
) -> list[tuple[Flow, float, bool]]:
    """Shared plan → flow-schedule lowering used by every engine backend.

    For each flow of ``plan`` compute its control-plane release time (plan
    control latency plus, where a coordinator is named, serialization on
    that coordinator's CPU queue — mutated in ``coordinator_queues`` so the
    queue carries across plans) and whether it fetches block-granular from
    the registry (``block_mode``).  Returns ``(flow, release, block_mode)``
    in plan order.  Extracted from the per-engine ``add_plan`` bodies so the
    three backends cannot drift on release semantics.
    """
    out: list[tuple[Flow, float, bool]] = []
    for fl in plan.flows:
        release = t0 + plan.control_latency.get(fl.dst, 0.0)
        # Coordinator serialization: each request queues on the root's CPU.
        coord = plan.coordinator.get(fl.dst)
        if coord is not None:
            q = max(coordinator_queues.get(coord, t0), release)
            release = q + cfg.coordinator_cost_s
            coordinator_queues[coord] = release
        out.append((fl, release, plan.streaming and is_registry_node(fl.src)))
    return out


def wire_runnable(sim, states, on_node_runnable) -> None:
    """Attach runnable-prefix milestones to one wave's flow states (§3.2).

    For every dst with flows carrying a runnable prefix (``runnable_bytes``
    > 0), fire ``on_node_runnable(dst, t)`` the moment the *last* of those
    prefixes lands — ahead of full arrival.  A dst whose flows carry no
    prefix (boot working set fully cached, or only zero-byte marker flows)
    is runnable at its control-plane release and gets a scheduled event
    instead.  Shared by all three engine backends, called at the same point
    of each ``add_plan`` so event ordering cannot drift between them.
    """
    if on_node_runnable is None:
        return
    pending: dict[str, int] = {}
    for st in states:
        nb = min(int(st.flow.runnable_bytes), int(st.flow.bytes))
        if nb > 0:
            st.notify_bytes = float(nb)
            pending[st.flow.dst] = pending.get(st.flow.dst, 0) + 1

    def landed(t: float, dst: str) -> None:
        pending[dst] -= 1
        if pending[dst] == 0:
            on_node_runnable(dst, t)

    release: dict[str, float] = {}
    for st in states:
        dst = st.flow.dst
        if st.notify_bytes > 0.0:
            st.on_notify = lambda t, dst=dst: landed(t, dst)
        r = release.get(dst)
        release[dst] = st.start_after if r is None else min(r, st.start_after)
    for dst, t_rel in release.items():
        if dst not in pending:
            sim.schedule(t_rel, lambda dst=dst: on_node_runnable(dst, sim.now))


def make_sim(cfg: SimConfig | None = None, *, record_rates: bool = False):
    """Build the flow simulator selected by ``cfg.engine``.

    The default ("vector_torch") is
    :class:`~repro_torch.sim.vector_engine.VectorTorchFlowSim`, the vector
    engine with the cap-chain kernel on its wide fronts, on ``cfg.device``;
    "vector" selects the array-based
    :class:`repro_torch.sim.vector_engine.VectorFlowSim` it subclasses and
    "incremental" the per-event :class:`FlowSim` and "reference" the
    full-recompute oracle.  All backends share ``SimConfig`` and the public
    API, and produce identical results on the same inputs.
    """
    cfg = cfg or SimConfig()
    if cfg.engine == "incremental":
        return FlowSim(cfg, record_rates=record_rates)
    if cfg.engine == "vector":
        from .vector_engine import VectorFlowSim

        return VectorFlowSim(cfg, record_rates=record_rates)
    if cfg.engine == "vector_torch":
        from .vector_engine import VectorTorchFlowSim

        return VectorTorchFlowSim(cfg, record_rates=record_rates)
    if cfg.engine == "reference":
        from .reference import ReferenceFlowSim

        return ReferenceFlowSim(cfg, record_rates=record_rates)
    raise ValueError(
        f"unknown engine {cfg.engine!r}; expected one of {ENGINES}"
    )


@dataclass(eq=False)
class _FlowState:
    flow: Flow
    remaining: float
    total: float
    start_after: float  # control-plane release time
    parent: Optional["_FlowState"] = None  # streaming dependency
    started: bool = False
    done: bool = False
    t_start: float = math.inf
    t_done: float = math.inf
    rate: float = 0.0
    block_mode: bool = False  # block-granular range requests (registry-throttled)
    pipeline_delay: float = 0.0  # child start lag behind parent start
    on_done: Optional[Callable[[float], None]] = None
    # Runnable-prefix milestone (paper §3.2): once ``notify_bytes`` of this
    # flow have landed, ``on_notify`` fires (at most once) — the dst can boot
    # while the rest of the payload keeps materializing in the background.
    notify_bytes: float = 0.0
    notified: bool = False
    on_notify: Optional[Callable[[float], None]] = None
    fid: int = -1  # dense engine-assigned id; all registries key on it
    t_last: float = 0.0  # time ``remaining`` was last settled
    epoch: int = 0  # bumped on every rate change; stale heap entries skip
    depth: int = 0  # streaming depth (hops behind the chain head); cached,
    # maintained by FlowSim.set_parent — never walk the parent chain for it
    children: list["_FlowState"] = field(default_factory=list)
    waiters: list["_FlowState"] = field(default_factory=list)  # gated on our start


class FlowSim:
    """Simulate one or more distribution plans sharing the same network."""

    def __init__(self, cfg: SimConfig | None = None, *, record_rates: bool = False) -> None:
        self.cfg = cfg or SimConfig()
        self.registry = self.cfg.registry_spec()
        self.now = 0.0
        self._flows: list[_FlowState] = []  # index == fid
        self._events: list[tuple[float, int, Callable[[], None]]] = []
        self._seq = 0
        self._slow_out: dict[str, float] = {}  # vm_id -> out cap override
        self.trace: list[tuple[float, str]] = []  # (time, event) log
        # Incremental-rate state ------------------------------------------------
        self._out: dict[str, dict[int, _FlowState]] = {}  # node -> active out flows
        self._in: dict[str, dict[int, _FlowState]] = {}  # node -> active in flows
        self._done_heap: list[tuple[float, int, int]] = []  # (t_finish, fid, epoch)
        self._notify_heap: list[tuple[float, int, int]] = []  # (t_prefix, fid, epoch)
        self._n_active = 0  # started-and-not-done flows (heap compaction bound)
        self._pending_dirty: dict[int, _FlowState] = {}
        self._record_trace = self.cfg.record_trace
        # Telemetry -------------------------------------------------------------
        self.events_processed = 0
        self.record_rates = record_rates
        self.rate_log: list[tuple[float, int, float]] = []  # (t, fid, new_rate)
        # Per-shard registry egress accounting: running sums and peaks keyed
        # by canonical shard id, plus the aggregate (sum across shards) peak.
        self._reg_out: dict[str, float] = {}
        self.peak_shard_egress: dict[str, float] = {}
        self.peak_registry_egress = 0.0
        # Per-VM NIC accounting: running out/in rate sums per node and the
        # peak utilization (rate / capacity) any VM NIC reached — the shared
        # pool's co-location pressure metric (cross-tree flows on one host).
        self._vm_out: dict[str, float] = {}
        self._vm_in: dict[str, float] = {}
        self.peak_nic_utilization = 0.0

    # ------------------------------------------------------------------
    def _src_key(self, node: str) -> str:
        """NIC-registry key for a flow source: registry aliases collapse to
        their canonical shard id so the legacy ``__registry__`` sentinel and
        shard 0 contend for (and are accounted against) the same source."""
        if is_registry_node(node):
            return self.registry.canonical(node)
        return node

    # ------------------------------------------------------------------
    def set_slow_vm(self, vm_id: str, out_cap: float) -> None:
        """Straggler injection: clamp a VM's egress capacity."""
        self._slow_out[vm_id] = out_cap
        for f in self._out.get(vm_id, {}).values():
            self._pending_dirty[f.fid] = f

    def clear_slow_vm(self, vm_id: str) -> None:
        self._slow_out.pop(vm_id, None)
        for f in self._out.get(vm_id, {}).values():
            self._pending_dirty[f.fid] = f

    def schedule(self, t: float, fn: Callable[[], None]) -> None:
        self._seq += 1
        heapq.heappush(self._events, (t, self._seq, fn))

    def set_parent(self, st: _FlowState, parent: Optional[_FlowState]) -> None:
        """Attach a streaming dependency, keeping the child index consistent.

        Callers must use this (not ``st.parent = ...``) so that rate changes
        of the parent propagate to ``st`` through the incremental recompute.
        """
        if st.parent is not None:
            try:
                st.parent.children.remove(st)
            except ValueError:  # pragma: no cover - defensive
                pass
        st.parent = parent
        if parent is not None:
            parent.children.append(st)
        # Recompute the cached streaming depth for st and its descendants
        # (re-attachment moves the whole downstream chain).
        st.depth = parent.depth + 1 if parent is not None else 0
        stack = list(st.children)
        while stack:
            c = stack.pop()
            c.depth = c.parent.depth + 1
            stack.extend(c.children)
        if st.started and not st.done:
            # attaching mid-flight changes the parent-rate cap immediately
            self._pending_dirty[st.fid] = st

    # ------------------------------------------------------------------
    def add_plan(
        self,
        plan: DistributionPlan,
        *,
        t0: float = 0.0,
        on_node_done: Optional[Callable[[str, float], None]] = None,
        on_node_runnable: Optional[Callable[[str, float], None]] = None,
        coordinator_queues: Optional[dict[str, float]] = None,
    ) -> list[_FlowState]:
        """Register a provisioning wave starting at ``t0``.

        ``coordinator_queues`` carries serialization state for root/origin
        coordinators across plans (the Kraken-origin / DADI-root CPU queue).
        ``on_node_runnable`` fires per dst when its runnable block prefixes
        land (see :func:`wire_runnable`); with no prefix flows in the plan it
        is equivalent to firing at each dst's control release.
        """
        cfg = self.cfg
        coordinator_queues = coordinator_queues if coordinator_queues is not None else {}
        by_dst: dict[tuple[str, str], _FlowState] = {}
        states: list[_FlowState] = []
        for fl, release, block_mode in plan_releases(plan, cfg, t0, coordinator_queues):
            st = _FlowState(flow=fl, remaining=float(fl.bytes), total=float(fl.bytes),
                            start_after=release, block_mode=block_mode)
            states.append(st)
            # streaming dependency: dst of the parent flow == src of this
            # flow, matched per piece (multi-layer plans chain each layer's
            # stream to the parent's stream of the *same* layer; a parent
            # serving a layer from cache has no such flow → child unchained).
            by_dst.setdefault((fl.dst, fl.piece), st)
        if plan.streaming:
            block_t = cfg.block_size / cfg.vm_nic.in_cap
            for st in states:
                up = by_dst.get((st.flow.src, st.flow.piece))
                if up is not None:
                    self.set_parent(st, up)
                    st.start_after = max(st.start_after, t0)  # start gated below
                    # child may begin one block (+hop cost) after the parent
                    st.pipeline_delay = block_t + cfg.hop_latency
        for st in states:
            if on_node_done is not None:
                dst = st.flow.dst
                st.on_done = (
                    lambda t, dst=dst: on_node_done(dst, t)
                )
            st.fid = len(self._flows)
            self._flows.append(st)
            self._arm_start(st)
        wire_runnable(self, states, on_node_runnable)
        return states

    def _arm_start(self, st: _FlowState) -> None:
        if st.parent is not None and not st.parent.started:
            # Gated on the parent's start: no polling — the parent notifies
            # its waiters the moment it starts.
            st.parent.waiters.append(st)
            return
        t = max(st.start_after, self.now)
        if st.parent is not None:
            t = max(t, st.parent.t_start + st.pipeline_delay)
        self.schedule(t, lambda: self._start_flow(st))

    def _start_flow(self, st: _FlowState) -> None:
        if st.started or st.done:
            return
        if st.parent is not None and not st.parent.started:
            self._arm_start(st)
            return
        st.started = True
        st.t_start = self.now
        st.t_last = self.now
        self._n_active += 1
        f = st.flow
        skey = self._src_key(f.src)
        self._out.setdefault(skey, {})[st.fid] = st
        self._in.setdefault(f.dst, {})[st.fid] = st
        if self._record_trace:
            self.trace.append((self.now, f"start#{st.fid} {f.src}->{f.dst}/{f.piece}"))
        # Counts on both NICs changed: every flow sharing them is dirty.
        for g in self._out[skey].values():
            self._pending_dirty[g.fid] = g
        for g in self._in[f.dst].values():
            self._pending_dirty[g.fid] = g
        # Release children that were waiting for this flow to start.
        for w in st.waiters:
            if not w.started and not w.done:
                t = max(w.start_after, st.t_start + w.pipeline_delay, self.now)
                self.schedule(t, lambda w=w: self._start_flow(w))
        st.waiters.clear()

    # ------------------------------------------------------------------
    # Incremental rate maintenance
    # ------------------------------------------------------------------
    def _settle(self, f: _FlowState) -> None:
        """Bring ``remaining`` up to date at ``self.now`` under the old rate."""
        if self.now > f.t_last:
            if f.rate > 0.0:
                f.remaining = max(0.0, f.remaining - f.rate * (self.now - f.t_last))
            f.t_last = self.now

    def _recompute(self, dirty: dict[int, _FlowState]) -> None:
        """Re-rate the dirty closure, parents before streaming children."""
        cfg = self.cfg
        spec = self.registry
        touched_out: set[str] = set()
        touched_in: set[str] = set()
        wl: list[tuple[int, int]] = []
        queued: set[int] = set()
        for f in dirty.values():
            if f.started and not f.done:
                heapq.heappush(wl, (f.depth, f.fid))
                queued.add(f.fid)
        while wl:
            _, fid = heapq.heappop(wl)
            queued.discard(fid)
            f = self._flows[fid]
            if not f.started or f.done:
                continue
            src, dst = f.flow.src, f.flow.dst
            from_registry = is_registry_node(src)
            skey = spec.canonical(src) if from_registry else src
            n_out = len(self._out[skey])
            if from_registry:
                shard = shard_index(skey)
                cap_out = spec.egress_of(shard)
            else:
                cap_out = self._slow_out.get(src, cfg.vm_nic.out_cap)
            r = min(
                cfg.per_stream_cap,
                cap_out / n_out,
                cfg.vm_nic.in_cap / len(self._in[dst]),
                cfg.decompress_rate,
            )
            if from_registry and f.block_mode:
                # per-shard request throttle shared by the shard's streams
                r = min(r, cfg.block_size * spec.qps_of(shard) / n_out)
            if f.parent is not None and not f.parent.done:
                r = min(r, f.parent.rate)
            if r != f.rate:
                self._settle(f)
                delta = r - f.rate
                if from_registry:
                    self._reg_out[skey] = self._reg_out.get(skey, 0.0) + delta
                else:
                    self._vm_out[skey] = self._vm_out.get(skey, 0.0) + delta
                    touched_out.add(skey)
                self._vm_in[dst] = self._vm_in.get(dst, 0.0) + delta
                touched_in.add(dst)
                f.rate = r
                f.epoch += 1
                if r > 0.0:
                    heapq.heappush(
                        self._done_heap, (f.t_last + f.remaining / r, f.fid, f.epoch)
                    )
                    if f.on_notify is not None and not f.notified:
                        # prefix-landing estimate under the new rate; a
                        # threshold already passed clamps to "due now"
                        pend = f.notify_bytes - (f.total - f.remaining)
                        heapq.heappush(
                            self._notify_heap,
                            (f.t_last + max(0.0, pend) / r, f.fid, f.epoch),
                        )
                if self.record_rates:
                    self.rate_log.append((self.now, f.fid, r))
                # A parent-rate change propagates down the streaming chain.
                for c in f.children:
                    if c.started and not c.done and c.fid not in queued:
                        heapq.heappush(wl, (c.depth, c.fid))
                        queued.add(c.fid)
        if self._reg_out:
            for skey, egress in self._reg_out.items():
                if egress > self.peak_shard_egress.get(skey, 0.0):
                    self.peak_shard_egress[skey] = egress
            total = sum(self._reg_out.values())
            if total > self.peak_registry_egress:
                self.peak_registry_egress = total
        for node in touched_out:
            cap = self._slow_out.get(node, cfg.vm_nic.out_cap)
            if cap > 0 and cap != math.inf:
                u = self._vm_out[node] / cap
                if u > self.peak_nic_utilization:
                    self.peak_nic_utilization = u
        if cfg.vm_nic.in_cap > 0 and cfg.vm_nic.in_cap != math.inf:
            for node in touched_in:
                u = self._vm_in[node] / cfg.vm_nic.in_cap
                if u > self.peak_nic_utilization:
                    self.peak_nic_utilization = u

    # Compact ``_done_heap`` when stale (epoch-superseded or completed)
    # entries outnumber live flows ~4x.  Every rate change pushes a fresh
    # entry and only invalidates the old one lazily, so rate-churny runs
    # (straggler toggling, large shared-NIC fan-in) would otherwise grow the
    # heap without bound; the rebuild keeps only current-epoch entries of
    # active flows and re-heapifies — pop order is unchanged because stale
    # entries were never returned anyway.
    _HEAP_COMPACT_MIN = 64

    def _compact_done_heap(self) -> None:
        heap = [
            e
            for e in self._done_heap
            if not (f := self._flows[e[1]]).done and f.started and e[2] == f.epoch
        ]
        heapq.heapify(heap)
        self._done_heap = heap

    def _next_completion(self) -> float:
        """Earliest valid completion time (lazily dropping stale heap entries)."""
        if len(self._done_heap) > max(self._HEAP_COMPACT_MIN, 4 * self._n_active):
            self._compact_done_heap()
        while self._done_heap:
            t, fid, epoch = self._done_heap[0]
            f = self._flows[fid]
            if f.done or not f.started or epoch != f.epoch:
                heapq.heappop(self._done_heap)
                continue
            return t
        return math.inf

    def _next_notify(self) -> float:
        """Earliest valid runnable-prefix time (same lazy invalidation)."""
        if len(self._notify_heap) > max(
            self._HEAP_COMPACT_MIN, 4 * self._n_active
        ):
            self._notify_heap = [
                e
                for e in self._notify_heap
                if (f := self._flows[e[1]]).started
                and not f.done
                and not f.notified
                and e[2] == f.epoch
            ]
            heapq.heapify(self._notify_heap)
        while self._notify_heap:
            t, fid, epoch = self._notify_heap[0]
            f = self._flows[fid]
            if f.done or not f.started or f.notified or epoch != f.epoch:
                heapq.heappop(self._notify_heap)
                continue
            return t
        return math.inf

    def _complete(self, f: _FlowState) -> None:
        fl = f.flow
        f.done = True
        f.remaining = 0.0
        f.t_done = self.now
        f.t_last = self.now
        self._n_active -= 1
        skey = self._src_key(fl.src)
        del self._out[skey][f.fid]
        del self._in[fl.dst][f.fid]
        if is_registry_node(fl.src):
            self._reg_out[skey] -= f.rate
        else:
            self._vm_out[skey] = self._vm_out.get(skey, 0.0) - f.rate
        self._vm_in[fl.dst] = self._vm_in.get(fl.dst, 0.0) - f.rate
        self.events_processed += 1
        if self._record_trace:
            self.trace.append((self.now, f"done#{f.fid} {fl.src}->{fl.dst}/{fl.piece}"))
        # Freed shares on both NICs + the lifted parent-cap on children.
        for g in self._out[skey].values():
            self._pending_dirty[g.fid] = g
        for g in self._in[fl.dst].values():
            self._pending_dirty[g.fid] = g
        for c in f.children:
            if c.started and not c.done:
                self._pending_dirty[c.fid] = c

    # ------------------------------------------------------------------
    def run(self, until: float = math.inf) -> float:
        """Advance until no events remain (or ``until``); returns final time."""
        while True:
            if self._pending_dirty:
                dirty, self._pending_dirty = self._pending_dirty, {}
                self._recompute(dirty)
            t_done = self._next_completion()
            t_noti = self._next_notify()
            t_evt = self._events[0][0] if self._events else math.inf
            t_next = min(t_done, t_noti, t_evt)
            if t_next == math.inf or t_next > until:
                if until != math.inf and until > self.now:
                    self.now = until
                    for d in self._out.values():
                        for f in d.values():
                            self._settle(f)
                return self.now
            self.now = t_next
            if t_noti <= t_done and t_noti <= t_evt:
                # Runnable prefixes land before (or exactly at) the flow's
                # own completion — fire every notify due at this instant in
                # deterministic (time, fid) order, then loop.
                while self._notify_heap:
                    t, fid, epoch = self._notify_heap[0]
                    f = self._flows[fid]
                    if f.done or not f.started or f.notified or epoch != f.epoch:
                        heapq.heappop(self._notify_heap)
                        continue
                    if t > self.now:
                        break
                    heapq.heappop(self._notify_heap)
                    f.notified = True
                    self.events_processed += 1
                    if f.on_notify is not None:
                        f.on_notify(self.now)
            elif t_done <= t_evt:
                # Batch every completion due at this instant into one settle
                # pass: mark them all done first, then fire callbacks in
                # deterministic (time, fid) order, then re-rate the union of
                # their dirty closures once.
                batch: list[_FlowState] = []
                while self._done_heap:
                    t, fid, epoch = self._done_heap[0]
                    f = self._flows[fid]
                    if f.done or not f.started or epoch != f.epoch:
                        heapq.heappop(self._done_heap)
                        continue
                    if t <= self.now:
                        heapq.heappop(self._done_heap)
                        batch.append(f)
                    else:
                        break
                for f in batch:
                    self._complete(f)
                # A completed flow's prefix landed by definition: fire any
                # notify that has not gone out yet (runnable <= done always),
                # before the done callbacks.
                for f in batch:
                    if f.on_notify is not None and not f.notified:
                        f.notified = True
                        self.events_processed += 1
                        f.on_notify(self.now)
                for f in batch:
                    if f.on_done is not None:
                        f.on_done(self.now)
            else:
                while self._events and self._events[0][0] <= self.now + 1e-12:
                    _, _, fn = heapq.heappop(self._events)
                    self.events_processed += 1
                    fn()

    # ------------------------------------------------------------------
    def completion_times(self) -> dict[str, float]:
        """dst vm_id -> time its payload finished arriving."""
        out: dict[str, float] = {}
        for f in self._flows:
            if f.done:
                out[f.flow.dst] = max(out.get(f.flow.dst, 0.0), f.t_done)
        return out
