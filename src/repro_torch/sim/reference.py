"""Reference full-recompute fluid-flow engine (the pre-incremental design).

This is the original O(F)-work-per-event engine: after *every* event it
recomputes the rate of *every* active flow and linearly advances every
flow's remaining bytes.  It is quadratic in the number of flows and far too
slow for the 1000-VM experiments, but it is trivially correct with respect
to the documented rate model, so it is kept as the oracle the incremental
engine (:class:`repro_torch.sim.engine.FlowSim`) is differential-tested against
(see ``tests/test_torch_reference.py``, which also holds it equal to the JAX
package's ``ReferenceFlowSim``).  It is an oracle for ``FlowSim``-level runs,
not for the trace replay, which reads ``peak_nic_utilization`` that this
engine does not keep — as in the JAX package.

Both engines share :class:`~repro_torch.sim.engine.SimConfig` and expose the same
public API (``add_plan`` / ``set_parent`` / ``run`` / ``completion_times``)
plus an optional per-flow rate log (``record_rates=True``) used by the
equivalence tests, and both account per-registry-shard egress
(``peak_shard_egress`` / ``peak_registry_egress``) — here recomputed from
scratch every event, making this the oracle for the incremental engine's
delta-maintained per-shard sums.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core.registry import is_registry_node, shard_index
from repro_torch.core.topology import DistributionPlan, Flow

from .engine import SimConfig, plan_releases, wire_runnable


@dataclass(eq=False)
class _RefFlowState:
    flow: Flow
    remaining: float
    total: float
    start_after: float  # control-plane release time
    parent: Optional["_RefFlowState"] = None  # streaming dependency
    started: bool = False
    done: bool = False
    t_start: float = math.inf
    t_done: float = math.inf
    rate: float = 0.0
    block_mode: bool = False  # block-granular range requests (registry-throttled)
    pipeline_delay: float = 0.0
    on_done: Optional[Callable[[float], None]] = None
    fid: int = -1  # index into the engine's flow list (rate-log key)
    # Runnable-prefix milestone (paper §3.2); see engine._FlowState.
    notify_bytes: float = 0.0
    notified: bool = False
    on_notify: Optional[Callable[[float], None]] = None


class ReferenceFlowSim:
    """Full-recompute oracle: same rate model, O(flows) work per event."""

    def __init__(self, cfg: SimConfig | None = None, *, record_rates: bool = False) -> None:
        self.cfg = cfg or SimConfig()
        self.registry = self.cfg.registry_spec()
        self.now = 0.0
        self._flows: list[_RefFlowState] = []
        self._events: list[tuple[float, int, Callable[[], None]]] = []
        self._seq = 0
        self._slow_out: dict[str, float] = {}  # vm_id -> out cap override
        self.trace: list[tuple[float, str]] = []  # (time, event) log
        self.record_rates = record_rates
        self.rate_log: list[tuple[float, int, float]] = []  # (t, fid, new_rate)
        # Per-shard egress telemetry, recomputed from scratch every event —
        # the oracle for the incremental engine's per-shard accounting.
        self.peak_shard_egress: dict[str, float] = {}
        self.peak_registry_egress = 0.0

    # ------------------------------------------------------------------
    def set_slow_vm(self, vm_id: str, out_cap: float) -> None:
        """Straggler injection: clamp a VM's egress capacity."""
        self._slow_out[vm_id] = out_cap

    def clear_slow_vm(self, vm_id: str) -> None:
        self._slow_out.pop(vm_id, None)

    def schedule(self, t: float, fn: Callable[[], None]) -> None:
        self._seq += 1
        heapq.heappush(self._events, (t, self._seq, fn))

    def set_parent(self, st: _RefFlowState, parent: Optional[_RefFlowState]) -> None:
        st.parent = parent

    # ------------------------------------------------------------------
    def add_plan(
        self,
        plan: DistributionPlan,
        *,
        t0: float = 0.0,
        on_node_done: Optional[Callable[[str, float], None]] = None,
        on_node_runnable: Optional[Callable[[str, float], None]] = None,
        coordinator_queues: Optional[dict[str, float]] = None,
    ) -> list[_RefFlowState]:
        """Register a provisioning wave starting at ``t0``."""
        cfg = self.cfg
        coordinator_queues = coordinator_queues if coordinator_queues is not None else {}
        by_dst: dict[tuple[str, str], _RefFlowState] = {}
        states: list[_RefFlowState] = []
        for fl, release, block_mode in plan_releases(plan, cfg, t0, coordinator_queues):
            st = _RefFlowState(flow=fl, remaining=float(fl.bytes), total=float(fl.bytes),
                               start_after=release, block_mode=block_mode)
            states.append(st)
            # streaming dependency: dst of the parent flow == src of this
            # flow, matched per piece (see FlowSim.add_plan)
            by_dst.setdefault((fl.dst, fl.piece), st)
        if plan.streaming:
            block_t = cfg.block_size / cfg.vm_nic.in_cap
            for st in states:
                up = by_dst.get((st.flow.src, st.flow.piece))
                if up is not None:
                    st.parent = up
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

    def _arm_start(self, st: _RefFlowState) -> None:
        if st.parent is None:
            self.schedule(max(st.start_after, self.now), lambda: self._start_flow(st))
        else:
            # started when parent starts + one block-time (and own release time)
            def try_start() -> None:
                if st.started or st.done:
                    return
                p = st.parent
                if p.started:
                    t = max(st.start_after, p.t_start + st.pipeline_delay, self.now)
                    self.schedule(t, lambda: self._start_flow(st))
                else:
                    self.schedule(self.now + 1e-4, try_start)  # poll cheaply

            self.schedule(max(st.start_after, self.now), try_start)

    def _start_flow(self, st: _RefFlowState) -> None:
        if st.started or st.done:
            return
        if st.parent is not None and not st.parent.started:
            self._arm_start(st)
            return
        st.started = True
        st.t_start = self.now

    # ------------------------------------------------------------------
    # Rate computation (called after every event)
    # ------------------------------------------------------------------
    def _src_key(self, node: str) -> str:
        """Canonical source key: registry aliases collapse to their shard."""
        if is_registry_node(node):
            return self.registry.canonical(node)
        return node

    def _recompute_rates(self) -> None:
        cfg = self.cfg
        spec = self.registry
        out_count: dict[str, int] = {}
        in_count: dict[str, int] = {}
        active = [f for f in self._flows if f.started and not f.done]
        for f in active:
            skey = self._src_key(f.flow.src)
            out_count[skey] = out_count.get(skey, 0) + 1
            in_count[f.flow.dst] = in_count.get(f.flow.dst, 0) + 1

        def out_cap(node: str) -> float:
            if is_registry_node(node):
                return spec.egress_of(shard_index(spec.canonical(node)))
            return self._slow_out.get(node, cfg.vm_nic.out_cap)

        # topological order: parents before children (tree depth is small)
        def depth(f: _RefFlowState) -> int:
            d, p = 0, f.parent
            while p is not None:
                d += 1
                p = p.parent
            return d

        reg_out: dict[str, float] = {}
        for f in sorted(active, key=depth):
            skey = self._src_key(f.flow.src)
            r = min(
                cfg.per_stream_cap,
                out_cap(f.flow.src) / out_count[skey],
                cfg.vm_nic.in_cap / in_count[f.flow.dst],
                cfg.decompress_rate,
            )
            if f.block_mode and is_registry_node(f.flow.src):
                # per-shard request throttle shared by the shard's streams
                shard = shard_index(skey)
                r = min(r, cfg.block_size * spec.qps_of(shard) / out_count[skey])
            if f.parent is not None and not f.parent.done:
                r = min(r, f.parent.rate)
            if r != f.rate:
                f.rate = r
                if self.record_rates:
                    self.rate_log.append((self.now, f.fid, r))
            if is_registry_node(f.flow.src):
                reg_out[skey] = reg_out.get(skey, 0.0) + f.rate
        for skey, egress in reg_out.items():
            if egress > self.peak_shard_egress.get(skey, 0.0):
                self.peak_shard_egress[skey] = egress
        if reg_out:
            total = sum(reg_out.values())
            if total > self.peak_registry_egress:
                self.peak_registry_egress = total

    # ------------------------------------------------------------------
    def run(self, until: float = math.inf) -> float:
        """Advance until no events remain (or ``until``); returns final time."""
        while True:
            self._recompute_rates()
            # next flow completion at current rates
            t_next_done = math.inf
            next_flow: Optional[_RefFlowState] = None
            for f in self._flows:
                if f.started and not f.done and f.rate > 0:
                    t = self.now + f.remaining / f.rate
                    if t < t_next_done:
                        t_next_done, next_flow = t, f
            # next runnable-prefix landing (notify_bytes of a flow arrived)
            t_next_noti = math.inf
            noti_flow: Optional[_RefFlowState] = None
            for f in self._flows:
                if (
                    f.started
                    and not f.done
                    and not f.notified
                    and f.on_notify is not None
                    and f.rate > 0
                ):
                    pend = f.notify_bytes - (f.total - f.remaining)
                    t = self.now + max(0.0, pend) / f.rate
                    if t < t_next_noti:
                        t_next_noti, noti_flow = t, f
            t_next_evt = self._events[0][0] if self._events else math.inf
            t_next = min(t_next_done, t_next_noti, t_next_evt)
            if t_next == math.inf or t_next > until:
                if until != math.inf and until > self.now:
                    dt = until - self.now
                    for f in self._flows:
                        if f.started and not f.done:
                            f.remaining = max(0.0, f.remaining - f.rate * dt)
                    self.now = until
                return self.now
            # advance progress linearly to t_next
            dt = t_next - self.now
            for f in self._flows:
                if f.started and not f.done:
                    f.remaining = max(0.0, f.remaining - f.rate * dt)
            self.now = t_next
            if (
                t_next_noti <= t_next_done
                and t_next_noti <= t_next_evt
                and noti_flow is not None
            ):
                # one notify per iteration, mirroring one completion per
                # iteration (the scan picks the lowest fid at time ties)
                noti_flow.notified = True
                if noti_flow.on_notify is not None:
                    noti_flow.on_notify(self.now)
            elif t_next_done <= t_next_evt and next_flow is not None:
                next_flow.done = True
                next_flow.remaining = 0.0
                next_flow.t_done = self.now
                if next_flow.on_notify is not None and not next_flow.notified:
                    # runnable <= done always: fire a straggling notify first
                    next_flow.notified = True
                    next_flow.on_notify(self.now)
                if next_flow.on_done is not None:
                    next_flow.on_done(self.now)
            else:
                while self._events and self._events[0][0] <= self.now + 1e-12:
                    _, _, fn = heapq.heappop(self._events)
                    fn()

    # ------------------------------------------------------------------
    def completion_times(self) -> dict[str, float]:
        """dst vm_id -> time its payload finished arriving."""
        out: dict[str, float] = {}
        for f in self._flows:
            if f.done:
                out[f.flow.dst] = max(out.get(f.flow.dst, 0.0), f.t_done)
        return out
