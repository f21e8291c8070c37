"""Vectorized array-based fluid-flow engine (the 100k-VM backend).

Second member of the engine oracle chain (``incremental`` → ``vector`` →
``vector_torch``): the same rate model and event semantics as
:class:`repro_torch.sim.engine.FlowSim`, but live flows are flat numpy arrays —
src-node index, dst-node index, streaming depth, parent index, remaining
bytes, rate, last-settle time, epoch — instead of per-flow Python objects
chained through dict registries.  The incremental engine's per-flow
``(depth, fid)`` heap walk becomes vectorized passes:

* per-node active-flow counts are maintained as int arrays (the bincount of
  the per-NIC registries), so the equal-split denominators come from two
  gathers;
* the out-cap / in-cap / per-stream / decompress / QPS-throttle minimum is
  one elementwise ``np.minimum`` chain over the dirty candidates;
* parent-chain rate propagation is a **wide-front sweep**: each round
  re-rates every pending flow with no pending ancestor — across all trees
  and tenants at once — so independent subtrees at different streaming
  depths collapse into one dispatch instead of one per depth.  A flow is
  rated exactly once per recompute, after its parent's rate is final, so
  the rate *values* are the ones the incremental engine's ``(depth, fid)``
  worklist pops compute; the order-sensitive accounting (registry/NIC
  running sums, the rate log) is deferred to a single ``(depth, fid)``-
  sorted pass at the end of the call, which reproduces the incremental
  engine's add sequence bit-for-bit;
* completion times are batch-computed as ``t_last + remaining / rate`` over
  the changed slice and fed to the same lazily-invalidated epoch heap, with
  all same-timestamp completions extracted in one batch.

Determinism and bit-identity: every arithmetic step mirrors the incremental
engine's operand order (IEEE-754 double ops on the same operands give the
same bits whether they come from a Python float or a float64 array), event
and completion ordering reuse the same ``(time, seq)`` / ``(t, fid)``
tie-breaks, and per-shard registry egress is accumulated per-flow in the
same ``(depth, fid)`` order so the running sums — not just the results —
match.  The differential suite (``tests/test_torch_vector_engine.py``) pins
event logs bit-identical to the JAX package's engines.

Host and device: the flow and NIC state lives in host numpy arrays, read
scalar by scalar in the Python event loop.  :class:`VectorTorchFlowSim`
carries each wide front to the device and its rates back; keeping the
engine state resident on the device is later work.

Trace strings are materialized lazily (the raw log stores ``(t, kind,
fid)`` tuples) so the hot loop never formats text; ``sim.trace`` renders
the identical strings on first access.
"""
from __future__ import annotations

import heapq
import math
from typing import Callable, Optional

import numpy as np

from repro_torch.core.registry import is_registry_node, shard_index
from repro_torch.core.topology import DistributionPlan, Flow

from .engine import SimConfig, plan_releases, wire_runnable

__all__ = ["VectorFlowSim", "VectorTorchFlowSim"]

_F64 = np.float64
_I64 = np.int64
_EMPTY_I64 = np.empty(0, dtype=_I64)  # shared read-only seed for node fid bases


class _VFlowState:
    """Per-flow handle exposing the FlowSim flow-state API over the arrays.

    Scheduling topology (parent / children / waiters) and lifecycle flags
    stay on the object — they drive Python-side event wiring — while the
    numeric hot fields (``remaining`` / ``rate`` / ``t_last`` / ``epoch``)
    live only in the engine arrays and are exposed as read-only properties.
    """

    __slots__ = (
        "flow", "total", "start_after", "block_mode", "pipeline_delay",
        "on_done", "on_notify", "parent", "children", "waiters", "started",
        "done", "t_start", "t_done", "depth", "fid", "_eng",
    )

    def __init__(self, flow: Flow, total: float, start_after: float,
                 block_mode: bool, eng: "VectorFlowSim") -> None:
        self.flow = flow
        self.total = total
        self.start_after = start_after
        self.block_mode = block_mode
        self.pipeline_delay = 0.0
        self.on_done: Optional[Callable[[float], None]] = None
        self.on_notify: Optional[Callable[[float], None]] = None
        self.parent: Optional["_VFlowState"] = None
        self.children: list["_VFlowState"] = []
        self.waiters: list["_VFlowState"] = []
        self.started = False
        self.done = False
        self.t_start = math.inf
        self.t_done = math.inf
        self.depth = 0
        self.fid = -1
        self._eng = eng

    @property
    def remaining(self) -> float:
        return float(self._eng._rem[self.fid])

    @property
    def rate(self) -> float:
        return float(self._eng._rate[self.fid])

    @property
    def t_last(self) -> float:
        return float(self._eng._tlast[self.fid])

    @property
    def epoch(self) -> int:
        return int(self._eng._epoch[self.fid])

    # Runnable-prefix milestone (paper §3.2): the threshold and its pending
    # flag live in the engine arrays so the vectorized recompute can batch
    # over them; ``wire_runnable`` writes through this property.
    @property
    def notify_bytes(self) -> float:
        return float(self._eng._fnoti[self.fid])

    @notify_bytes.setter
    def notify_bytes(self, v: float) -> None:
        eng = self._eng
        eng._fnoti[self.fid] = v
        armed = v > 0.0
        eng._fhasnoti[self.fid] = armed
        if armed:
            eng._any_noti = True

    @property
    def notified(self) -> bool:
        return bool(
            self.on_notify is not None and not self._eng._fhasnoti[self.fid]
        )


def _grown(arr: np.ndarray, cap: int) -> np.ndarray:
    out = np.zeros(cap, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


class VectorFlowSim:
    """Array-based engine; drop-in for FlowSim via ``SimConfig.engine``."""

    def __init__(self, cfg: SimConfig | None = None, *, record_rates: bool = False) -> None:
        self.cfg = cfg or SimConfig()
        self.registry = self.cfg.registry_spec()
        self.now = 0.0
        self._flows: list[_VFlowState] = []  # index == fid
        self._seq = 0
        # Event queue (payloads are fids or callables).  ``schedule`` only
        # appends to ``_ev_pending``; bulk-scheduled events are folded into a
        # (t, seq)-sorted snapshot consumed by index (``_sptr``) so the run
        # loop never heappops a million-entry heap, while events scheduled
        # mid-run drain into a small heap merged with the snapshot head.
        self._ev_pending: list[tuple[float, int, object]] = []
        self._ev_heap: list[tuple[float, int, object]] = []
        self._sts: list[float] = []  # snapshot times
        self._sseq: list[int] = []  # snapshot sequence numbers
        self._spay: list[object] = []  # snapshot payloads
        self._sptr = 0
        self._in_run = False
        self._slow_out: dict[str, float] = {}  # vm_id -> out cap override
        self._record_trace = self.cfg.record_trace
        self._trace_raw: list[tuple[float, int, int]] = []  # (t, 1=start/0=done, fid)
        self._trace_cache: list[tuple[float, str]] = []
        # Flow arrays (capacity-doubled; rows live at index == fid) ------------
        cap = 1024
        self._fcap = cap
        self._fsrc = np.zeros(cap, dtype=_I64)  # node index of (canonical) src
        self._fdst = np.zeros(cap, dtype=_I64)
        self._fdep = np.zeros(cap, dtype=_I64)  # cached streaming depth
        self._fpar = np.full(cap, -1, dtype=_I64)  # parent fid or -1
        self._fblk = np.zeros(cap, dtype=bool)  # block-granular registry fetch
        self._rem = np.zeros(cap, dtype=_F64)
        self._rate = np.zeros(cap, dtype=_F64)
        self._tlast = np.zeros(cap, dtype=_F64)
        self._epoch = np.zeros(cap, dtype=_I64)
        self._fstarted = np.zeros(cap, dtype=bool)
        self._fdone = np.zeros(cap, dtype=bool)
        self._ftot = np.zeros(cap, dtype=_F64)  # total bytes (notify math)
        self._fnoti = np.zeros(cap, dtype=_F64)  # runnable-prefix threshold
        self._fhasnoti = np.zeros(cap, dtype=bool)  # notify armed + unfired
        # Scratch: "scheduled, not yet processed" marks for one _recompute
        # call (always all-False between calls — every scheduled front is
        # processed before the call returns).
        self._fsched = np.zeros(cap, dtype=bool)
        # Node arrays ----------------------------------------------------------
        ncap = 256
        self._ncap = ncap
        self._node_id: dict[str, int] = {}
        self._nname: list[str] = []
        self._nout_cnt = np.zeros(ncap, dtype=_I64)  # active out flows per node
        self._nin_cnt = np.zeros(ncap, dtype=_I64)
        self._nout_cap = np.zeros(ncap, dtype=_F64)  # egress cap (slow-VM aware)
        self._nqps = np.zeros(ncap, dtype=_F64)
        self._nreg = np.zeros(ncap, dtype=bool)  # node is a registry shard
        # node -> fids touching the node (both directions), append-only with
        # lazy compaction: completions leave stale entries behind (dropped
        # by _recompute's done filter) instead of paying a hashed discard
        # per flow.  ``_nlive`` tracks the live flow count per node as plain
        # ints (read once per dirty-node visit, where a numpy scalar read
        # would dominate); a list compacts against the done flags when it
        # outgrows twice its live count — amortized O(1) per completion.
        self._nfids: list[list[int]] = []
        self._nlive: list[int] = []
        self._vm_out = np.zeros(ncap, dtype=_F64)  # running out-rate sums
        self._vm_in = np.zeros(ncap, dtype=_F64)
        # Completion heap + dirty state ---------------------------------------
        self._done_heap: list[tuple[float, int, int]] = []  # (t_finish, fid, epoch)
        self._notify_heap: list[tuple[float, int, int]] = []  # (t_prefix, fid, epoch)
        self._any_noti = False  # any runnable-prefix notify ever armed
        self._n_active = 0
        self._dirty_nodes: set[int] = set()
        self._dirty_fids: set[int] = set()
        # Telemetry ------------------------------------------------------------
        self.events_processed = 0
        self.record_rates = record_rates
        self.rate_log: list[tuple[float, int, float]] = []  # (t, fid, new_rate)
        self._reg_out: dict[str, float] = {}  # shard key -> running egress sum
        self.peak_shard_egress: dict[str, float] = {}
        self.peak_registry_egress = 0.0
        self.peak_nic_utilization = 0.0
        # Dispatch telemetry: wide-front recompute counters.  ``legacy_levels``
        # counts the per-depth sweeps the retired depth-level algorithm would
        # have dispatched on the same closures (one per distinct streaming
        # depth per call), so ``legacy_levels / (fronts_scalar +
        # fronts_vector)`` is the front-widening factor BENCH_scale.json
        # records.  ``front_width_hist`` keys are ``width.bit_length()``
        # (i.e. bucket k holds fronts of width [2^(k-1), 2^k)).
        self.dispatch_stats: dict = {
            "recompute_calls": 0,
            "fronts_scalar": 0,
            "fronts_vector": 0,
            "flows_scalar": 0,
            "flows_vector": 0,
            "legacy_levels": 0,
            "peak_active": 0,
            "front_width_hist": {},
        }

    # ------------------------------------------------------------------
    @property
    def trace(self) -> list[tuple[float, str]]:
        """The (time, event) log, rendered lazily from the raw tuples."""
        raw, cache = self._trace_raw, self._trace_cache
        if len(cache) < len(raw):
            flows = self._flows
            for t, kind, fid in raw[len(cache):]:
                f = flows[fid].flow
                word = "start" if kind else "done"
                cache.append((t, f"{word}#{fid} {f.src}->{f.dst}/{f.piece}"))
        return cache

    # ------------------------------------------------------------------
    def _grow_flows(self, need: int) -> None:
        if need <= self._fcap:
            return
        cap = max(need, self._fcap * 2)
        self._fcap = cap
        self._fsrc = _grown(self._fsrc, cap)
        self._fdst = _grown(self._fdst, cap)
        self._fdep = _grown(self._fdep, cap)
        par = np.full(cap, -1, dtype=_I64)
        par[: len(self._fpar)] = self._fpar
        self._fpar = par
        self._fblk = _grown(self._fblk, cap)
        self._rem = _grown(self._rem, cap)
        self._rate = _grown(self._rate, cap)
        self._tlast = _grown(self._tlast, cap)
        self._epoch = _grown(self._epoch, cap)
        self._fstarted = _grown(self._fstarted, cap)
        self._fdone = _grown(self._fdone, cap)
        self._ftot = _grown(self._ftot, cap)
        self._fnoti = _grown(self._fnoti, cap)
        self._fhasnoti = _grown(self._fhasnoti, cap)
        self._fsched = _grown(self._fsched, cap)

    def _grow_nodes(self, need: int) -> None:
        if need <= self._ncap:
            return
        cap = max(need, self._ncap * 2)
        self._ncap = cap
        self._nout_cnt = _grown(self._nout_cnt, cap)
        self._nin_cnt = _grown(self._nin_cnt, cap)
        self._nout_cap = _grown(self._nout_cap, cap)
        self._nqps = _grown(self._nqps, cap)
        self._nreg = _grown(self._nreg, cap)
        self._vm_out = _grown(self._vm_out, cap)
        self._vm_in = _grown(self._vm_in, cap)

    def _node_idx(self, name: str) -> int:
        """Dense node index; registry names must already be canonical."""
        i = self._node_id.get(name)
        if i is not None:
            return i
        i = len(self._nname)
        self._grow_nodes(i + 1)
        self._node_id[name] = i
        self._nname.append(name)
        self._nfids.append([])
        self._nlive.append(0)
        if is_registry_node(name):
            shard = shard_index(name)
            self._nout_cap[i] = self.registry.egress_of(shard)
            self._nqps[i] = self.registry.qps_of(shard)
            self._nreg[i] = True
        else:
            self._nout_cap[i] = self._slow_out.get(name, self.cfg.vm_nic.out_cap)
            self._nqps[i] = math.inf
        return i

    # ------------------------------------------------------------------
    def set_slow_vm(self, vm_id: str, out_cap: float) -> None:
        """Straggler injection: clamp a VM's egress capacity."""
        self._slow_out[vm_id] = out_cap
        i = self._node_id.get(vm_id)
        if i is not None and not self._nreg[i]:
            self._nout_cap[i] = out_cap
            if self._nlive[i]:
                self._dirty_nodes.add(i)

    def clear_slow_vm(self, vm_id: str) -> None:
        self._slow_out.pop(vm_id, None)
        i = self._node_id.get(vm_id)
        if i is not None and not self._nreg[i]:
            self._nout_cap[i] = self.cfg.vm_nic.out_cap
            if self._nlive[i]:
                self._dirty_nodes.add(i)

    def schedule(self, t: float, fn) -> None:
        """Queue a timed event; ``fn`` is a callable or an internal fid."""
        self._seq += 1
        self._ev_pending.append((t, self._seq, fn))

    def _fold_events(self) -> None:
        """Merge all outstanding events into one (t, seq)-sorted snapshot.

        Pops then cost a list-index bump instead of an O(log n) sift on a
        heap the size of the whole burst.  The (t, seq) key is the exact
        tuple order ``heapq`` would impose (seq is unique), so the global
        event order is bit-identical to the incremental engine's heap.
        """
        evs: list[tuple[float, int, object]] = []
        p = self._sptr
        if p < len(self._spay):
            evs.extend(zip(self._sts[p:], self._sseq[p:], self._spay[p:]))
        evs.extend(self._ev_heap)
        evs.extend(self._ev_pending)
        del self._ev_heap[:]
        del self._ev_pending[:]
        if not evs:
            self._sts, self._sseq, self._spay, self._sptr = [], [], [], 0
            return
        n = len(evs)
        ts = np.fromiter((e[0] for e in evs), dtype=_F64, count=n)
        seqs = np.fromiter((e[1] for e in evs), dtype=_I64, count=n)
        order = np.lexsort((seqs, ts))
        self._sts = ts[order].tolist()
        self._sseq = seqs[order].tolist()
        self._spay = [evs[i][2] for i in order.tolist()]
        self._sptr = 0

    def set_parent(self, st: _VFlowState, parent: Optional[_VFlowState]) -> None:
        """Attach a streaming dependency (see FlowSim.set_parent)."""
        if st.parent is not None:
            try:
                st.parent.children.remove(st)
            except ValueError:  # pragma: no cover - defensive
                pass
        st.parent = parent
        if parent is not None:
            parent.children.append(st)
        st.depth = parent.depth + 1 if parent is not None else 0
        if st.fid >= 0:
            self._fpar[st.fid] = parent.fid if parent is not None else -1
            self._fdep[st.fid] = st.depth
        stack = list(st.children)
        while stack:
            c = stack.pop()
            c.depth = c.parent.depth + 1
            if c.fid >= 0:
                self._fdep[c.fid] = c.depth
            stack.extend(c.children)
        if st.started and not st.done:
            # attaching mid-flight changes the parent-rate cap immediately
            self._dirty_fids.add(st.fid)

    # ------------------------------------------------------------------
    def add_plan(
        self,
        plan: DistributionPlan,
        *,
        t0: float = 0.0,
        on_node_done: Optional[Callable[[str, float], None]] = None,
        on_node_runnable: Optional[Callable[[str, float], None]] = None,
        coordinator_queues: Optional[dict[str, float]] = None,
    ) -> list[_VFlowState]:
        """Register a provisioning wave starting at ``t0``."""
        cfg = self.cfg
        coordinator_queues = coordinator_queues if coordinator_queues is not None else {}
        by_dst: dict[tuple[str, str], _VFlowState] = {}
        states: list[_VFlowState] = []
        for fl, release, block_mode in plan_releases(plan, cfg, t0, coordinator_queues):
            st = _VFlowState(fl, float(fl.bytes), release, block_mode, self)
            states.append(st)
            # streaming dependency: dst of the parent flow == src of this
            # flow, matched per piece (see FlowSim.add_plan)
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
        self._grow_flows(len(self._flows) + len(states))
        for st in states:
            if on_node_done is not None:
                dst = st.flow.dst
                st.on_done = (
                    lambda t, dst=dst: on_node_done(dst, t)
                )
            fid = len(self._flows)
            st.fid = fid
            self._flows.append(st)
            self._register_flow(st)
        for st in states:
            # parent fids are only all assigned once the loop above finishes
            if st.parent is not None:
                self._fpar[st.fid] = st.parent.fid
        for st in states:
            self._arm_start(st)
        wire_runnable(self, states, on_node_runnable)
        if not self._in_run and len(self._ev_pending) > 2048:
            self._fold_events()  # sort bulk releases outside the timed run
        return states

    def _register_flow(self, st: _VFlowState) -> None:
        fid = st.fid
        fl = st.flow
        src = fl.src
        skey = self.registry.canonical(src) if is_registry_node(src) else src
        self._fsrc[fid] = self._node_idx(skey)
        self._fdst[fid] = self._node_idx(fl.dst)
        self._fdep[fid] = st.depth
        self._fblk[fid] = st.block_mode
        self._rem[fid] = st.total
        self._ftot[fid] = st.total

    def _arm_start(self, st: _VFlowState) -> None:
        if st.parent is not None and not st.parent.started:
            # Gated on the parent's start: no polling — the parent notifies
            # its waiters the moment it starts.
            st.parent.waiters.append(st)
            return
        t = max(st.start_after, self.now)
        if st.parent is not None:
            t = max(t, st.parent.t_start + st.pipeline_delay)
        self.schedule(t, st.fid)

    def _flush_starts(self, fids: list[int]) -> None:
        """Array/registry side of a batch of flows that just started.

        The object-side lifecycle (``started`` flags, waiter releases) runs
        per-flow in event order inside the run loop; everything batchable —
        NIC counts, per-node fid sets, dirty marks, trace — lands here in
        the same order, so the observable state matches flow-at-a-time
        processing exactly.
        """
        now = self.now
        fa = np.asarray(fids, dtype=_I64)
        self._fstarted[fa] = True
        self._tlast[fa] = now
        self._n_active += len(fids)
        sk = self._fsrc[fa]
        dk = self._fdst[fa]
        np.add.at(self._nout_cnt, sk, 1)
        np.add.at(self._nin_cnt, dk, 1)
        sk_l = sk.tolist()
        dk_l = dk.tolist()
        dn = self._dirty_nodes
        nf = self._nfids
        nlive = self._nlive
        for i, fid in enumerate(fids):
            s, d = sk_l[i], dk_l[i]
            nf[s].append(fid)
            nf[d].append(fid)
            nlive[s] += 1
            nlive[d] += 1
        # Counts on both NICs changed: every flow sharing them is dirty.
        dn.update(sk_l)
        dn.update(dk_l)
        if self._record_trace:
            tr = self._trace_raw
            for fid in fids:
                tr.append((now, 1, fid))

    # ------------------------------------------------------------------
    # Vectorized rate maintenance
    # ------------------------------------------------------------------
    def _recompute(self) -> None:
        """Re-rate the dirty closure as wide-front array passes.

        Instead of sweeping the closure one streaming depth at a time (so
        25 trees' level-k flows cost 25 tiny dispatches), each round
        processes the whole **ready front**: every pending flow with no
        pending ancestor, across all trees and tenants at once.  A flow's
        rate depends only on its NIC counts (constant during a recompute)
        and its parent's final rate, so each flow is rated exactly once,
        with the same value the incremental engine's ``(depth, fid)``
        worklist pop computes.  Independent subtrees at different depths
        collapse into one dispatch, and the number of rounds is bounded by
        the number of distinct depths (the min-depth pending flow is always
        ready), so fronts never exceed the retired per-depth sweep count.

        Bit-identity of the running accounting sums is preserved by
        *deferring* the per-shard registry / per-VM NIC delta accumulation
        (and the rate log) to a single ``(depth, fid)``-sorted pass at the
        end of the call: the incremental engine's worklist pops are
        globally ``(depth, fid)``-ascending, so applying the same float64
        deltas in that order reproduces its running sums bit-for-bit.
        Settles, rate/epoch writes and heap pushes are per-flow independent
        and stay inline with each front.
        """
        dn, df = self._dirty_nodes, self._dirty_fids
        self._dirty_nodes, self._dirty_fids = set(), set()
        fdone = self._fdone
        nf, nlive = self._nfids, self._nlive
        buf: list[int] = list(df)
        ext = buf.extend
        for n in dn:
            lst = nf[n]
            if lst:
                if len(lst) > (nlive[n] << 1) + 4:
                    # compaction removes at least half the list, so the work
                    # is amortized O(1) per completed flow; big lists (hot
                    # registry shards) drop their dead weight vectorized
                    if len(lst) > 256:
                        a = np.asarray(lst, dtype=_I64)
                        lst = a[~fdone[a]].tolist()
                    else:
                        lst = [f for f in lst if not fdone[f]]
                    nf[n] = lst
                ext(lst)
        if not buf:
            return
        cfg = self.cfg
        cutoff = cfg.vector_scalar_cutoff
        stats = self.dispatch_stats
        if len(buf) <= 48:
            # Small closure: dedup/sort/filter in plain Python, and when the
            # survivor set is small enough route the whole closure through
            # the scalar mirror — a handful of flows cannot amortize the
            # ~30 fixed-cost numpy dispatches of the array path below, and
            # at mega/giga scale most recompute calls look exactly like this.
            fstarted = self._fstarted
            fs = sorted({f for f in buf if fstarted[f] and not fdone[f]})
            if not fs:
                return
            if len(fs) <= 32:
                stats["recompute_calls"] += 1
                if self._n_active > stats["peak_active"]:
                    stats["peak_active"] = self._n_active
                self._recompute_small(fs, self.now)
                return
            arr = np.asarray(fs, dtype=_I64)
        else:
            # unique() both dedups (a fid sits on two NICs, both may be
            # dirty) and sorts — fronts stay fid-ascending as subsets of
            # this sorted array; stale entries (completed flows) wash out
            # in the filter.
            arr = np.unique(np.asarray(buf, dtype=_I64))
            keep = self._fstarted[arr] & ~fdone[arr]
            if not keep.all():
                arr = arr[keep]
            if arr.size == 0:
                return
        now = self.now
        flows = self._flows
        stats["recompute_calls"] += 1
        if self._n_active > stats["peak_active"]:
            stats["peak_active"] = self._n_active
        hist = stats["front_width_hist"]
        # --- Round assignment (one pass, mostly vectorized) ---------------
        # Round 0 is the wide front: every candidate with no pending
        # ancestor, across all trees and depths at once.  A candidate with
        # a pending ancestor anywhere up its *live* chain is deferred to
        # round ``depth - min_depth`` — a conservative slot that keeps every
        # ancestor (including settled intermediates that may re-join via
        # cascade) strictly earlier: a flow at round r can only be affected
        # by flows at rounds < r, so each flow is rated exactly once, after
        # its parent's rate is final.  Empty rounds cost nothing (dict).
        fdep = self._fdep
        mask = self._fsched  # scheduled-not-yet-processed marks (all-False
        mask[arr] = True  # between calls; every front clears its slice)
        blocked_any = False
        dep_arr = None
        par_in = None
        if arr.size > 1:
            dep_arr = fdep[arr]
            par_arr = self._fpar[arr]
            pos = np.searchsorted(arr, par_arr)
            par_in = arr[np.minimum(pos, arr.size - 1)] == par_arr
            # (par_arr == -1 never matches: fids are non-negative)
            maybe = np.flatnonzero(~par_in & (par_arr >= 0))
            if maybe.size:
                # Gap scan: a settled (non-candidate) parent can hide a
                # pending grandparent whose change will cascade back through
                # it — those flows must wait too.  Lane-parallel up-walk:
                # every undecided lane ascends one ancestor per step,
                # dropping out when it hits a pending candidate (blocked),
                # the root, or a done ancestor (a done flow no longer
                # transmits rate changes downward); steps are bounded by the
                # deepest live chain, with every step fully vectorized.
                fpar = self._fpar
                idx = maybe
                cur = par_arr[maybe]
                live = ~fdone[cur]
                if not live.all():
                    idx = idx[live]
                    cur = cur[live]
                while idx.size:
                    hit = mask[cur]
                    if hit.any():
                        par_in[idx[hit]] = True
                        miss = ~hit
                        idx = idx[miss]
                        if not idx.size:
                            break
                        cur = cur[miss]
                    cur = fpar[cur]
                    live = cur >= 0
                    if not live.all():
                        idx = idx[live]
                        if not idx.size:
                            break
                        cur = cur[live]
                    live = ~fdone[cur]
                    if not live.all():
                        idx = idx[live]
                        cur = cur[live]
            blocked_any = bool(par_in.any())
        # Deferred (depth, fid)-ordered accounting (see docstring) ---------
        acc_fids: list[np.ndarray] = []
        acc_old: list[np.ndarray] = []
        acc_new: list[np.ndarray] = []
        sc_fids: list[int] = []
        sc_old: list[float] = []
        sc_new: list[float] = []
        dseen: set[int] = set()  # distinct depths the retired sweep would pay
        scalar_front = self._scalar_front
        vector_front = self._vector_front

        def _front(fids: np.ndarray) -> list[int]:
            mask[fids] = False
            w = fids.size
            hist_b = w.bit_length()
            hist[hist_b] = hist.get(hist_b, 0) + 1
            if w <= 64:
                dseen.update(fdep[fids].tolist())
            else:
                dseen.update(np.unique(fdep[fids]).tolist())
            if w <= cutoff:
                stats["fronts_scalar"] += 1
                stats["flows_scalar"] += w
                return scalar_front(fids, now, flows, mask, sc_fids, sc_old, sc_new)
            stats["fronts_vector"] += 1
            stats["flows_vector"] += w
            return vector_front(fids, now, flows, mask, acc_fids, acc_old, acc_new)

        if not blocked_any:
            # Fast path (the common case): nothing in the closure waits on
            # anything else in it — the whole closure is round 0, and each
            # cascade generation is the next front.  Fronts are disjoint
            # (every flow has one parent, processed exactly once).
            kids = _front(arr)
            while kids:
                ka = np.asarray(kids, dtype=_I64)
                ka.sort()
                kids = _front(ka)
        else:
            rounds = np.zeros(arr.size, dtype=_I64)
            dmin = int(dep_arr.min())
            bi = np.flatnonzero(par_in)
            rounds[bi] = dep_arr[bi] - dmin
            order = np.lexsort((arr, rounds))
            sarr = arr[order]
            srnd = rounds[order]
            cuts = np.flatnonzero(np.diff(srnd)) + 1
            sched: dict[int, list[np.ndarray]] = {}
            for rv, chunk in zip(
                srnd[np.concatenate(([0], cuts))].tolist(), np.split(sarr, cuts)
            ):
                sched[rv] = [chunk]
            while sched:
                cur = min(sched)
                chunks = sched.pop(cur)
                if len(chunks) == 1:
                    fids = chunks[0]
                else:
                    # chunks are disjoint: cascade kids come via their single
                    # parent and the mask filter keeps already-scheduled
                    # closure members in their own (later) slot
                    fids = np.concatenate(chunks)
                    fids.sort()
                kids = _front(fids)
                if kids:
                    # Cascade: changed parents re-rate their live children
                    # next round (a child still scheduled later keeps its
                    # own slot).
                    sched.setdefault(cur + 1, []).append(
                        np.asarray(kids, dtype=_I64)
                    )
        # The retired depth-sweep dispatched one pass per distinct streaming
        # depth over the exact same processed set; count what it would have
        # cost on this closure so one run yields the honest reduction ratio.
        stats["legacy_levels"] += len(dseen)
        if sc_fids:
            acc_fids.append(np.asarray(sc_fids, dtype=_I64))
            acc_old.append(np.asarray(sc_old, dtype=_F64))
            acc_new.append(np.asarray(sc_new, dtype=_F64))
        if not acc_fids:
            return
        if len(acc_fids) == 1:
            allf, allo, alln = acc_fids[0], acc_old[0], acc_new[0]
        else:
            allf = np.concatenate(acc_fids)
            allo = np.concatenate(acc_old)
            alln = np.concatenate(acc_new)
        order = np.lexsort((allf, self._fdep[allf]))
        allf = allf[order]
        alln = alln[order]
        delta = alln - allo[order]
        srcc = self._fsrc[allf]
        dstc = self._fdst[allf]
        isreg = self._nreg[srcc]
        vm_nodes = None
        if isreg.any():
            # per-flow dict accumulation in (depth, fid) order — the running
            # per-shard sums must match the incremental engine bit-for-bit,
            # so mirror its add sequence exactly
            names = self._nname
            reg = self._reg_out
            dl = delta.tolist()
            for k in np.flatnonzero(isreg).tolist():
                skey = names[srcc[k]]
                reg[skey] = reg.get(skey, 0.0) + dl[k]
            vm = ~isreg
            if vm.any():
                vi = np.flatnonzero(vm)
                vm_nodes = srcc[vi]
                np.add.at(self._vm_out, vm_nodes, delta[vi])
        else:
            vm_nodes = srcc
            np.add.at(self._vm_out, srcc, delta)
        np.add.at(self._vm_in, dstc, delta)
        if self.record_rates:
            rl = self.rate_log
            for fid, rn in zip(allf.tolist(), alln.tolist()):
                rl.append((now, fid, rn))
        # Peak telemetry (identical comparison sequence to the incremental
        # engine; peaks are max-folds, so ordering cannot change the result).
        if self._reg_out:
            pse = self.peak_shard_egress
            for skey, egress in self._reg_out.items():
                if egress > pse.get(skey, 0.0):
                    pse[skey] = egress
            total = sum(self._reg_out.values())
            if total > self.peak_registry_egress:
                self.peak_registry_egress = total
        if vm_nodes is not None and vm_nodes.size:
            nodes = np.unique(vm_nodes)
            caps = self._nout_cap[nodes]
            valid = (caps > 0) & np.isfinite(caps)
            if valid.any():
                u = float((self._vm_out[nodes[valid]] / caps[valid]).max())
                if u > self.peak_nic_utilization:
                    self.peak_nic_utilization = u
        in_cap = cfg.vm_nic.in_cap
        if in_cap > 0 and in_cap != math.inf:
            nodes = np.unique(dstc)
            u = float((self._vm_in[nodes] / in_cap).max())
            if u > self.peak_nic_utilization:
                self.peak_nic_utilization = u

    def _recompute_small(self, fs: list[int], now: float) -> None:
        """Whole-closure scalar mirror for small dirty closures.

        Identical round assignment, fid-sorted fronts and deferred
        (depth, fid)-sorted accounting as :meth:`_recompute`'s array path,
        executed per flow in plain Python: every float64 operation runs on
        the same values in the same order, so rates, heap keys, running
        registry/NIC sums and peak telemetry are all bit-identical.  Fronts
        are routed by the same ``vector_scalar_cutoff`` rule — a wide
        cascade generation still goes through :meth:`_vector_front` — so
        the dispatch telemetry (front counts, width histogram, legacy-level
        equivalents) matches what the array path would record.
        """
        flows = self._flows
        fdep = self._fdep
        fpar_a = self._fpar
        fdone = self._fdone
        mask = self._fsched
        stats = self.dispatch_stats
        hist = stats["front_width_hist"]
        cfg = self.cfg
        psc = cfg.per_stream_cap
        icap = cfg.vm_nic.in_cap
        dec = cfg.decompress_rate
        bsz = cfg.block_size
        rate_a, rem_a, tlast_a, ep_a = self._rate, self._rem, self._tlast, self._epoch
        no_cnt, ni_cnt = self._nout_cnt, self._nin_cnt
        no_cap, qps_a = self._nout_cap, self._nqps
        blk_a = self._fblk
        fsrc_a, fdst_a = self._fsrc, self._fdst
        heap = self._done_heap
        nheap = self._notify_heap
        hasn, fnoti, ftot = self._fhasnoti, self._fnoti, self._ftot
        # Round assignment (scalar mirror): round 0 unless a live-chain
        # ancestor is also a candidate, else the conservative depth slot.
        sched: dict[int, list[int]] = {}
        if len(fs) == 1:
            mask[fs[0]] = True
            sched[0] = fs
        else:
            cand = set(fs)
            deps = [int(fdep[f]) for f in fs]
            dmin = min(deps)
            sget = sched.setdefault
            for i, fid in enumerate(fs):
                mask[fid] = True
                r = 0
                p = fpar_a[fid]
                while p >= 0 and not fdone[p]:
                    if p in cand:
                        r = deps[i] - dmin
                        break
                    p = fpar_a[p]
                sget(r, []).append(fid)
        cutoff = cfg.vector_scalar_cutoff
        sc_fids: list[int] = []
        sc_old: list[float] = []
        sc_new: list[float] = []
        acc_fids: list[np.ndarray] = []
        acc_old: list[np.ndarray] = []
        acc_new: list[np.ndarray] = []
        dseen: set = set()
        while sched:
            cur = min(sched)
            front = sched.pop(cur)
            front.sort()
            w = len(front)
            hist_b = w.bit_length()
            hist[hist_b] = hist.get(hist_b, 0) + 1
            if w > cutoff:
                # A wide cascade generation (a changed parent fanning out)
                # still goes through the array front, exactly as the array
                # path would route it; its (fid, old, new) triples merge
                # into the same sorted accounting tail below.
                fa = np.asarray(front, dtype=_I64)
                dseen.update(fdep[fa].tolist())
                stats["fronts_vector"] += 1
                stats["flows_vector"] += w
                mask[fa] = False
                kids = self._vector_front(
                    fa, now, flows, mask, acc_fids, acc_old, acc_new
                )
                if kids:
                    sched.setdefault(cur + 1, []).extend(kids)
                continue
            stats["fronts_scalar"] += 1
            stats["flows_scalar"] += w
            kids = []
            for fid in front:
                mask[fid] = False
                dseen.add(int(fdep[fid]))
                s = fsrc_a[fid]
                n_out = float(no_cnt[s])
                r = min(psc, float(no_cap[s]) / n_out)
                r = min(r, icap / float(ni_cnt[fdst_a[fid]]))
                r = min(r, dec)
                if blk_a[fid]:
                    r = min(r, bsz * float(qps_a[s]) / n_out)
                p = fpar_a[fid]
                if p >= 0 and not fdone[p]:
                    r = min(r, float(rate_a[p]))
                old = float(rate_a[fid])
                if r == old:
                    continue
                tl = float(tlast_a[fid])
                rem = float(rem_a[fid])
                if now > tl:
                    if old > 0.0:
                        rem = max(0.0, rem - old * (now - tl))
                        rem_a[fid] = rem
                    tlast_a[fid] = now
                    tl = now
                rate_a[fid] = r
                e = int(ep_a[fid]) + 1
                ep_a[fid] = e
                if r > 0.0:
                    heapq.heappush(heap, (tl + rem / r, fid, e))
                    if hasn[fid]:
                        pend = float(fnoti[fid]) - (float(ftot[fid]) - rem)
                        heapq.heappush(nheap, (tl + max(0.0, pend) / r, fid, e))
                sc_fids.append(fid)
                sc_old.append(old)
                sc_new.append(r)
                cs = flows[fid].children
                if cs:
                    for c in cs:
                        if c.started and not c.done and not mask[c.fid]:
                            kids.append(c.fid)
            if kids:
                sched.setdefault(cur + 1, []).extend(kids)
        stats["legacy_levels"] += len(dseen)
        if acc_fids:
            for a_f, a_o, a_n in zip(acc_fids, acc_old, acc_new):
                sc_fids.extend(a_f.tolist())
                sc_old.extend(a_o.tolist())
                sc_new.extend(a_n.tolist())
        if not sc_fids:
            return
        # Deferred accounting, (depth, fid)-sorted — the same running-sum
        # add sequence as the array path's lexsorted tail.
        names = self._nname
        reg = self._reg_out
        nreg = self._nreg
        vm_out, vm_in = self._vm_out, self._vm_in
        rl = self.rate_log if self.record_rates else None
        vm_nodes: list[int] = []
        dst_nodes: list[int] = []
        for _, fid, old, new in sorted(
            zip((int(fdep[f]) for f in sc_fids), sc_fids, sc_old, sc_new)
        ):
            delta = new - old
            s = int(fsrc_a[fid])
            d = int(fdst_a[fid])
            if nreg[s]:
                skey = names[s]
                reg[skey] = reg.get(skey, 0.0) + delta
            else:
                vm_out[s] = vm_out[s] + delta
                vm_nodes.append(s)
            vm_in[d] = vm_in[d] + delta
            dst_nodes.append(d)
            if rl is not None:
                rl.append((now, fid, new))
        # Peak telemetry (same max-folds as the array path).
        if reg:
            pse = self.peak_shard_egress
            for skey, egress in reg.items():
                if egress > pse.get(skey, 0.0):
                    pse[skey] = egress
            total = sum(reg.values())
            if total > self.peak_registry_egress:
                self.peak_registry_egress = total
        if vm_nodes:
            u = -math.inf
            for nid in set(vm_nodes):
                cap = float(no_cap[nid])
                if cap > 0.0 and cap != math.inf:
                    un = float(vm_out[nid]) / cap
                    if un > u:
                        u = un
            if u > self.peak_nic_utilization:
                self.peak_nic_utilization = u
        if icap > 0.0 and icap != math.inf:
            u = -math.inf
            for nid in set(dst_nodes):
                un = float(vm_in[nid]) / icap
                if un > u:
                    u = un
            if u > self.peak_nic_utilization:
                self.peak_nic_utilization = u

    def _front_rates(
        self, fids: np.ndarray, src: np.ndarray, dst: np.ndarray
    ) -> np.ndarray:
        """Elementwise min-cap chain over one ready front (numpy path).

        Seam for the accelerator tier: :class:`VectorTorchFlowSim` overrides
        this with the CUDA cap-chain kernel; everything around it (fronts,
        settles, heaps, deferred accounting) is shared.
        """
        cfg = self.cfg
        n_out = self._nout_cnt[src]
        r = np.minimum(cfg.per_stream_cap, self._nout_cap[src] / n_out)
        np.minimum(r, cfg.vm_nic.in_cap / self._nin_cnt[dst], out=r)
        np.minimum(r, cfg.decompress_rate, out=r)
        blk = self._fblk[fids]
        if blk.any():
            # per-shard request throttle shared by the shard's streams
            bi = np.flatnonzero(blk)
            r[bi] = np.minimum(
                r[bi], cfg.block_size * self._nqps[src[bi]] / n_out[bi]
            )
        par = self._fpar[fids]
        pm = par >= 0
        if pm.any():
            pi = np.flatnonzero(pm)
            live = ~self._fdone[par[pi]]
            if not live.all():
                pi = pi[live]
            if pi.size:
                r[pi] = np.minimum(r[pi], self._rate[par[pi]])
        return r

    def _vector_front(
        self,
        fids: np.ndarray,
        now: float,
        flows: list[_VFlowState],
        mask: np.ndarray,
        acc_fids: list[np.ndarray],
        acc_old: list[np.ndarray],
        acc_new: list[np.ndarray],
    ) -> list[int]:
        """One wide front, vectorized; returns cascade children.

        Rates, settles, epochs and heap entries update inline (per-flow
        independent); the order-sensitive delta accounting is *collected*
        as (fid, old, new) triples for ``_recompute``'s deferred sorted
        pass.
        """
        src = self._fsrc[fids]
        dst = self._fdst[fids]
        r = self._front_rates(fids, src, dst)
        changed = r != self._rate[fids]
        if not changed.any():
            return []
        ci = np.flatnonzero(changed)
        ch = fids[ci]  # fid-ascending (fids sorted)
        r_new = r[ci]
        old = self._rate[ch]
        # settle under the old rate (mirror of FlowSim._settle)
        tl = self._tlast[ch]
        adv = now > tl
        if adv.any():
            ai = np.flatnonzero(adv)
            aj = ch[ai]
            pos = old[ai] > 0.0
            if pos.any():
                ak = aj[pos]
                self._rem[ak] = np.maximum(
                    0.0, self._rem[ak] - self._rate[ak] * (now - self._tlast[ak])
                )
            self._tlast[aj] = now
        self._rate[ch] = r_new
        self._epoch[ch] += 1
        pos_r = r_new > 0.0
        est = np.zeros(ch.size, dtype=_F64)
        if pos_r.any():
            pj = np.flatnonzero(pos_r)
            est[pj] = self._tlast[ch[pj]] + self._rem[ch[pj]] / r_new[pj]
        ch_l = ch.tolist()
        ep_l = self._epoch[ch].tolist()
        entries = [
            (t, fid, e)
            for t, fid, e, p in zip(est.tolist(), ch_l, ep_l, pos_r.tolist())
            if p
        ]
        nmask = self._fhasnoti[ch] & pos_r
        if nmask.any():
            # prefix-landing estimate under the new rate; a threshold
            # already passed clamps to "due now" (mirror of FlowSim)
            nj = np.flatnonzero(nmask)
            chn = ch[nj]
            pend = self._fnoti[chn] - (self._ftot[chn] - self._rem[chn])
            nt = self._tlast[chn] + np.maximum(0.0, pend) / r_new[nj]
            nheap = self._notify_heap
            for t, fid, e in zip(
                nt.tolist(), chn.tolist(), self._epoch[chn].tolist()
            ):
                heapq.heappush(nheap, (t, fid, e))
        if entries:
            heap = self._done_heap
            if len(entries) > 1024 and 2 * len(entries) > len(heap):
                # bulk path: drop stale entries while we rebuild anyway
                fdone, fstarted, ep = self._fdone, self._fstarted, self._epoch
                heap = [
                    e for e in heap
                    if fstarted[e[1]] and not fdone[e[1]] and e[2] == ep[e[1]]
                ]
                heap.extend(entries)
                heapq.heapify(heap)
                self._done_heap = heap
            else:
                for e in entries:
                    heapq.heappush(heap, e)
        acc_fids.append(ch)
        acc_old.append(old)
        acc_new.append(r_new)
        # A parent-rate change propagates down the streaming chain.  A child
        # already pending stays where it is; a child already *processed* is
        # impossible (it was ancestor-blocked while this parent was pending).
        kids: list[int] = []
        for fid in ch_l:
            cs = flows[fid].children
            if cs:
                for c in cs:
                    if c.started and not c.done and not mask[c.fid]:
                        kids.append(c.fid)
        return kids

    def _scalar_front(
        self,
        fids: np.ndarray,
        now: float,
        flows: list[_VFlowState],
        mask: np.ndarray,
        sc_fids: list[int],
        sc_old: list[float],
        sc_new: list[float],
    ) -> list[int]:
        """One narrow front as scalar math; returns cascade children.

        Gathers each array once, then runs the per-flow min-cap chain /
        settle in plain Python — the exact operations the vectorized path
        performs, on the same float64 values in the same order, so results
        are bit-identical while skipping ~40 fixed-cost numpy dispatches on
        a handful of flows.  Changed flows are appended to the ``sc_*``
        lists for the deferred sorted accounting pass.
        """
        cfg = self.cfg
        psc = cfg.per_stream_cap
        icap = cfg.vm_nic.in_cap
        dec = cfg.decompress_rate
        bsz = cfg.block_size
        rate_a, rem_a, tlast_a, ep_a = self._rate, self._rem, self._tlast, self._epoch
        fdone = self._fdone
        heap = self._done_heap
        nheap = self._notify_heap
        hasn, fnoti, ftot = self._fhasnoti, self._fnoti, self._ftot
        kids: list[int] = []
        fl = fids.tolist()
        if len(fl) <= 4:
            # Tiny front: a handful of scalar reads per flow beats ten
            # whole-front fancy gathers whose fixed dispatch cost dominates
            # at this width.  Same float64 reads, same op order —
            # bit-identical to the gather path below.
            fsrc_a, fdst_a = self._fsrc, self._fdst
            no_cnt, ni_cnt = self._nout_cnt, self._nin_cnt
            no_cap, qps_a = self._nout_cap, self._nqps
            blk_a, par_a = self._fblk, self._fpar
            for fid in fl:
                s = fsrc_a[fid]
                n_out = float(no_cnt[s])
                r = min(psc, float(no_cap[s]) / n_out)
                r = min(r, icap / float(ni_cnt[fdst_a[fid]]))
                r = min(r, dec)
                if blk_a[fid]:
                    r = min(r, bsz * float(qps_a[s]) / n_out)
                p = par_a[fid]
                if p >= 0 and not fdone[p]:
                    r = min(r, float(rate_a[p]))
                old = float(rate_a[fid])
                if r == old:
                    continue
                tl = float(tlast_a[fid])
                rem = float(rem_a[fid])
                if now > tl:
                    if old > 0.0:
                        rem = max(0.0, rem - old * (now - tl))
                        rem_a[fid] = rem
                    tlast_a[fid] = now
                    tl = now
                rate_a[fid] = r
                e = int(ep_a[fid]) + 1
                ep_a[fid] = e
                if r > 0.0:
                    heapq.heappush(heap, (tl + rem / r, fid, e))
                    if hasn[fid]:
                        pend = float(fnoti[fid]) - (float(ftot[fid]) - rem)
                        heapq.heappush(nheap, (tl + max(0.0, pend) / r, fid, e))
                sc_fids.append(fid)
                sc_old.append(old)
                sc_new.append(r)
                cs = flows[fid].children
                if cs:
                    for c in cs:
                        if c.started and not c.done and not mask[c.fid]:
                            kids.append(c.fid)
            return kids
        src = self._fsrc[fids]
        dst = self._fdst[fids]
        no_l = self._nout_cnt[src].tolist()
        ni_l = self._nin_cnt[dst].tolist()
        oc_l = self._nout_cap[src].tolist()
        qps_l = self._nqps[src].tolist()
        blk_l = self._fblk[fids].tolist()
        par_l = self._fpar[fids].tolist()
        old_l = self._rate[fids].tolist()
        tl_l = self._tlast[fids].tolist()
        rem_l = self._rem[fids].tolist()
        for i, fid in enumerate(fl):
            n_out = no_l[i]
            r = min(psc, oc_l[i] / n_out)
            r = min(r, icap / ni_l[i])
            r = min(r, dec)
            if blk_l[i]:
                r = min(r, bsz * qps_l[i] / n_out)
            p = par_l[i]
            if p >= 0 and not fdone[p]:
                r = min(r, float(rate_a[p]))
            old = old_l[i]
            if r == old:
                continue
            tl = tl_l[i]
            if now > tl:
                if old > 0.0:
                    rem = max(0.0, rem_l[i] - old * (now - tl))
                    rem_a[fid] = rem
                    rem_l[i] = rem
                tlast_a[fid] = now
                tl = now
            rate_a[fid] = r
            e = int(ep_a[fid]) + 1
            ep_a[fid] = e
            if r > 0.0:
                heapq.heappush(heap, (tl + rem_l[i] / r, fid, e))
                if hasn[fid]:
                    # prefix-landing estimate under the new rate; clamps to
                    # "due now" when the threshold has already passed
                    pend = float(fnoti[fid]) - (float(ftot[fid]) - rem_l[i])
                    heapq.heappush(nheap, (tl + max(0.0, pend) / r, fid, e))
            sc_fids.append(fid)
            sc_old.append(old)
            sc_new.append(r)
            # A parent-rate change propagates down the streaming chain.
            cs = flows[fid].children
            if cs:
                for c in cs:
                    if c.started and not c.done and not mask[c.fid]:
                        kids.append(c.fid)
        return kids

    # ------------------------------------------------------------------
    def _compact_done_heap(self) -> None:
        fdone, fstarted, ep = self._fdone, self._fstarted, self._epoch
        heap = [
            e for e in self._done_heap
            if fstarted[e[1]] and not fdone[e[1]] and e[2] == ep[e[1]]
        ]
        heapq.heapify(heap)
        self._done_heap = heap

    def _next_completion(self) -> float:
        """Earliest valid completion time (lazily dropping stale entries)."""
        heap = self._done_heap
        if not heap:
            return math.inf
        if len(heap) > 64 and len(heap) > 4 * self._n_active:
            self._compact_done_heap()
            heap = self._done_heap
        fdone, fstarted, ep = self._fdone, self._fstarted, self._epoch
        while heap:
            t, fid, epoch = heap[0]
            if fdone[fid] or not fstarted[fid] or epoch != ep[fid]:
                heapq.heappop(heap)
                continue
            return t
        return math.inf

    def _next_notify(self) -> float:
        """Earliest valid runnable-prefix time (same lazy invalidation)."""
        heap = self._notify_heap
        if not heap:
            return math.inf
        fdone, fstarted, ep = self._fdone, self._fstarted, self._epoch
        hasn = self._fhasnoti
        if len(heap) > 64 and len(heap) > 4 * self._n_active:
            heap = [
                e for e in heap
                if fstarted[e[1]] and not fdone[e[1]] and hasn[e[1]]
                and e[2] == ep[e[1]]
            ]
            heapq.heapify(heap)
            self._notify_heap = heap
        while heap:
            t, fid, epoch = heap[0]
            if fdone[fid] or not fstarted[fid] or not hasn[fid] or epoch != ep[fid]:
                heapq.heappop(heap)
                continue
            return t
        return math.inf

    def _complete_batch(self, batch: list[int]) -> None:
        """Retire every flow finishing at this instant in (t, fid) order.

        ``np.add.at`` is unbuffered and applies updates in index order, so
        the per-node running NIC sums see the exact same float sequence as
        completing the flows one at a time; registry egress keeps the
        per-flow dict walk because its running sums are order-pinned
        against the incremental engine.
        """
        now = self.now
        flows = self._flows
        if len(batch) <= 8:
            # Small batch: per-flow scalar updates apply the exact same op
            # sequence to every accumulator (the vectorized path's add.at
            # calls are index-ordered and hit disjoint arrays), minus ~15
            # fixed-cost numpy dispatches.
            fsrc_a, fdst_a, rate_a = self._fsrc, self._fdst, self._rate
            fdone, rem_a, tlast_a = self._fdone, self._rem, self._tlast
            no_cnt, ni_cnt = self._nout_cnt, self._nin_cnt
            nreg, vm_out, vm_in = self._nreg, self._vm_out, self._vm_in
            nlive = self._nlive
            dn, df = self._dirty_nodes, self._dirty_fids
            names, reg = self._nname, self._reg_out
            for fid in batch:
                s = int(fsrc_a[fid])
                d = int(fdst_a[fid])
                r = float(rate_a[fid])
                fdone[fid] = True
                rem_a[fid] = 0.0
                tlast_a[fid] = now
                no_cnt[s] -= 1
                ni_cnt[d] -= 1
                if nreg[s]:
                    reg[names[s]] -= r
                else:
                    vm_out[s] -= r
                vm_in[d] -= r
                dn.add(s)
                dn.add(d)
                nlive[s] -= 1
                nlive[d] -= 1
                st = flows[fid]
                st.done = True
                st.t_done = now
                cs = st.children
                if cs:
                    for c in cs:
                        if c.started and not c.done:
                            df.add(c.fid)
            self._n_active -= len(batch)
            self.events_processed += len(batch)
            if self._record_trace:
                tr = self._trace_raw
                for fid in batch:
                    tr.append((now, 0, fid))
            return
        fa = np.asarray(batch, dtype=_I64)
        sk = self._fsrc[fa]
        dk = self._fdst[fa]
        rt = self._rate[fa]
        self._fdone[fa] = True
        self._rem[fa] = 0.0
        self._tlast[fa] = now
        np.add.at(self._nout_cnt, sk, -1)
        np.add.at(self._nin_cnt, dk, -1)
        isreg = self._nreg[sk]
        vm = ~isreg
        if vm.any():
            np.add.at(self._vm_out, sk[vm], -rt[vm])
        np.add.at(self._vm_in, dk, -rt)
        self._n_active -= len(batch)
        self.events_processed += len(batch)
        sk_l = sk.tolist()
        dk_l = dk.tolist()
        dn = self._dirty_nodes
        df = self._dirty_fids
        # Freed shares on both NICs; the lifted parent-cap on children lands
        # in the main loop below (children must see parents marked done).
        # The per-node fid lists keep their (now stale) entries — the
        # recompute closure filter drops them, and lists compact lazily.
        dn.update(sk_l)
        dn.update(dk_l)
        nlive = self._nlive
        for i, fid in enumerate(batch):
            st = flows[fid]
            st.done = True
            st.t_done = now
            nlive[sk_l[i]] -= 1
            nlive[dk_l[i]] -= 1
            cs = st.children
            if cs:
                for c in cs:
                    if c.started and not c.done:
                        df.add(c.fid)
        if isreg.any():
            # registry egress keeps the per-flow dict walk in batch order —
            # its running sums are order-pinned against the incremental engine
            names = self._nname
            reg = self._reg_out
            rt_l = rt.tolist()
            for i in np.flatnonzero(isreg).tolist():
                reg[names[sk_l[i]]] -= rt_l[i]
        if self._record_trace:
            tr = self._trace_raw
            for fid in batch:
                tr.append((now, 0, fid))

    def _settle_active(self) -> None:
        """Vectorized final settle of every active flow at ``self.now``."""
        n = len(self._flows)
        if n == 0:
            return
        idx = np.flatnonzero(self._fstarted[:n] & ~self._fdone[:n])
        if idx.size == 0:
            return
        adv = self.now > self._tlast[idx]
        if not adv.any():
            return
        idx = idx[adv]
        pos = self._rate[idx] > 0.0
        if pos.any():
            j = idx[pos]
            self._rem[j] = np.maximum(
                0.0, self._rem[j] - self._rate[j] * (self.now - self._tlast[j])
            )
        self._tlast[idx] = self.now

    # ------------------------------------------------------------------
    def run(self, until: float = math.inf) -> float:
        """Advance until no events remain (or ``until``); returns final time."""
        flows = self._flows
        if len(self._ev_pending) > 4096:
            self._fold_events()  # bulk schedule() outside add_plan
        pend = self._ev_pending
        evh = self._ev_heap
        self._in_run = True
        try:
            while True:
                if pend:
                    for e in pend:
                        heapq.heappush(evh, e)
                    del pend[:]
                if self._dirty_nodes or self._dirty_fids:
                    self._recompute()
                t_done = self._next_completion()
                t_noti = self._next_notify()
                t_evt = evh[0][0] if evh else math.inf
                if self._sptr < len(self._spay):
                    ts = self._sts[self._sptr]
                    if ts < t_evt:
                        t_evt = ts
                t_next = t_done if t_done < t_noti else t_noti
                if t_evt < t_next:
                    t_next = t_evt
                if t_next == math.inf or t_next > until:
                    if until != math.inf and until > self.now:
                        self.now = until
                        self._settle_active()
                    return self.now
                self.now = t_next
                if t_noti <= t_done and t_noti <= t_evt:
                    # Runnable prefixes land before (or exactly at) the flow's
                    # own completion — fire every notify due at this instant
                    # in deterministic (time, fid) order, then loop.
                    nheap = self._notify_heap
                    fdone, fstarted, ep = self._fdone, self._fstarted, self._epoch
                    hasn = self._fhasnoti
                    while nheap:
                        t, fid, epoch = nheap[0]
                        if (
                            fdone[fid]
                            or not fstarted[fid]
                            or not hasn[fid]
                            or epoch != ep[fid]
                        ):
                            heapq.heappop(nheap)
                            continue
                        if t > self.now:
                            break
                        heapq.heappop(nheap)
                        hasn[fid] = False
                        self.events_processed += 1
                        st = flows[fid]
                        if st.on_notify is not None:
                            st.on_notify(self.now)
                elif t_done <= t_evt:
                    # Batch every completion due at this instant into one
                    # settle pass: mark them all done first, then fire
                    # callbacks in deterministic (time, fid) order, then
                    # re-rate the union of their dirty closures once.
                    batch: list[int] = []
                    heap = self._done_heap
                    fdone, fstarted, ep = self._fdone, self._fstarted, self._epoch
                    while heap:
                        t, fid, epoch = heap[0]
                        if fdone[fid] or not fstarted[fid] or epoch != ep[fid]:
                            heapq.heappop(heap)
                            continue
                        if t <= self.now:
                            heapq.heappop(heap)
                            batch.append(fid)
                        else:
                            break
                    self._complete_batch(batch)
                    # A completed flow's prefix landed by definition: fire
                    # any notify that has not gone out yet (runnable <= done
                    # always), before the done callbacks.
                    if self._any_noti:
                        hasn = self._fhasnoti
                        for fid in batch:
                            if hasn[fid]:
                                hasn[fid] = False
                                self.events_processed += 1
                                st = flows[fid]
                                if st.on_notify is not None:
                                    st.on_notify(self.now)
                    for fid in batch:
                        st = flows[fid]
                        if st.on_done is not None:
                            st.on_done(self.now)
                else:
                    # Drain every event due at this instant.  Flow starts are
                    # handled per-flow in pop order (lifecycle flags, waiter
                    # releases) but their array bookkeeping is flushed in one
                    # batch; callables force a flush first so they observe
                    # fully-applied state.
                    now = self.now
                    lim = now + 1e-12
                    sts, sseq, spay = self._sts, self._sseq, self._spay
                    sptr = self._sptr
                    slen = len(spay)
                    started: list[int] = []
                    sapp = started.append
                    papp = pend.append
                    nev = 0
                    seq = self._seq
                    while True:
                        if pend:
                            for e in pend:
                                heapq.heappush(evh, e)
                            del pend[:]
                        th = evh[0] if evh else None
                        # Tie-break: everything in the heap was scheduled
                        # after the last fold, so its seq is larger than any
                        # snapshot seq — on equal times the snapshot pops
                        # first, exactly as one global (t, seq) heap would.
                        if sptr < slen and (th is None or sts[sptr] <= th[0]):
                            if sts[sptr] > lim:
                                break
                            fn = spay[sptr]
                            sptr += 1
                        elif th is not None:
                            if th[0] > lim:
                                break
                            fn = heapq.heappop(evh)[2]
                        else:
                            break
                        nev += 1
                        if type(fn) is int:
                            st = flows[fn]
                            if st.started or st.done:
                                continue
                            p = st.parent
                            if p is not None and not p.started:
                                # Gated on the parent's start (no polling);
                                # mirror of _arm_start with the seq local.
                                st.parent.waiters.append(st)
                                continue
                            st.started = True
                            st.t_start = now
                            sapp(fn)
                            # Release children waiting for this flow to start
                            # (schedule() inlined against the seq local).
                            if st.waiters:
                                for w in st.waiters:
                                    if not w.started and not w.done:
                                        t = max(
                                            w.start_after,
                                            now + w.pipeline_delay,
                                            now,
                                        )
                                        seq += 1
                                        papp((t, seq, w.fid))
                                st.waiters.clear()
                        else:
                            if started:
                                self._flush_starts(started)
                                started = []
                                sapp = started.append
                            self._seq = seq
                            fn()
                            seq = self._seq
                    self._seq = seq
                    self.events_processed += nev
                    self._sptr = sptr
                    if started:
                        self._flush_starts(started)
        finally:
            self._in_run = False

    # ------------------------------------------------------------------
    def completion_times(self) -> dict[str, float]:
        """dst vm_id -> time its payload finished arriving."""
        out: dict[str, float] = {}
        for f in self._flows:
            if f.done:
                out[f.flow.dst] = max(out.get(f.flow.dst, 0.0), f.t_done)
        return out


class VectorTorchFlowSim(VectorFlowSim):
    """Vector engine with the CUDA cap-chain kernel on its wide fronts.

    Fronts wider than ``cfg.vector_scalar_cutoff`` route the per-flow
    min-cap chain through a
    :class:`repro_torch.kernels.cap_chain.CapChainStaging` on ``cfg.device``:
    the hand-written CUDA kernel on ``"cuda"``, its plain PyTorch version on
    ``"cpu"``.  Both run in float64 with numpy's IEEE
    operations and operand order, so the event log is bit-identical to
    :class:`VectorFlowSim`, which stays the policing oracle for this tier.
    Narrow fronts keep the inherited scalar path.  ``device="cuda"`` on a
    host without CUDA raises here; the engine never falls back to the CPU.

    The engine state stays in the host's numpy arrays: the front's operands
    are gathered straight into one packed (pinned) host buffer, copied to
    the device in one copy, rated by one launch and the rates copied back
    into pinned memory, all in one call.
    """

    def __init__(self, cfg: SimConfig | None = None, *, record_rates: bool = False):
        super().__init__(cfg, record_rates=record_rates)
        import torch

        self._device = torch.device(self.cfg.device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"vector_torch engine asked for device {self.cfg.device!r}, "
                "but CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch version"
            )
        from repro_torch.kernels.cap_chain import CapChainStaging

        self._staging = CapChainStaging(self._device)
        self.dispatch_stats["fronts_torch"] = 0
        self.dispatch_stats["flows_torch"] = 0

    def _front_operands(
        self, fids: np.ndarray, src: np.ndarray, dst: np.ndarray
    ) -> tuple[np.ndarray, ...]:
        """One front's per-flow cap-chain operands, gathered on the host
        straight into the staging buffer's packed segments.

        ``(n_out, n_in, out_cap, qps, par_rate, blk)`` in the order
        :func:`~repro_torch.kernels.cap_chain.cap_chain_rates` takes them:
        views that the next front overwrites.  The parent cap is gathered as
        +inf where absent or already done, matching the numpy path's masked
        minimum.
        """
        n_out, n_in, out_cap, qps, pr, blk = ops = self._staging.segments(fids.size)
        # mode="clip": indices are in range, and "raise" buffers ``out``
        np.take(self._nout_cnt, src, out=n_out, mode="clip")
        np.take(self._nin_cnt, dst, out=n_in, mode="clip")
        np.take(self._nout_cap, src, out=out_cap, mode="clip")
        np.take(self._nqps, src, out=qps, mode="clip")
        np.take(self._fblk, fids, out=blk, mode="clip")
        par = self._fpar[fids]
        pr.fill(np.inf)
        pm = par >= 0
        if pm.any():
            pi = np.flatnonzero(pm)
            live = ~self._fdone[par[pi]]
            if not live.all():
                pi = pi[live]
            if pi.size:
                pr[pi] = self._rate[par[pi]]
        return ops

    def _front_rates(
        self, fids: np.ndarray, src: np.ndarray, dst: np.ndarray
    ) -> np.ndarray:
        cfg = self.cfg
        stats = self.dispatch_stats
        stats["fronts_torch"] += 1
        stats["flows_torch"] += int(fids.size)
        self._front_operands(fids, src, dst)
        return self._staging.rates(
            per_stream_cap=cfg.per_stream_cap,
            in_cap=cfg.vm_nic.in_cap,
            decompress_rate=cfg.decompress_rate,
            block_size=cfg.block_size,
        )
