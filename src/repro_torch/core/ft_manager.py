"""FT manager — the scheduler-side control plane (paper §3.3).

Responsibilities (all control-plane; no payload bytes flow through here):
  * one :class:`FunctionTree` per function id (``insert``/``delete`` API);
  * the VM pool: free pool → active pool reservation, per-instance idle
    reclaim through a pluggable :class:`~repro_torch.core.reclaim.ReclaimPolicy`
    (fixed 15-min lifespan in Alibaba's production config), failure
    detection → tree repair;
  * function→VM placement admitted by **per-function memory** (each function
    charges its ``mem_mb`` requirement against the VM's budget — one VM
    hosts many tenants' functions, paper §3.1) with the ≤
    ``max_functions_per_vm`` production limit (20) retained as a secondary
    cap, and the FT-aware placement refinement of paper §5 (prefer VMs that
    already appear in few trees / as leaves, to balance per-VM in/out
    bandwidth across overlapping FTs);
  * the ``<function_id, FT>`` metadata map, snapshottable to a dict for the
    etcd-style metadata-store sync the paper describes.

Placement is O(log V) amortized per decision: candidates live in a lazily
rebuilt min-heap keyed ``(load, seed_load, mem_used_mb, registration_index)``
(or ``(-load, -mem_used_mb, registration_index)`` for the pure binpack mode)
with stale entries dropped on pop — a VM's entry is re-pushed whenever its
key changes, so the entry matching the current key is always present.
Entries skipped for *per-function* reasons (the VM already hosts the
function, or lacks memory for this function's requirement) are pushed back:
those conditions depend on which function is being placed, so dropping the
entry would lose the VM for every other function even though its key never
changes again.  ``seed_load`` (the VM's total outbound child streams across
all trees) is maintained incrementally from
:attr:`FunctionTree.on_reparent` callbacks plus the
:class:`~repro_torch.core.function_tree.DeleteInfo` record instead of re-walking
trees.  The tie-break by registration index reproduces the original
full-pool stable sort exactly, so placement decisions are bit-identical to
the O(V log V) implementation they replace; with uniform (or zero) memory
requirements the memory key component is monotone in ``load`` and placement
is bit-identical to the pre-memory implementation.
"""
from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from .function_tree import FTNode, FunctionTree
from .reclaim import ReclaimPolicy, resolve_reclaim_policy, restore_reclaim_policy


@dataclass
class VMInfo:
    vm_id: str
    address: str = ""
    port: int = 0
    mem_mb: int = 4096  # paper §4.1: 2-CPU / 4 GB VMs
    functions: set[str] = field(default_factory=set)  # function ids placed here
    last_active: float = 0.0
    alive: bool = True
    # Per-function memory accounting (shared pool: one VM, many tenants).
    func_mem_mb: dict[str, int] = field(default_factory=dict)  # fid -> charged MB
    mem_used_mb: int = 0  # Σ func_mem_mb.values(), maintained incrementally
    # Per-instance activity (reclaim is evaluated per (function, vm) pair).
    func_last_active: dict[str, float] = field(default_factory=dict)

    def load(self) -> int:
        return len(self.functions)

    def mem_free_mb(self) -> int:
        return self.mem_mb - self.mem_used_mb


class FTManager:
    """Per-function tree + VM pool manager embedded in the FaaS scheduler."""

    def __init__(
        self,
        *,
        max_functions_per_vm: int = 20,
        vm_idle_reclaim_s: float = 15 * 60.0,
        ft_aware_placement: bool = True,
        reclaim: "str | ReclaimPolicy | None" = None,
        default_function_mem_mb: int = 0,
    ) -> None:
        self.trees: dict[str, FunctionTree] = {}
        self.vms: dict[str, VMInfo] = {}
        self.free_pool: deque[str] = deque()
        self._free_ids: set[str] = set()  # guards release→reserve→release races
        self.max_functions_per_vm = max_functions_per_vm
        self.vm_idle_reclaim_s = vm_idle_reclaim_s
        self.ft_aware_placement = ft_aware_placement
        # Reclaim policy (per function-instance); the default fixed-TTL
        # policy reproduces the legacy per-VM lifespan behaviour exactly.
        self.reclaim: ReclaimPolicy = resolve_reclaim_policy(
            reclaim, default_ttl_s=vm_idle_reclaim_s
        )
        # Per-function memory requirements (MB charged per placed instance).
        # 0 (the default) leaves placement constrained only by the flat
        # function-count cap — bit-identical to the pre-memory manager.
        self.function_mem: dict[str, int] = {}
        self.default_function_mem_mb = default_function_mem_mb
        # Scale-from-zero wave locks (request serving, cold-start herd
        # control): function id -> containers of its in-flight provisioning
        # wave still awaiting activation.  While an entry exists the serving
        # layer parks further scale-out for that function, so a cold-start
        # request herd triggers exactly ONE wave instead of a reservation
        # per queued request.  Scheduler state: rides the failover snapshot.
        self.wave_locks: dict[str, int] = {}
        # Incremental placement state --------------------------------------
        self._seed_loads: dict[str, int] = {}  # vm_id -> Σ children over trees
        self._vm_order: dict[str, int] = {}  # registration index (sort tie-break)
        self._placement_heap: list[tuple] = []  # (key..., vm_id), lazily pruned
        # Content-aware root election (§3.1): optional data-plane scorer,
        # see set_content_affinity.  Never serialized.
        self._content_affinity = None
        self._content_candidates = None
        # counters for tests / telemetry
        self.stats = {
            "inserts": 0,
            "deletes": 0,
            "repairs": 0,
            "reclaims": 0,
            "reservations": 0,
            "waves": 0,
            "content_roots": 0,
        }

    # ------------------------------------------------------------------
    # VM pool
    # ------------------------------------------------------------------
    def add_free_vm(self, vm: VMInfo) -> None:
        if vm.vm_id in self.vms:
            raise ValueError(f"vm {vm.vm_id!r} already registered")
        self.vms[vm.vm_id] = vm
        self._vm_order[vm.vm_id] = len(self._vm_order)
        self._seed_loads.setdefault(vm.vm_id, 0)
        self.free_pool.append(vm.vm_id)
        self._free_ids.add(vm.vm_id)

    def reserve_vm(self, now: float = 0.0) -> Optional[VMInfo]:
        """Move one VM from the free pool to active (scheduler scale-out)."""
        while self.free_pool:
            vm_id = self.free_pool.popleft()
            self._free_ids.discard(vm_id)
            vm = self.vms[vm_id]
            if vm.alive:
                vm.last_active = now
                self.stats["reservations"] += 1
                return vm
        return None

    def release_vm(self, vm_id: str) -> None:
        """Return an active VM (no functions left) to the free pool.

        Idempotent: a release→reserve→release churn loop (or a double
        release from two reclaim paths) never double-appends the id.
        """
        vm = self.vms[vm_id]
        assert not vm.functions, "cannot release a VM still holding functions"
        if vm.alive and vm_id not in self._free_ids:
            self.free_pool.append(vm_id)
            self._free_ids.add(vm_id)

    # ------------------------------------------------------------------
    # Tree membership (insert / delete drive everything else)
    # ------------------------------------------------------------------
    def tree(self, function_id: str) -> FunctionTree:
        if function_id not in self.trees:
            ft = FunctionTree(function_id)
            ft.on_reparent.append(self._account_reparent)
            self.trees[function_id] = ft
        return self.trees[function_id]

    def _account_reparent(
        self, node: FTNode, old_parent: Optional[FTNode], new_parent: Optional[FTNode]
    ) -> None:
        """Keep per-VM child-stream totals exact across rotations/splices."""
        if old_parent is not None:
            self._seed_load_add(old_parent.vm_id, -1)
        if new_parent is not None:
            self._seed_load_add(new_parent.vm_id, +1)

    def _seed_load_add(self, vm_id: str, delta: int) -> None:
        self._seed_loads[vm_id] = self._seed_loads.get(vm_id, 0) + delta
        self._heap_push(vm_id)

    # ------------------------------------------------------------------
    # Per-function memory requirements
    # ------------------------------------------------------------------
    def set_function_mem(self, function_id: str, mem_mb: int) -> None:
        """Register a function's per-instance memory requirement (MB)."""
        if mem_mb < 0:
            raise ValueError(f"negative memory requirement for {function_id!r}")
        self.function_mem[function_id] = int(mem_mb)

    def mem_need(self, function_id: str) -> int:
        return self.function_mem.get(function_id, self.default_function_mem_mb)

    def insert(self, function_id: str, vm_id: str, now: float = 0.0) -> str | None:
        """Add ``vm_id`` to the function's FT; returns the upstream peer id.

        Admission is by memory: the function's requirement must fit in the
        VM's free memory (the flat ``max_functions_per_vm`` production cap
        is retained as a secondary limit).  Returns ``None`` when the new
        node is the root (it will fetch from the registry / backing store
        instead of a peer).
        """
        vm = self.vms[vm_id]
        if len(vm.functions) >= self.max_functions_per_vm:
            raise RuntimeError(
                f"placement limit: vm {vm_id} already holds "
                f"{len(vm.functions)} functions"
            )
        need = self.mem_need(function_id)
        if vm.mem_used_mb + need > vm.mem_mb:
            raise RuntimeError(
                f"memory limit: vm {vm_id} has {vm.mem_free_mb()} MB free, "
                f"{function_id} needs {need} MB"
            )
        ft = self.tree(function_id)
        ft.insert(vm_id)
        vm.functions.add(function_id)
        vm.func_mem_mb[function_id] = need
        vm.mem_used_mb += need
        vm.func_last_active[function_id] = now
        vm.last_active = now
        self.stats["inserts"] += 1
        up = ft.parent_of(vm_id)
        if up is not None:
            self._seed_load_add(up, +1)  # attach is silent on on_reparent
        self._heap_push(vm_id)
        return up

    def bulk_insert(
        self, function_id: str, vm_ids: list[str], now: float = 0.0
    ) -> FunctionTree:
        """Insert many VMs into one function's FT (burst scale-out).

        Used by the scale harness (``repro_torch.sim.scale``) to stand up the
        paper's §4.2 thousand-VM waves; semantically identical to calling
        :meth:`insert` in a loop, returns the tree for convenience.
        """
        for vm_id in vm_ids:
            self.insert(function_id, vm_id, now)
        return self.trees[function_id]

    def delete(self, function_id: str, vm_id: str) -> None:
        ft = self.trees[function_id]
        info = ft.delete(vm_id)
        # Silent structural changes (see FunctionTree.delete): the victim
        # leaves its parent, and — when a filler was promoted — the filler
        # leaves its own pre-unlink parent.  Rotations/splices already fired
        # on_reparent with exact (old, new) pairs.
        if info.parent is not None:
            self._seed_load_add(info.parent, -1)
        if info.filler is not None and info.filler_parent is not None:
            self._seed_load_add(info.filler_parent, -1)
        vm = self.vms[vm_id]
        vm.functions.discard(function_id)
        vm.mem_used_mb -= vm.func_mem_mb.pop(function_id, 0)
        vm.func_last_active.pop(function_id, None)
        self._heap_push(vm_id)
        self.stats["deletes"] += 1
        if len(ft) == 0:
            del self.trees[function_id]

    def touch_instance(self, function_id: str, vm_id: str, now: float) -> None:
        """An instance served a request: refresh its (and its VM's) clock."""
        vm = self.vms[vm_id]
        if now > vm.last_active:
            vm.last_active = now
        if function_id in vm.functions:
            vm.func_last_active[function_id] = max(
                vm.func_last_active.get(function_id, 0.0), now
            )

    # ------------------------------------------------------------------
    # Placement (paper §3.3 "Function Placement on VMs" + §5 FT-aware)
    # ------------------------------------------------------------------
    def _heap_key(self, vm: VMInfo) -> tuple:
        # The memory component sits after (load, seed_load) so that with
        # uniform requirements (mem_used == load * mem) it is monotone in
        # load and the ordering — hence every placement decision — is
        # bit-identical to the pre-memory key.  With heterogeneous
        # requirements it prefers memory-lighter VMs (FT-aware) or packs
        # memory-fuller ones first (binpack).
        if self.ft_aware_placement:
            return (
                len(vm.functions),
                self._seed_loads.get(vm.vm_id, 0),
                vm.mem_used_mb,
                self._vm_order[vm.vm_id],
            )
        return (  # binpack: fullest first
            -len(vm.functions),
            -vm.mem_used_mb,
            self._vm_order[vm.vm_id],
        )

    def _heap_push(self, vm_id: str) -> None:
        vm = self.vms.get(vm_id)
        if vm is None or not vm.alive or not vm.functions:
            return  # never a placement candidate until its key next changes
        heapq.heappush(self._placement_heap, self._heap_key(vm) + (vm_id,))

    def _rebuild_heap(self) -> None:
        self._placement_heap = [
            self._heap_key(vm) + (vm.vm_id,)
            for vm in self.vms.values()
            if vm.alive and vm.functions
        ]
        heapq.heapify(self._placement_heap)

    def set_content_affinity(self, fn, candidates=None) -> None:
        """Attach a content-residency scorer for root election (§3.1).

        ``fn(function_id, vm_id) -> int`` reports how many bytes of the
        function's image are already resident on a VM (e.g.
        ``BlockCache.resident_bytes``).  When a function's *first* instance
        is placed — root election; the root fetches from the registry, so
        starting it where the base layers already live saves the most
        backbone traffic — :meth:`pick_vm_for` prefers the admissible VM
        with the most resident bytes and falls back to the normal placement
        path when nothing scores above zero.  The scorer is data-plane
        state: it does not ride :meth:`snapshot`, re-attach after restore.

        ``candidates`` (optional, ``() -> iterable[vm_id]``) bounds the
        election scan to VMs that can possibly score above zero — e.g.
        ``BlockCache.vms`` — instead of the whole fleet.  Any VM outside
        the candidate set must score 0 (it would be skipped anyway), so
        the election result is unchanged; on a 100k-VM pool this turns an
        O(fleet) scan per reservation into O(warm VMs).
        """
        self._content_affinity = fn
        self._content_candidates = candidates

    def _content_root_for(self, function_id: str, now: float) -> Optional[VMInfo]:
        """Root election: the admissible VM holding the most image bytes."""
        need = self.mem_need(function_id)
        best: Optional[VMInfo] = None
        best_key: Optional[tuple] = None
        if self._content_candidates is not None:
            vms = self.vms
            scan = [
                (vid, vms[vid]) for vid in self._content_candidates()
                if vid in vms
            ]
        else:
            scan = self.vms.items()
        for vm_id, vm in scan:
            if not vm.alive or function_id in vm.functions:
                continue
            if len(vm.functions) >= self.max_functions_per_vm:
                continue
            if vm.mem_used_mb + need > vm.mem_mb:
                continue
            resident = int(self._content_affinity(function_id, vm_id))
            if resident <= 0:
                continue
            key = (
                -resident,
                len(vm.functions),
                self._seed_loads.get(vm_id, 0),
                self._vm_order[vm_id],
            )
            if best_key is None or key < best_key:
                best_key, best = key, vm
        if best is None:
            return None
        if best.vm_id in self._free_ids:
            # promote the warm-cache VM straight out of the free pool; the
            # deque keeps FIFO order for everyone else
            self.free_pool.remove(best.vm_id)
            self._free_ids.discard(best.vm_id)
            self.stats["reservations"] += 1
        best.last_active = now
        self.stats["content_roots"] += 1
        return best

    def pick_vm_for(self, function_id: str, now: float = 0.0) -> Optional[VMInfo]:
        """Choose a host for a new instance of ``function_id``.

        Admission is by memory: the VM must have ``mem_need(function_id)``
        MB free (plus a spare slot under the flat production cap) and must
        not already host this function.  Binpacking baseline: the fullest
        such VM.  FT-aware refinement (§5): prefer the VM currently
        involved in the fewest trees and, among those, one that is a leaf
        in most of its trees — leaves have zero outbound seeding load, so
        adding an inbound stream there balances bandwidth.  Falls back to
        reserving a free VM.

        Amortized O(log V): pops the lazily pruned candidate heap until an
        entry matches its VM's current key.  Entries skipped for
        *per-function* reasons — the VM already hosts ``function_id``, or
        its free memory is below *this* function's requirement — are pushed
        back afterwards: both conditions can differ for the next function
        placed while the VM's key stays unchanged (so no re-push would ever
        revive a dropped entry).  Entries failing the function-count cap
        may be dropped safely: any change to the count changes the key and
        re-pushes a live entry.
        """
        if self._content_affinity is not None and function_id not in self.trees:
            vm = self._content_root_for(function_id, now)
            if vm is not None:
                return vm
        if len(self._placement_heap) > max(64, 4 * len(self.vms)):
            self._rebuild_heap()  # mostly-stale heap: rebuild and re-amortize
        need = self.mem_need(function_id)
        heap = self._placement_heap
        skipped: list[tuple] = []
        winner: Optional[VMInfo] = None
        seen: set[str] = set()
        while heap:
            entry = heapq.heappop(heap)
            vm_id = entry[-1]
            vm = self.vms[vm_id]
            if (
                not vm.alive
                or not vm.functions
                or len(vm.functions) >= self.max_functions_per_vm
                or entry[:-1] != self._heap_key(vm)
            ):
                continue  # stale or ineligible: the live entry is elsewhere
            if function_id in vm.functions or vm.mem_used_mb + need > vm.mem_mb:
                if vm_id not in seen:  # keep exactly one live entry per VM
                    seen.add(vm_id)
                    skipped.append(entry)
                continue
            winner = vm
            skipped.append(entry)  # picking does not mutate state: keep it live
            break
        for entry in skipped:
            heapq.heappush(heap, entry)
        if winner is not None:
            return winner
        return self.reserve_vm(now)

    def _seed_load(self, vm_id: str) -> int:
        """Total number of downstream children across all trees (outbound streams)."""
        return self._seed_loads.get(vm_id, 0)

    def _seed_load_recompute(self, vm_id: str) -> int:
        """Reference (tree-walking) seed load — used by restore and tests."""
        n = 0
        for fid in self.vms[vm_id].functions:
            ft = self.trees.get(fid)
            if ft is not None and vm_id in ft:
                n += len(ft.children_of(vm_id))
        return n

    # ------------------------------------------------------------------
    # Provisioning-wave locks (request serving: cold-start herd control)
    # ------------------------------------------------------------------
    def wave_active(self, function_id: str) -> bool:
        """True while a provisioning wave is in flight for the function."""
        return function_id in self.wave_locks

    def wave_open(self, function_id: str, n: int) -> None:
        """Open the per-function wave lock: ``n`` containers now in flight.

        The serving layer opens one lock per scale-out decision and parks
        all further scale-out for the function until every container of the
        wave has activated — the thundering-herd gate that turns a
        10k-request cold burst into exactly one wave.  The pending count is
        scheduler state and rides :meth:`snapshot`, so a restored scheduler
        keeps the herd parked until the surviving data-plane streams land.
        """
        if n <= 0:
            raise ValueError(f"wave for {function_id!r} needs n >= 1, got {n}")
        if function_id in self.wave_locks:
            raise RuntimeError(f"wave already in flight for {function_id!r}")
        self.wave_locks[function_id] = n
        self.stats["waves"] += 1

    def wave_landed(self, function_id: str) -> bool:
        """One wave container activated; True when the whole wave landed.

        A no-op (returns False) for functions without an open lock — e.g.
        containers provisioned by the naive per-deficit admission path.
        """
        pending = self.wave_locks.get(function_id)
        if pending is None:
            return False
        if pending <= 1:
            del self.wave_locks[function_id]
            return True
        self.wave_locks[function_id] = pending - 1
        return False

    # ------------------------------------------------------------------
    # Reclaim + failure handling (paper §3.2 delete, §3.3 fault tolerance)
    # ------------------------------------------------------------------
    def reclaim_instance(self, function_id: str, vm_id: str) -> bool:
        """Reclaim ONE function instance; release the VM once it empties.

        The single accounting path for every reclaim decision — the policy
        loop below and the trace replay both route through here, so the
        ``reclaims`` counter can never drift between them.  Returns True
        when the VM was returned to the free pool (no instances left).
        """
        self.delete(function_id, vm_id)
        self.stats["reclaims"] += 1
        vm = self.vms[vm_id]
        if not vm.functions and vm.alive:
            self.release_vm(vm_id)
            return True
        return False

    def reclaim_idle(self, now: float) -> list[str]:
        """Apply the reclaim policy to every idle instance (paper §3.2).

        Each ``(function, vm)`` instance ages independently — on a shared
        pool one VM hosts several tenants' instances and reclaiming one
        must not evict the others.  A VM with no instances left returns to
        the free pool; the list of such fully-released VM ids is returned.
        An instance's clock is its ``func_last_active`` entry (set at insert,
        refreshed by :meth:`touch_instance`); instances restored from legacy
        snapshots without per-instance records fall back to the VM-level
        ``last_active``.
        """
        released = []
        for vm in list(self.vms.values()):
            if not vm.alive or not vm.functions:
                continue
            freed = False
            for fid in sorted(vm.functions):  # deterministic eviction order
                last = vm.func_last_active.get(fid, vm.last_active)
                if self.reclaim.should_reclaim(fid, now - last, now):
                    freed = self.reclaim_instance(fid, vm.vm_id)
            if freed:
                released.append(vm.vm_id)
        return released

    def on_vm_failure(self, vm_id: str) -> list[str]:
        """Heartbeat miss: drop the VM from every tree it belongs to.

        Returns the list of function ids whose trees were repaired — the
        provisioning layer must restart the inbound streams of any node
        whose parent changed (it learns those via FunctionTree.on_reparent).
        """
        vm = self.vms[vm_id]
        vm.alive = False
        repaired = []
        for fid in list(vm.functions):
            self.delete(fid, vm_id)
            self.stats["repairs"] += 1
            repaired.append(fid)
        vm.functions.clear()
        vm.func_mem_mb.clear()
        vm.func_last_active.clear()
        vm.mem_used_mb = 0
        return repaired

    # ------------------------------------------------------------------
    # Telemetry
    # ------------------------------------------------------------------
    def tree_stats(self) -> dict[str, dict[str, int]]:
        """Per-function tree size/height — the scale harness's sanity report."""
        return {
            fid: {"size": len(ft), "height": ft.height}
            for fid, ft in self.trees.items()
        }

    # ------------------------------------------------------------------
    # Metadata-store sync (paper: scheduler shards sync with etcd)
    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-serializable full control-plane state (scheduler failover).

        Everything a stand-in scheduler shard needs to continue *bit-
        identically* is captured: tree topologies, per-VM records, the free
        pool in FIFO order, the VM registration order (``_vm_order`` is the
        placement tie-break, so it must survive the wire), per-VM memory
        occupancy (charged MB and last-active clock per instance — a shared
        pool restored without them would re-admit functions a live VM has no
        room for), the per-function memory requirements, the reclaim-policy
        state (a predictive policy's learned histograms must keep learning
        from where they stopped), and the telemetry counters (so
        reclaim/repair accounting stays continuous across the failover).
        The snapshot format is the JAX package's: a snapshot it wrote
        restores here after a ``json.dumps`` round trip and continues
        identically (``tests/test_torch_vector_engine.py``).
        """
        order = sorted(self._vm_order, key=self._vm_order.__getitem__)
        return {
            "trees": {fid: ft.to_dict() for fid, ft in self.trees.items()},
            "vms": {
                vid: {
                    "address": vm.address,
                    "port": vm.port,
                    "mem_mb": vm.mem_mb,
                    "functions": sorted(vm.functions),
                    "alive": vm.alive,
                    "last_active": vm.last_active,
                    "func_mem_mb": {
                        fid: vm.func_mem_mb[fid] for fid in sorted(vm.func_mem_mb)
                    },
                    "func_last_active": {
                        fid: vm.func_last_active[fid]
                        for fid in sorted(vm.func_last_active)
                    },
                }
                for vid, vm in self.vms.items()
            },
            "free_pool": list(self.free_pool),
            "vm_order": order,
            "stats": dict(self.stats),
            "function_mem": dict(sorted(self.function_mem.items())),
            "default_function_mem_mb": self.default_function_mem_mb,
            "reclaim": self.reclaim.snapshot(),
            # In-flight provisioning waves (cold-start herd control): a
            # restored scheduler must keep parked request herds parked.
            "wave_locks": {fid: self.wave_locks[fid] for fid in sorted(self.wave_locks)},
        }

    @classmethod
    def restore(cls, snap: dict, **kwargs) -> "FTManager":
        mgr = cls(**kwargs)
        # Legacy snapshots predate per-function memory and pluggable reclaim:
        # missing keys restore the pre-refactor defaults (zero charged
        # memory, fixed-TTL policy from the caller's kwargs).
        mgr.function_mem = {
            fid: int(m) for fid, m in snap.get("function_mem", {}).items()
        }
        mgr.default_function_mem_mb = snap.get(
            "default_function_mem_mb", mgr.default_function_mem_mb
        )
        # Only the snapshot's recorded policy overrides the ctor-built one:
        # a legacy snapshot (no "reclaim" key) restored with an explicit
        # reclaim= kwarg keeps the caller's requested policy.
        if "reclaim" in snap:
            mgr.reclaim = restore_reclaim_policy(
                snap["reclaim"], default_ttl_s=mgr.vm_idle_reclaim_s
            )
        # Legacy (pre-serving) snapshots carry no wave locks: none in flight.
        mgr.wave_locks = {
            fid: int(n) for fid, n in snap.get("wave_locks", {}).items()
        }
        # Registration order is authoritative when recorded; older snapshots
        # fall back to the (insertion-ordered) vms mapping itself.
        for vid in snap.get("vm_order", snap["vms"]):
            mgr._vm_order[vid] = len(mgr._vm_order)
        for vid, v in snap["vms"].items():
            func_mem = {fid: int(m) for fid, m in v.get("func_mem_mb", {}).items()}
            mgr.vms[vid] = VMInfo(
                vm_id=vid,
                address=v["address"],
                port=v["port"],
                mem_mb=v.get("mem_mb", 4096),
                functions=set(v["functions"]),
                last_active=v["last_active"],
                alive=v["alive"],
                func_mem_mb=func_mem,
                mem_used_mb=sum(func_mem.values()),
                func_last_active=dict(v.get("func_last_active", {})),
            )
            mgr._vm_order.setdefault(vid, len(mgr._vm_order))
        mgr.free_pool = deque(snap["free_pool"])
        mgr._free_ids = set(mgr.free_pool)
        mgr.stats.update(snap.get("stats", {}))
        from .function_tree import FunctionTree as FT

        for fid, d in snap["trees"].items():
            ft = FT.from_dict(d)
            ft.on_reparent.append(mgr._account_reparent)
            mgr.trees[fid] = ft
        for vid in mgr.vms:
            mgr._seed_loads[vid] = mgr._seed_load_recompute(vid)
            mgr._heap_push(vid)
        return mgr
