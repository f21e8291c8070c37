"""Function Tree (FT): FaaSNet's balanced binary tree overlay (paper §3.2).

A FT is a *keyless* height-balanced binary tree whose nodes are host VMs
(or, in the TPU mapping, hosts / DP replica leaders).  Data flows from the
root — the only node allowed to touch the backing store — down parent→child
edges, so each node has at most one inbound and two outbound streams.

Differences from an AVL tree (and why):
  * Nodes carry no comparable key.  There is no ordering invariant at all —
    only the height invariant |h(left) − h(right)| ≤ 1 at every node.
  * ``insert`` therefore does not descend by key: the FT manager keeps a FIFO
    of nodes with <2 children (paper: "stores all nodes that has 0 or 1 child
    in a queue" discovered via BFS) and attaches the new node under the first.
  * ``delete`` removes an arbitrary node (a reclaimed VM, anywhere in the
    tree); the hole is plugged by promoting the *deepest-last* node (the last
    node in BFS order), which keeps the tree complete-ish and never increases
    any height.  Rebalancing then runs the four classic rotations
    (left_rotate / right_rotate / left_right_rotate / right_left_rotate)
    bottom-up from the modified point.

O(log n) slot discovery — frontier deque + open-depth index
-----------------------------------------------------------
The original implementation discovered both special slots by scanning: the
BFS-first node with <2 children (insert target) and the BFS-last node
(delete filler) were each found with a full breadth-first walk, so standing
up an n-node tree cost O(n²) node visits.  Two structures replace the scans
while producing *bit-identical* tree shapes:

  * **Open-slot frontier** (``_frontier``): while the tree is *complete* —
    i.e. it has only ever been grown by ``insert`` — the nodes with <2
    children form a contiguous suffix of BFS order and behave as a FIFO:
    attach under ``frontier[0]``, pop it once it has two children, append
    the new leaf at the back.  Insert is then O(1) for slot discovery
    (plus an O(log n) height retrace that usually exits after O(1) steps).
    Deleting the BFS-last leaf keeps the tree complete, so that case
    repairs the frontier in O(1) (pop the right end, re-open the parent);
    any other delete — and any rotation — breaks completeness and
    permanently switches the tree to the index below.
  * **Open-depth index** (``FTNode.open_depth``): every node caches the
    minimum depth, relative to itself, of a node with <2 children in its
    subtree (0 if the node itself is open).  The BFS-first open slot is
    found by descending from the root toward the child with the smaller
    ``open_depth`` (ties go left, which is exactly BFS order within a
    level), and the BFS-last node by descending toward the *taller* child
    (ties go right).  Both descents are O(log n); ``open_depth`` is
    maintained on the same bottom-up retrace that already fixes heights,
    so no asymptotic cost is added to mutations.

``on_reparent`` observers receive ``(node, old_parent, new_parent)`` for
every parent-pointer change made by rotations and the delete splice — the
FT manager uses the (old, new) pair to keep per-VM seeding-load counters
exact.  Plain insert attachment and deepest-last unlink stay silent (no
stream needs restarting), which callers rely on.

The implementation is deliberately pure-Python and allocation-light: FTs are
control-plane objects that live in the scheduler, get mutated at VM
join/leave rate, and must support thousands of instances (one per function).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterator, NamedTuple, Optional


@dataclass
class FTNode:
    """A single tree node.  ``vm_id`` identifies the host VM (or TPU host)."""

    vm_id: str
    parent: Optional["FTNode"] = None
    left: Optional["FTNode"] = None
    right: Optional["FTNode"] = None
    height: int = 1  # height of the subtree rooted here (leaf = 1)
    # min depth (relative to this node) of a subtree node with <2 children;
    # 0 whenever this node itself has an open child slot.
    open_depth: int = 0

    # -- helpers ---------------------------------------------------------
    def child_count(self) -> int:
        return (self.left is not None) + (self.right is not None)

    def children(self) -> list["FTNode"]:
        return [c for c in (self.left, self.right) if c is not None]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"FTNode({self.vm_id}, h={self.height})"


def _h(node: Optional[FTNode]) -> int:
    return node.height if node is not None else 0


def _balance(node: Optional[FTNode]) -> int:
    if node is None:
        return 0
    return _h(node.left) - _h(node.right)


class DeleteInfo(NamedTuple):
    """Structural summary of one ``delete`` (consumed by FTManager accounting).

    ``parent`` is the removed node's pre-delete parent; ``filler`` is the
    promoted deepest-last node when the hole had to be plugged (None when
    the removed node *was* the deepest-last leaf); ``filler_parent`` is the
    filler's pre-unlink parent.  All are vm_ids, None where absent.
    """

    parent: Optional[str]
    filler: Optional[str]
    filler_parent: Optional[str]


class FunctionTree:
    """A keyless height-balanced binary tree with FaaSNet's insert/delete API.

    Invariants (checked by :meth:`check_invariants`):
      I1  parent/child pointers are mutually consistent;
      I2  every node's cached height equals 1 + max(child heights);
      I3  |balance factor| ≤ 1 at every node;
      I4  ``vm_id`` values are unique within the tree;
      I5  every node's cached ``open_depth`` is consistent with its children;
      I6  while the frontier fast path is active, the frontier deque equals
          the BFS-ordered list of nodes with <2 children.
    """

    def __init__(self, function_id: str = "") -> None:
        self.function_id = function_id
        self.root: Optional[FTNode] = None
        self._nodes: dict[str, FTNode] = {}
        # Open-slot frontier: valid only while the tree is known complete
        # (grown purely by insert / deepest-last delete).  See module doc.
        self._frontier: deque[FTNode] = deque()
        self._frontier_ok: bool = True
        # Observers used by the simulator / provisioning layer to learn about
        # re-parenting events (a node whose parent changed must restart its
        # inbound stream from the new parent).  Signature:
        # ``cb(node, old_parent, new_parent)``.
        self.on_reparent: list[
            Callable[[FTNode, Optional[FTNode], Optional[FTNode]], None]
        ] = []

    # ------------------------------------------------------------------
    # Read API
    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._nodes)

    def __contains__(self, vm_id: str) -> bool:
        return vm_id in self._nodes

    def get(self, vm_id: str) -> Optional[FTNode]:
        return self._nodes.get(vm_id)

    @property
    def height(self) -> int:
        return _h(self.root)

    def bfs(self) -> Iterator[FTNode]:
        """Breadth-first traversal (paper: the manager tracks child counts via BFS)."""
        if self.root is None:
            return
        q: deque[FTNode] = deque([self.root])
        while q:
            n = q.popleft()
            yield n
            if n.left is not None:
                q.append(n.left)
            if n.right is not None:
                q.append(n.right)

    def vm_ids(self) -> list[str]:
        return [n.vm_id for n in self.bfs()]

    def parent_of(self, vm_id: str) -> Optional[str]:
        """The upstream peer a worker fetches from (None for the root)."""
        node = self._nodes[vm_id]
        return node.parent.vm_id if node.parent is not None else None

    def children_of(self, vm_id: str) -> list[str]:
        return [c.vm_id for c in self._nodes[vm_id].children()]

    def depth_of(self, vm_id: str) -> int:
        """Number of hops from the root (root = 0); O(height) = O(log n)."""
        node = self._nodes[vm_id]
        d = 0
        while node.parent is not None:
            node = node.parent
            d += 1
        return d

    def edges(self) -> list[tuple[str, str]]:
        """(parent, child) pairs — the provisioning flow graph."""
        return [
            (n.vm_id, c.vm_id) for n in self.bfs() for c in n.children()
        ]

    # ------------------------------------------------------------------
    # insert
    # ------------------------------------------------------------------
    def insert(self, vm_id: str) -> FTNode:
        """Attach ``vm_id`` under the first BFS node with <2 children.

        The very first node becomes the root (paper §3.2).  Attaching under
        the BFS-first open slot keeps a complete tree complete, hence
        balanced, so insert never triggers a rotation — but we still fix
        heights (and the open-depth index) upward.
        """
        if vm_id in self._nodes:
            raise ValueError(f"vm {vm_id!r} already in FT {self.function_id!r}")
        node = FTNode(vm_id)
        self._nodes[vm_id] = node
        if self.root is None:
            self.root = node
            if self._frontier_ok:
                self._frontier.append(node)
            return node
        parent = self._take_open_slot()
        node.parent = parent
        if parent.left is None:
            parent.left = node
        else:
            parent.right = node
        if self._frontier_ok:
            self._frontier.append(node)
            if parent.right is not None:  # parent just filled up
                self._frontier.popleft()
        self._retrace(parent)
        return node

    def _take_open_slot(self) -> FTNode:
        """BFS-first node with <2 children: frontier head or index descent."""
        if self._frontier_ok:
            return self._frontier[0]
        n = self.root
        assert n is not None
        while n.left is not None and n.right is not None:
            # Descend toward the shallower open slot; on ties go left, which
            # is the earlier node in BFS order within the level.
            if n.left.open_depth <= n.right.open_depth:
                n = n.left
            else:
                n = n.right
        return n

    # ------------------------------------------------------------------
    # delete
    # ------------------------------------------------------------------
    def delete(self, vm_id: str) -> DeleteInfo:
        """Remove ``vm_id`` (an arbitrary node) and rebalance if needed.

        Strategy: if the node is a leaf, unlink it.  Otherwise promote the
        *last BFS node* (deepest, right-most — always a leaf) into the hole.
        Then retrace from the lowest structurally-modified point, fixing
        heights and applying rotations wherever |balance| > 1.

        Returns a :class:`DeleteInfo` naming the structural roles so that
        the FT manager can maintain per-VM seed-load counters without
        re-walking the tree.
        """
        node = self._nodes.pop(vm_id, None)
        if node is None:
            raise KeyError(f"vm {vm_id!r} not in FT {self.function_id!r}")

        if len(self._nodes) == 0:
            self.root = None
            node.parent = None
            # an empty tree is trivially complete: re-arm the fast path
            self._frontier.clear()
            self._frontier_ok = True
            return DeleteInfo(None, None, None)

        parent_id = node.parent.vm_id if node.parent is not None else None
        filler = self._last_bfs_node()
        if filler is node:
            # node is the deepest-last leaf: plain unlink.  A complete tree
            # stays complete, so the frontier survives with O(1) repair.
            start = node.parent
            if self._frontier_ok:
                assert self._frontier and self._frontier[-1] is node
                self._frontier.pop()
                if start is not None and start.right is node:
                    # parent was full, regains an open slot — and it is the
                    # BFS-first one (everything before it is still full).
                    self._frontier.appendleft(start)
            self._unlink_leaf(node)
            self._retrace(start)
            return DeleteInfo(parent_id, None, None)

        # Interior (or non-last) delete: completeness is lost for good.
        self._frontier_ok = False
        self._frontier.clear()
        # Detach the filler leaf, then splice it into node's position.
        filler_parent = filler.parent
        filler_parent_id = filler_parent.vm_id if filler_parent is not None else None
        self._unlink_leaf(filler)
        start = filler_parent if filler_parent is not node else filler
        self._replace(node, filler)
        self._retrace(start)
        return DeleteInfo(parent_id, filler.vm_id, filler_parent_id)

    def _last_bfs_node(self) -> FTNode:
        """Deepest, BFS-last node via height descent (taller child, ties right)."""
        n = self.root
        assert n is not None
        while True:
            h = n.height
            if n.right is not None and n.right.height == h - 1:
                n = n.right  # right subtree reaches the deepest level
            elif n.left is not None:
                n = n.left
            else:
                return n

    def _unlink_leaf(self, leaf: FTNode) -> None:
        assert leaf.child_count() == 0, "only leaves can be unlinked"
        p = leaf.parent
        if p is None:
            self.root = None
        elif p.left is leaf:
            p.left = None
        else:
            p.right = None
        leaf.parent = None

    def _replace(self, old: FTNode, new: FTNode) -> None:
        """Put ``new`` (a detached node) where ``old`` was."""
        new.parent = old.parent
        new.left = old.left
        new.right = old.right
        if new.left is not None:
            new.left.parent = new
            self._notify_reparent(new.left, old, new)
        if new.right is not None:
            new.right.parent = new
            self._notify_reparent(new.right, old, new)
        if old.parent is None:
            self.root = new
        elif old.parent.left is old:
            old.parent.left = new
        else:
            old.parent.right = new
        new.height = old.height
        new.open_depth = old.open_depth
        self._notify_reparent(new, None, new.parent)
        old.parent = old.left = old.right = None

    # ------------------------------------------------------------------
    # Rebalancing — the four rotations (paper Figures 6 & 7)
    # ------------------------------------------------------------------
    def _retrace(self, node: Optional[FTNode]) -> None:
        """Walk from ``node`` to the root fixing heights/open-depths, rotating.

        Early exit: once a node's height *and* open_depth come out unchanged
        (and its balance is fine), every ancestor — whose cached values
        depend only on its children's — is already consistent.
        """
        while node is not None:
            old_h, old_od = node.height, node.open_depth
            self._fix(node)
            bal = _balance(node)
            if bal > 1:
                # Left-heavy.
                if _balance(node.left) >= 0:
                    node = self.right_rotate(node)
                else:
                    node = self.left_right_rotate(node)
            elif bal < -1:
                # Right-heavy.
                if _balance(node.right) <= 0:
                    node = self.left_rotate(node)
                else:
                    node = self.right_left_rotate(node)
            elif node.height == old_h and node.open_depth == old_od:
                return
            node = node.parent

    @staticmethod
    def _fix(node: FTNode) -> None:
        """Recompute the cached height and open-depth from the children."""
        l, r = node.left, node.right
        if l is None or r is None:
            node.height = 1 + (l.height if l is not None else r.height if r is not None else 0)
            node.open_depth = 0
        else:
            node.height = 1 + (l.height if l.height >= r.height else r.height)
            node.open_depth = 1 + (
                l.open_depth if l.open_depth <= r.open_depth else r.open_depth
            )

    # kept under its historical name for subclasses/tests that poke at it
    _fix_height = _fix

    def _rotate_common(self, old_sub_root: FTNode, new_sub_root: FTNode) -> None:
        """Attach ``new_sub_root`` where ``old_sub_root`` was."""
        self._frontier_ok = False  # rotations break completeness (defensive:
        self._frontier.clear()  # only reachable after a frontier-breaking delete)
        new_sub_root.parent = old_sub_root.parent
        if old_sub_root.parent is None:
            self.root = new_sub_root
        elif old_sub_root.parent.left is old_sub_root:
            old_sub_root.parent.left = new_sub_root
        else:
            old_sub_root.parent.right = new_sub_root
        self._notify_reparent(new_sub_root, old_sub_root, new_sub_root.parent)

    def left_rotate(self, x: FTNode) -> FTNode:
        """Right child ``y`` of ``x`` becomes the subtree root."""
        y = x.right
        assert y is not None
        x_parent = x.parent
        self._rotate_common(x, y)
        x.right = y.left
        if y.left is not None:
            y.left.parent = x
            self._notify_reparent(y.left, y, x)
        y.left = x
        x.parent = y
        self._notify_reparent(x, x_parent, y)
        self._fix(x)
        self._fix(y)
        return y

    def right_rotate(self, x: FTNode) -> FTNode:
        """Left child ``y`` of ``x`` becomes the subtree root (paper Fig. 6)."""
        y = x.left
        assert y is not None
        x_parent = x.parent
        self._rotate_common(x, y)
        x.left = y.right
        if y.right is not None:
            y.right.parent = x
            self._notify_reparent(y.right, y, x)
        y.right = x
        x.parent = y
        self._notify_reparent(x, x_parent, y)
        self._fix(x)
        self._fix(y)
        return y

    def left_right_rotate(self, x: FTNode) -> FTNode:
        """Left-rotate x.left, then right-rotate x."""
        assert x.left is not None
        self.left_rotate(x.left)
        return self.right_rotate(x)

    def right_left_rotate(self, x: FTNode) -> FTNode:
        """Right-rotate x.right, then left-rotate x (paper Fig. 7)."""
        assert x.right is not None
        self.right_rotate(x.right)
        return self.left_rotate(x)

    def _notify_reparent(
        self,
        node: FTNode,
        old_parent: Optional[FTNode],
        new_parent: Optional[FTNode],
    ) -> None:
        for cb in self.on_reparent:
            cb(node, old_parent, new_parent)

    # ------------------------------------------------------------------
    # Invariant checking (used by tests / hypothesis)
    # ------------------------------------------------------------------
    def check_invariants(self) -> None:
        seen: set[str] = set()
        if self.root is not None and self.root.parent is not None:
            raise AssertionError("root has a parent")
        for n in self.bfs():
            if n.vm_id in seen:
                raise AssertionError(f"duplicate vm_id {n.vm_id}")
            seen.add(n.vm_id)
            for c in n.children():
                if c.parent is not n:
                    raise AssertionError(
                        f"child {c.vm_id} of {n.vm_id} has wrong parent pointer"
                    )
            expect = 1 + max(_h(n.left), _h(n.right))
            if n.height != expect:
                raise AssertionError(
                    f"stale height at {n.vm_id}: {n.height} != {expect}"
                )
            if n.child_count() < 2:
                expect_od = 0
            else:
                expect_od = 1 + min(n.left.open_depth, n.right.open_depth)
            if n.open_depth != expect_od:
                raise AssertionError(
                    f"stale open_depth at {n.vm_id}: {n.open_depth} != {expect_od}"
                )
            if abs(_balance(n)) > 1:
                raise AssertionError(
                    f"imbalance at {n.vm_id}: balance={_balance(n)}"
                )
        if seen != set(self._nodes):
            raise AssertionError("node index out of sync with tree")
        if self._frontier_ok:
            expect_frontier = [n.vm_id for n in self.bfs() if n.child_count() < 2]
            got = [n.vm_id for n in self._frontier]
            if got != expect_frontier:
                raise AssertionError(
                    f"frontier out of sync: {got} != {expect_frontier}"
                )

    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-serializable topology snapshot (for checkpointing the manager)."""

        def rec(n: Optional[FTNode]):
            if n is None:
                return None
            return {"vm": n.vm_id, "l": rec(n.left), "r": rec(n.right)}

        return {"function_id": self.function_id, "tree": rec(self.root)}

    @classmethod
    def from_dict(cls, d: dict) -> "FunctionTree":
        ft = cls(d["function_id"])

        def rec(spec, parent):
            if spec is None:
                return None
            node = FTNode(spec["vm"], parent=parent)
            ft._nodes[node.vm_id] = node
            node.left = rec(spec["l"], node)
            node.right = rec(spec["r"], node)
            ft._fix(node)
            return node

        ft.root = rec(d["tree"], None)
        # A restored tree has arbitrary (balanced) shape: the FIFO frontier
        # is only valid for complete trees, so fall back to index descent.
        ft._frontier_ok = ft.root is None
        return ft
