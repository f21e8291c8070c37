"""Roofline accounting for the port: counted from the ops it dispatches.

The JAX package reads its roofline terms from compiled HLO text
(``repro/launch/hlo_analysis.py``: ``parse_hlo`` and ``analyze_hlo`` walk
the call graph and scale loop bodies by their trip counts).  PyTorch
compiles nothing here, so the port has no HLO to parse and no counterpart
of ``parse_hlo`` / ``analyze_hlo``, as it has none of ``compat.py``.
Instead :func:`analyze_callable` runs a callable, usually on ``device="meta"``
tensors that allocate nothing, under a ``TorchDispatchMode`` and counts
every aten op it dispatches:

  * FLOPs   = what ``torch.utils.flop_counter.FlopCounterMode`` counts
              (2·M·N·K per matmul-like op, as ``_dot_flops`` counts a
              ``dot``; elementwise ignored), the backward pass and the
              recompute of remat blocks included when they run inside;
  * bytes   = Σ over dispatched ops of their tensor inputs plus their
              tensor outputs, views and metadata ops skipped
              (:data:`_SKIP_BYTES`, the counterpart of the reference's),
              and so are ops on host (CPU) tensors alone and copies from
              the host, which are not traffic of the card's memory.
              This is the HBM traffic of the port's eager program, which
              launches one kernel per op and fuses nothing: it is not
              XLA's count after fusion, and it over-counts in-place ops
              (their target is both an input and the output).  With no
              fusion view there is nothing to tell ``bytes_raw`` from
              ``bytes_accessed``: the two are equal.

Collectives are not dispatched ops on one card.  ``launch/dryrun.py``
derives the train step's ZeRO-1 traffic from the constraints
``distributed/api.py`` records, and :class:`ShardingTracker`, a byte
counter that also follows every tensor's layout over the mesh from the
seeded arguments and the constraints, op by op, backward pass included,
derives the tensor-parallel traffic that XLA's SPMD partitioner inserts: it
writes down a :class:`Collective` wherever the layout asks for one.

The roofline constants are an H100 SXM's (data sheet, dense, no sparsity).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

_aten = torch.ops.aten
# ops that move no data though the schema does not mark them as views:
# allocation (its bytes are written by the op that fills them), the
# view-like reshape of a matmul's output, and metadata reads
_SKIP_BYTES = {
    _aten._unsafe_view, _aten.empty, _aten.empty_strided, _aten.empty_like,
    _aten.new_empty, _aten.new_empty_strided, _aten.lift_fresh,
}


def _skip_bytes(func, args, kwargs) -> bool:
    if func.is_view or func.overloadpacket in _SKIP_BYTES:
        return True
    if func.overloadpacket is _aten._to_copy:
        # a copy from the host crosses PCIe, not the card's memory; a cast to
        # the same dtype and device is an alias
        src = args[0]
        return src.device.type == "cpu" or (
            kwargs.get("dtype", src.dtype) == src.dtype
            and torch.device(kwargs.get("device") or src.device) == src.device)
    return False


def _tensors(tree, out: list | None = None) -> list[torch.Tensor]:
    """The tensors in an op's (nested tuple, list or dict of) arguments."""
    out = [] if out is None else out
    if isinstance(tree, dict):
        tree = tuple(tree.values())
    elif not isinstance(tree, (tuple, list)):
        tree = (tree,)
    for x in tree:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list, dict)):
            _tensors(x, out)
    return out


class _ByteCounter(TorchDispatchMode):
    """Tensor bytes in and out of every dispatched op that moves data on the
    device: an op with a tensor output and a tensor off the host.  Host-side
    ops (a table computed once on the CPU and cached, a position read back)
    are not device traffic."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs, ins = _tensors(out), _tensors((args, kwargs))
        if (outs and any(t.device.type != "cpu" for t in outs + ins)
                and not _skip_bytes(func, args, kwargs)):
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        self._dispatched(func, args, kwargs, ins, outs)
        return out

    def _dispatched(self, func, args, kwargs, ins, outs) -> None:
        """Called after every op with its tensor arguments and results."""


@dataclass
class HloStats:
    """The reference's record, filled from dispatched ops (see the module
    docstring) and the collectives the dry run derives."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    bytes_raw: float = 0.0  # equal to bytes_accessed: the port fuses nothing
    collective_bytes: float = 0.0
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    def add_collective(self, kind: str, n_bytes: float, count: float = 1) -> None:
        self.collective_bytes += n_bytes
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + n_bytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + count

    def to_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "bytes_raw": self.bytes_raw,
            "collective_bytes": self.collective_bytes,
            "bytes_by_kind": dict(self.bytes_by_kind),
            "count_by_kind": dict(self.count_by_kind),
        }


def analyze_callable(fn: Callable, *args, tracker: "ShardingTracker | None" = None,
                     **kwargs) -> tuple[HloStats, object]:
    """Run ``fn(*args, **kwargs)`` under the counting modes; returns (its
    whole-program FLOPs and bytes, its result).  Run a train step's
    backward inside ``fn``, or its FLOPs (remat recompute included) go
    uncounted.  With a seeded ``tracker``, it runs beside them and observes
    every constraint; its collectives are in ``tracker.collectives``."""
    from repro_torch.distributed.api import observe_constraints

    bytes_mode = _ByteCounter() if tracker is None else tracker  # a tracker counts bytes too
    with FlopCounterMode(display=False) as flops_mode, bytes_mode, \
            observe_constraints(tracker) if tracker is not None else contextlib.nullcontext():
        out = fn(*args, **kwargs)
    if tracker is not None:
        tracker.finish(out)
    n_bytes = float(bytes_mode.bytes)
    return HloStats(flops=float(flops_mode.get_total_flops()), bytes_accessed=n_bytes,
                    bytes_raw=n_bytes), out


# ----------------------------------------------------------------------
# Tensor-parallel collectives: a sharding tracker
# ----------------------------------------------------------------------
MODEL = "model"
DATA = "data"  # the data axes ("pod", "data") of a mesh, as one logical axis
_DATA_AXES = ("pod", "data")
# what the tracker emits over: the model axis.  The data axes' traffic is the
# train step's gradient and param traffic, which dryrun.zero1_collectives prices.
OVER = (MODEL,)


@dataclass(frozen=True)
class Collective:
    """One collective XLA's SPMD partitioner would insert, in global terms:
    its operand's whole ``shape`` and ``dtype``, the logical axes each dim of
    one device's operand is split over (``spec``), the axes it runs over and
    the op (an aten op, or ``"constraint:<site>"``) that asked for it."""

    kind: str  # "all-reduce" | "reduce-scatter" | "all-gather" | "all-to-all"
    shape: tuple[int, ...]
    dtype: torch.dtype
    spec: tuple[tuple[str, ...], ...]
    op: str
    over: tuple[str, ...] = OVER

    def shard_bytes(self, sizes: dict) -> int:
        """One device's operand bytes on a mesh with these logical axis sizes
        (a dim that does not split evenly is padded, as XLA pads it)."""
        n = 1
        for size, axes in zip(self.shape, self.spec):
            n *= -(-size // math.prod(sizes.get(a, 1) for a in axes))
        return n * self.dtype.itemsize


def logical_spec(spec, ndim: int, sizes: dict) -> tuple[tuple[str, ...], ...]:
    """A ``PartitionSpec`` as one tuple of logical axes per dim: every data
    axis is ``"data"``, and an axis of size 1 splits nothing."""
    out = []
    for i in range(ndim):
        part = spec[i] if i < len(spec) else None
        names = (part,) if isinstance(part, str) else tuple(part or ())
        axes = dict.fromkeys(DATA if a in _DATA_AXES else a for a in names)
        out.append(tuple(a for a in axes if sizes.get(a, 1) > 1))
    return tuple(out)


def _sid(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata




def _dims(dim, ndim: int) -> list[int]:
    if dim is None or (isinstance(dim, (list, tuple)) and len(dim) == 0):
        return list(range(ndim))
    dims = dim if isinstance(dim, (list, tuple)) else [dim]
    return [d % max(ndim, 1) for d in dims]


def _sanitize(place: list) -> tuple:
    """Each axis splits one dim at most: the first that names it keeps it."""
    flat = [a for axes in place for a in axes]
    if len(flat) == len(set(flat)):
        return tuple(place)
    seen, out = set(), []
    for axes in place:
        keep = tuple(a for a in axes if a not in seen)
        seen.update(keep)
        out.append(keep)
    return tuple(out)


def _union(*axes_lists) -> tuple[str, ...]:
    """The axes of every list, in the order they first appear (a dim's axes
    run major to minor)."""
    return tuple(dict.fromkeys(a for axes in axes_lists for a in axes))


def _reshape(in_shape, place, out_shape, sizes: dict) -> tuple:
    """The layout after a reshape.  Each in-dim is a run of factors, major
    to minor: its split axes (each of its size), then the rest of the dim;
    a group of in-dims and the out-dims they reshape to share one run, which
    the out-dims take in order.  So a merge keeps every split on the merged
    dim, and a split puts each axis on the piece it lands in."""
    out = [()] * len(out_shape)
    if 0 in in_shape or 0 in out_shape:
        return tuple(out)
    i = j = 0
    n_in, n_out = len(in_shape), len(out_shape)
    while i < n_in and j < n_out:
        ii, jj = [i], [j]
        pi, pj = in_shape[i], out_shape[j]
        i, j = i + 1, j + 1
        while pi != pj:
            if pi < pj and i < n_in:
                pi *= in_shape[i]
                ii.append(i)
                i += 1
            elif pj < pi and j < n_out:
                pj *= out_shape[j]
                jj.append(j)
                j += 1
            else:
                return tuple(out)
        if len(ii) == 1 and len(jj) == 1:
            out[jj[0]] = place[ii[0]]
            continue
        factors = []  # (axis or None, size)
        for k in ii:
            rest = in_shape[k]
            for a in place[k]:  # an axis larger than what is left of the dim pads it
                size = min(sizes.get(a, 1), rest)
                factors.append((a, size))
                rest //= size
            factors.append((None, rest))
        for jd in jj:
            cap, axes = out_shape[jd], []
            while factors and cap > 1:
                a, size = factors[0]
                if a is None:
                    g = math.gcd(size, cap)
                    if size == 1 or g > 1:
                        cap //= g
                        factors[0] = (None, size // g)
                        if size // g == 1:
                            factors.pop(0)
                        continue
                    break
                if cap % size and (axes or size < cap):
                    break  # the next piece takes it
                axes.append(a)  # an axis larger than an unsplit piece splits it, padded
                cap = cap // size if cap % size == 0 else 1
                factors.pop(0)
            out[jd] = tuple(axes)
        left = tuple(a for a, _ in factors if a is not None)  # padded: on the last piece
        if left:
            last = max((jd for jd in jj if out_shape[jd] > 1), default=jj[-1])
            out[last] = _union(out[last], left)
    return _sanitize(out)


_LAYOUT = "_sharding_layout"  # (tracker, layout) on a tensor the tracker laid out
_aten = torch.ops.aten
# ops whose output aliases their input's storage or copies it unchanged: a
# partial sum passes through them (XLA reduces it where the dot produced it)
_PASS = {_aten.view, _aten._unsafe_view, _aten.alias, _aten.detach, _aten.clone,
         _aten.permute, _aten.transpose, _aten.t, _aten.expand, _aten.select, _aten.slice,
         _aten.squeeze, _aten.unsqueeze, _aten.lift_fresh}
_SHAPE_ONLY = {_aten.view, _aten._unsafe_view, _aten.squeeze, _aten.unsqueeze}
_SAME = {_aten.alias, _aten.detach, _aten.clone, _aten.lift_fresh,
         _aten.slice, _aten.constant_pad_nd, _aten.flip, _aten.roll, _aten.tril,
         _aten.triu, _aten.zeros_like, _aten.ones_like, _aten.full_like,
         _aten.empty_like, _aten.slice_backward, _aten.fill_, _aten.copy_}
_FACTORY = {_aten.zeros, _aten.ones, _aten.full, _aten.empty, _aten.empty_strided,
            _aten.arange, _aten.scalar_tensor, _aten.new_zeros, _aten.new_ones,
            _aten.new_full, _aten.new_empty, _aten.new_empty_strided}
_MATMUL = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm}
_LINEAR_REDUCE = {_aten.sum, _aten.mean}
_SCATTER = {_aten.scatter, _aten.scatter_, _aten.scatter_add, _aten.scatter_add_,
            _aten.index_add, _aten.index_add_, _aten.index_put, _aten.index_put_,
            _aten._index_put_impl_, _aten.index_copy, _aten.index_copy_}
_NO_LAYOUT = {_aten._local_scalar_dense, _aten.equal}


class ShardingTracker(_ByteCounter):
    """Every tensor's layout over a mesh, followed through the ops a program
    dispatches; the collectives XLA's SPMD partitioner would insert for them
    over the model axis, in ``collectives``.

    A layout is, per dim, the logical mesh axes it is split over (``"data"``
    and ``"model"``, of sizes ``sizes``), kept on the tensor object, plus,
    per storage, whether it holds a partial sum over ``"model"``.  A tensor
    no op or seed laid out (a saved output autograd hands back as a new
    object) reads as replicated.  Arguments are seeded with
    :meth:`seed`; constraints come in through ``distributed/api.py``'s
    observer hook (``self(x, named, site)``), and under autograd the
    constraint's transpose constrains the cotangent to the same layout, as
    in JAX.  Per op:

      * a matmul (``mm``, ``bmm``, ``addmm``, ``baddbmm``: what ``einsum``
        lowers to) whose contracted dim is split over ``"model"`` gives a
        partial sum; its other dims keep their operands' splits;
      * an elementwise op unions its operands' splits, broadcasting; a view
        or reshape carries them; a ``sum`` or ``mean`` over a dim split over
        ``"model"`` gives a partial sum, an ``amax`` or ``logsumexp`` over
        one an all-reduce of its result (two for ``logsumexp``: max, then
        sum), a softmax over one two all-reduces of the reduced shape (its
        backward one);
      * a gather (``index``, ``gather``, ``index_select``) from a tensor
        split over ``"model"`` along the gathered dim gives a partial sum
        (a masked local gather, as XLA gathers from the vocab-sharded
        embedding);
      * a partial sum read by any op but a view or a clone costs one all-reduce
        of its per-device shard, where it is read;
      * at a constraint, a partial sum costs one reduce-scatter if the
        constraint splits it over ``"model"``, else one all-reduce; a value
        split over ``"model"`` and constrained to a layout without that
        split costs one all-gather (an all-to-all where it moves the split
        to another dim).  The operand's data splits are the constraint's;
      * the program's results (:meth:`finish`): a partial sum costs an
        all-reduce, a padded split over ``"model"`` an all-gather.

    It is a byte counter too: one dispatch mode does both.  Each
    collective is priced as its operand's bytes in the tensor's own
    dtype, the reference analyser's convention; the model axis's traffic
    alone, as data-axis traffic is ZeRO-1's.  Reductions over data splits are
    dropped, the local work of the reference's per-shard programs.  With a
    model axis of size 1 nothing is followed.
    """

    def __init__(self, sizes: dict):
        super().__init__()
        self.sizes = dict(sizes)
        self.active = self.sizes.get(MODEL, 1) > 1
        self.partial: set = set()  # storage ids holding a partial sum over "model"
        self.collectives: list[Collective] = []
        self.fallbacks: dict = {}  # op -> calls that no rule covered (diagnostics)
        self._whole: dict = {}  # ndim -> the replicated layout

    # -- layouts ---------------------------------------------------------
    def layout(self, t: torch.Tensor) -> tuple:
        got = t.__dict__.get(_LAYOUT)
        if got is not None and got[0] is self:
            return got[1]
        n = t.dim()
        whole = self._whole.get(n)
        if whole is None:
            whole = self._whole[n] = ((),) * n
        return whole

    def _set(self, t: torch.Tensor, layout: tuple) -> None:
        t.__dict__[_LAYOUT] = (self, layout)

    def seed(self, tree, shardings) -> None:
        """Lay the leaves of ``tree`` out as ``shardings`` (a tree of
        ``NamedSharding`` of the same structure) says."""
        from repro_torch.models.params import tree_leaves_with_path

        leaves = [x for _, x in tree_leaves_with_path(tree)]
        named = [s for _, s in tree_leaves_with_path(shardings)]
        for x, s in zip(leaves, named):
            if isinstance(x, torch.Tensor):
                self._set(x, logical_spec(s.spec, x.dim(), self.sizes))

    # -- collectives -----------------------------------------------------
    def _emit(self, kind: str, t: torch.Tensor, spec: tuple, op: str) -> None:
        self.collectives.append(Collective(kind, tuple(t.shape), t.dtype, spec, op))

    def _reduce(self, t: torch.Tensor, op: str) -> None:
        """An all-reduce of ``t``'s partial storage, read by ``op``."""
        sid = _sid(t)
        if sid in self.partial:
            self.partial.discard(sid)
            self._emit("all-reduce", t, self.layout(t), op)

    def __call__(self, x: torch.Tensor, named, site: str) -> torch.Tensor:
        """The observer of ``distributed/api.py``: ``x`` constrained to
        ``named``."""
        if not self.active:
            return x
        self.constrain(x, named, site)
        if x.requires_grad and torch.is_grad_enabled():
            return _Constrained.apply(x, self, named, site)
        return x

    def constrain(self, x: torch.Tensor, named, site: str) -> None:
        if not self.active:
            return
        target = logical_spec(named.spec, x.dim(), self.sizes)
        op = f"constraint:{site}"
        want = [i for i, a in enumerate(target) if MODEL in a]
        sid = _sid(x)
        if sid in self.partial:
            self.partial.discard(sid)
            if want:
                spec = tuple(tuple(a for a in axes if a != MODEL) for axes in target)
                self._emit("reduce-scatter", x, spec, op)
            else:
                self._emit("all-reduce", x, target, op)
        else:
            have = [i for i, a in enumerate(self.layout(x)) if MODEL in a]
            if have and have != want:
                spec = [tuple(a for a in axes if a != MODEL) for axes in target]
                for i in have:
                    spec[i] = _union(spec[i], (MODEL,))
                self._emit("all-gather" if not want else "all-to-all", x, tuple(spec), op)
        self._set(x, target)

    def finish(self, out) -> None:
        """The program's results as XLA returns them: a partial sum reduced,
        and a split over ``"model"`` that does not divide its dim (a padded
        one, as a vocab the model axis does not divide leaves the logits)
        gathered."""
        model = self.sizes[MODEL]
        for t in _tensors(out):
            self._reduce(t, "output")
            place = self.layout(t)
            padded = [i for i, axes in enumerate(place) if MODEL in axes and t.shape[i] % model]
            if padded:
                self._emit("all-gather", t, place, "output")
                self._set(t, tuple(tuple(a for a in axes if a != MODEL) if i in padded else axes
                                   for i, axes in enumerate(place)))

    # -- propagation -----------------------------------------------------
    def _dispatched(self, func, args, kwargs, ins, outs) -> None:
        if self.active:
            self._propagate(func, args, kwargs, ins, outs)

    def _propagate(self, func, args, kwargs, ins, outs) -> None:
        packet = func.overloadpacket
        sid = _sid
        partial_ins = [t for t in ins if sid(t) in self.partial] if self.partial else []
        if not outs or packet in _NO_LAYOUT:
            for t in partial_ins:
                self._reduce(t, str(packet))
            return
        passes = packet in _PASS or func.is_view
        if not partial_ins and not any(any(self.layout(t)) for t in ins):
            for t in outs:  # nothing split or partial in: nothing out
                t.__dict__.pop(_LAYOUT, None)
                if self.partial and not passes:
                    self.partial.discard(sid(t))
            return
        src = args[0] if args and isinstance(args[0], torch.Tensor) else None
        if passes and src is not None:
            partial = bool(self.partial) and sid(src) in self.partial
            layouts = [self._view(packet, func, args, t) for t in outs]
        else:
            for t in partial_ins:
                self._reduce(t, str(packet))
            layouts, partial = self._rule(packet, func, args, kwargs, outs)
        for t, layout in zip(outs, layouts):
            self._set(t, layout)
        if partial or self.partial:  # a new storage takes the op's partial state
            in_sids = {sid(t) for t in ins}
            for t in outs:
                if sid(t) not in in_sids or passes:
                    (self.partial.add if partial else self.partial.discard)(sid(t))

    def _view(self, packet, func, args, out) -> tuple:
        src = args[0]
        place = self.layout(src)
        if packet in _SHAPE_ONLY:
            return _reshape(tuple(src.shape), place, tuple(out.shape), self.sizes)
        if packet is _aten.permute:
            return tuple(place[d % len(place)] for d in args[1])
        if packet in (_aten.transpose, _aten.t):
            if src.dim() < 2:
                return place
            d0, d1 = (args[1], args[2]) if packet is _aten.transpose else (0, 1)
            p = list(place)
            d0, d1 = d0 % len(p), d1 % len(p)
            p[d0], p[d1] = p[d1], p[d0]
            return tuple(p)
        if packet is _aten.expand:
            lead = out.dim() - src.dim()
            return tuple([()] * lead + [place[i] if src.shape[i] == out.shape[lead + i] else ()
                                        for i in range(src.dim())])
        if packet is _aten.select:
            # one index of a split dim (a scanned microbatch): XLA reshards
            # the slice over the same axes, on the first dim they divide
            d = args[1] % src.dim()
            rest, shape = list(place[:d] + place[d + 1:]), out.shape
            for a in place[d]:
                fit = [i for i, n in enumerate(shape) if n > 1 and n % self.sizes[a] == 0]
                if fit:
                    rest[fit[0]] = _union(rest[fit[0]], (a,))
            return _sanitize(rest)
        if tuple(src.shape) == tuple(out.shape) or packet in _SAME:
            return place
        return _reshape(tuple(src.shape), place, tuple(out.shape), self.sizes)

    def _broadcast(self, tensors, shape) -> list:
        n = len(shape)
        out = [()] * n
        for t in tensors:
            place, off = self.layout(t), n - t.dim()
            for i in range(t.dim()):
                if place[i] and off + i >= 0 and t.shape[i] == shape[off + i]:
                    out[off + i] = _union(out[off + i], place[i])
        return out

    def _rule(self, packet, func, args, kwargs, outs) -> tuple[list, bool]:
        out = outs[0]
        shape = tuple(out.shape)
        src = args[0] if args and isinstance(args[0], torch.Tensor) else None
        if packet in _FACTORY:
            return [((),) * t.dim() for t in outs], False
        if packet.__name__.endswith("_") and src is not None and packet not in _SCATTER:
            return [self.layout(src)] * len(outs), False  # in place: the buffer's layout
        if packet in _MATMUL:
            return [self._matmul(packet, args, out)], self._contracted_split(packet, args)
        if packet in _LINEAR_REDUCE or packet in (_aten.amax, _aten.logsumexp, _aten.max,
                                                   _aten.min, _aten.amin, _aten.argmax):
            return self._reduction(packet, func, args, kwargs, outs)
        if packet in (_aten._softmax, _aten._log_softmax):
            self._softmax_reduce(args[0], args[1], 2, str(packet))
            return [self.layout(args[0])], False
        if packet in (_aten._softmax_backward_data, _aten._log_softmax_backward_data):
            self._softmax_reduce(args[0], args[2], 1, str(packet))
            return [_sanitize(self._broadcast(args[:2], shape))], False
        if packet in (_aten.cumsum, _aten.topk, _aten.sort):
            if packet is _aten.topk:
                d = args[2] if len(args) > 2 else kwargs.get("dim", -1)
            else:
                d = args[1] if len(args) > 1 else kwargs.get("dim", -1)
            d %= max(src.dim(), 1)
            place = list(self.layout(src))
            if MODEL in place[d]:
                spec = tuple(place)
                place[d] = tuple(a for a in place[d] if a != MODEL)
                self._emit("all-gather", src, spec, str(packet))
            return [tuple(place)] * len(outs), False
        if packet is _aten.index:
            return self._index(args[0], args[1], shape)
        if packet is _aten.gather:
            d = args[1] % src.dim()
            place = self._broadcast([args[2]], shape)
            for i, axes in enumerate(self.layout(src)):
                if i != d and src.shape[i] == shape[i]:
                    place[i] = _union(place[i], axes)
            return [_sanitize(place)], MODEL in self.layout(src)[d] and MODEL not in \
                self.layout(args[2])[d]
        if packet is _aten.index_select:
            d = args[1] % src.dim()
            place = list(self.layout(src))
            split = MODEL in place[d]
            place[d] = self.layout(args[2])[0] if args[2].dim() else ()
            return [_sanitize(place)], split and MODEL not in place[d]
        if packet in _SCATTER:
            place = list(self.layout(src))
            vals = [t for t in _tensors(args[1:]) if t.dim() == src.dim()]
            for t in vals:
                for i, axes in enumerate(self.layout(t)):
                    if t.shape[i] == shape[i]:
                        place[i] = _union(place[i], axes)
            return [_sanitize(place)], False
        if packet is _aten.select_backward:
            d = args[2] % len(shape)
            place = list(self.layout(args[0]))
            return [tuple(place[:d] + [()] + place[d:])], False
        if packet in (_aten.cat, _aten.stack):
            tensors = [t for t in args[0] if t.dim() > 0 or packet is _aten.stack]
            d = (args[1] if len(args) > 1 else kwargs.get("dim", 0))
            nd = tensors[0].dim() if tensors else 0
            place = [()] * nd
            for t in tensors:
                if t.dim() == nd:
                    place = [_union(p, q) for p, q in zip(place, self.layout(t))]
            if packet is _aten.stack:
                d %= nd + 1
                place = place[:d] + [()] + place[d:]
            return [_sanitize(place)], False
        if packet in _SAME and src is not None and src.dim() == out.dim():
            return [self.layout(src)] * len(outs), False
        tensors = _tensors((args, kwargs))
        if all(t.dim() <= out.dim() for t in tensors):  # elementwise, broadcasting
            if not all(tuple(t.shape) == shape for t in outs):
                self.fallbacks[str(packet)] = self.fallbacks.get(str(packet), 0) + 1
            return [_sanitize(self._broadcast(tensors, tuple(t.shape))) for t in outs], False
        self.fallbacks[str(packet)] = self.fallbacks.get(str(packet), 0) + 1
        return [((),) * t.dim() for t in outs], False

    def _operands(self, packet, args):
        return (args[1], args[2]) if packet in (_aten.addmm, _aten.baddbmm) else (args[0], args[1])

    def _contracted_split(self, packet, args) -> bool:
        a, b = self._operands(packet, args)
        return MODEL in self.layout(a)[-1] or MODEL in self.layout(b)[-2]

    def _matmul(self, packet, args, out) -> tuple:
        a, b = self._operands(packet, args)
        pa, pb = self.layout(a), self.layout(b)
        place = [pa[-2], pb[-1]]
        if out.dim() == 3:
            place = [_union(pa[0], pb[0])] + place
        if packet in (_aten.addmm, _aten.baddbmm):
            bias = self._broadcast([args[0]], tuple(out.shape))
            place = [_union(p, q) for p, q in zip(place, bias)]
        if self._contracted_split(packet, args):  # a partial sum is split over model nowhere
            place = [tuple(x for x in axes if x != MODEL) for axes in place]
        return _sanitize(place)

    def _reduced(self, src, dims, keepdim) -> tuple[list, set]:
        place = list(self.layout(src))
        gone = set()
        for d in dims:
            gone.update(place[d])
        if keepdim:
            out = [() if i in dims else p for i, p in enumerate(place)]
        else:
            out = [p for i, p in enumerate(place) if i not in dims]
        return out, gone

    def _reduction(self, packet, func, args, kwargs, outs) -> tuple[list, bool]:
        src = args[0]
        if func in (_aten.sum.default, _aten.mean.default):
            dims, keepdim = list(range(src.dim())), False
        else:
            dim = args[1] if len(args) > 1 else kwargs.get("dim")
            keepdim = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
            dims = _dims(dim, src.dim())
            if packet in (_aten.max, _aten.min) and not isinstance(dim, int):
                dims, keepdim = list(range(src.dim())), False
        place, gone = self._reduced(src, set(dims), keepdim)
        layouts = [tuple(place)] * len(outs)
        if MODEL not in gone:
            return layouts, False
        if packet in _LINEAR_REDUCE:
            return layouts, True
        for _ in range(2 if packet is _aten.logsumexp else 1):
            self._emit("all-reduce", outs[0], layouts[0], str(packet))
        return layouts, False

    def _softmax_reduce(self, src, dim, n: int, op: str) -> None:
        """A softmax over a dim split over model: ``n`` all-reduces of the
        reduced shape (the max and the sum; the backward's sum)."""
        d = dim % src.dim()
        place = list(self.layout(src))
        if MODEL not in place[d]:
            return
        shape = list(src.shape)
        shape[d], place[d] = 1, ()
        for _ in range(n):
            self.collectives.append(Collective("all-reduce", tuple(shape), src.dtype,
                                               tuple(place), op))

    def _index(self, src, indices, shape) -> tuple[list, bool]:
        place = self.layout(src)
        idx = [(i, t) for i, t in enumerate(indices) if t is not None]
        if not idx or any(t.dtype == torch.bool for _, t in idx):
            self.fallbacks["aten.index"] = self.fallbacks.get("aten.index", 0) + 1
            return [((),) * len(shape)], False
        first, last = idx[0][0], idx[-1][0]
        adjacent = last - first + 1 == len(idx)
        nb = len(shape) - (src.dim() - len(idx))
        ib = self._broadcast([t for _, t in idx], shape[first:first + nb] if adjacent
                             else shape[:nb])
        rest_before = list(place[:first]) if adjacent else []
        rest = [p for i, p in enumerate(place) if i >= len(indices) or indices[i] is None]
        if adjacent:
            out = rest_before + ib + list(place[last + 1:])
        else:
            out = ib + rest
        split = any(MODEL in place[i] and MODEL not in self.layout(t)[0] if t.dim() else
                    MODEL in place[i] for i, t in idx)
        if split:
            out = [tuple(a for a in axes if a != MODEL) for axes in out]
        return [_sanitize(out)], split


class _Constrained(torch.autograd.Function):
    """A tracked constraint under autograd: the value itself forward, and the
    cotangent constrained to the same layout backward (JAX transposes a
    sharding constraint so); at a ``"shard_map"`` site the cotangent is a
    partial sum first (JAX transposes a ``shard_map`` input it replicates
    over the model axis into a psum over it)."""

    @staticmethod
    def forward(ctx, x, tracker, named, site):
        ctx.tracker, ctx.named, ctx.site = tracker, named, site
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.site == "shard_map":
            # a shard_map input replicated over the model axis: the
            # transpose sums its cotangent over that axis
            ctx.tracker.partial.add(_sid(g))
        ctx.tracker.constrain(g, ctx.named, ctx.site)
        return g, None, None, None


# ----------------------------------------------------------------------
# Roofline terms (one NVIDIA H100 SXM at its 700 W limit, data sheet)
# ----------------------------------------------------------------------
PEAK_FLOPS = 989e12  # bf16 dense FLOP/s per card
HBM_BW = 3.35e12  # bytes/s per card
LINK_BW = 450e9  # bytes/s, NVLink 4, one way (the reference's ICI_BW)


def roofline_terms(
    *,
    hlo_flops: float,
    hlo_bytes: float,
    collective_bytes: float,
    chips: int,
    model_flops: float,
) -> dict:
    """All inputs are PER-DEVICE except model_flops (whole-step ideal)."""
    compute_s = hlo_flops / PEAK_FLOPS
    memory_s = hlo_bytes / HBM_BW
    collective_s = collective_bytes / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    useful = model_flops / chips / PEAK_FLOPS  # ideal compute time
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "bound_s": bound,
        "model_flops_total": model_flops,
        "hlo_flops_per_device": hlo_flops,
        "useful_flops_ratio": (model_flops / chips) / max(hlo_flops, 1.0),
        "roofline_fraction": useful / max(bound, 1e-30),
    }
