"""Sharding context: how model code requests activation shardings.

Model code is mesh-agnostic; it calls ``constrain(x, ("data", None, ...))``
with *logical* axis names.  Inside a :func:`sharding_context` those names
are translated to the active mesh's axes (e.g. logical "data" → physical
("pod", "data") on the multi-pod mesh) and applied with
:func:`with_sharding_constraint`; outside any context it is a no-op, so
tests and single-device runs never touch the mesh machinery.  The context
also tells ``models/moe.py`` to route each data shard's tokens on their
own (:func:`active_mesh`).

The port runs one program on one card, so every tensor stays whole where
it is: a constraint checks its spec against the mesh (an axis the mesh
lacks, or one named twice, raises; so does a spec longer than the tensor's
rank) and returns the tensor itself.  Values never change, as under the
reference's ``with_sharding_constraint``.

While a :func:`record_constraints` block is active, every constraint is
also written down (:class:`Constraint`: shape, dtype, spec, mesh and the
call site's kind), so ``launch/dryrun.py`` can derive the collectives a
mesh of cards would run.  Outside one nothing is recorded.  Inside an
:func:`observe_constraints` block every constraint is also handed to an
observer (``launch/hlo_analysis.py::ShardingTracker``), which follows each
tensor's layout and returns the tensor to go on with.
"""
from __future__ import annotations

import functools
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from repro_torch.launch.mesh import NamedSharding
from repro_torch.launch.mesh import PartitionSpec as P

_state = threading.local()


@dataclass(frozen=True)
class Constraint:
    """One ``with_sharding_constraint`` call, as :func:`record_constraints`
    keeps it.  ``site`` says what the tensor is: ``"activation"`` or
    ``"shard_map"`` (from :func:`constrain`), or the train step's ``"grad_accumulator"``,
    ``"grad"`` (one microbatch's gradient) and ``"params"`` (the new
    params)."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    spec: P
    mesh: object
    site: str


@contextmanager
def record_constraints():
    """Yields a list that every constraint made inside the block appends to,
    on this thread and in blocks :func:`bind_context` bound inside it."""
    prev = getattr(_state, "records", None)
    _state.records = records = []
    try:
        yield records
    finally:
        _state.records = prev


@contextmanager
def observe_constraints(observer: Callable):
    """Inside, every constraint calls ``observer(x, named, site)`` and
    returns what it returns, on this thread and in blocks
    :func:`bind_context` bound inside it."""
    prev = getattr(_state, "observer", None)
    _state.observer = observer
    try:
        yield
    finally:
        _state.observer = prev


def _translate(axis, mapping) -> object:
    if axis is None:
        return None
    phys = mapping.get(axis, ())
    if phys == ():
        return None
    return phys


@contextmanager
def sharding_context(mesh, logical_to_physical: dict[str, tuple[str, ...]]):
    """Activate activation-constraint translation for model code."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, logical_to_physical)
    try:
        yield
    finally:
        _state.ctx = prev


def active_mesh() -> Optional[object]:
    ctx = getattr(_state, "ctx", None)
    return ctx[0] if ctx else None


_BOUND = ("ctx", "records", "observer")  # the thread-local state bind_context carries


def bind_context(fn: Callable) -> Callable:
    """``fn``, run under the sharding context active now on whichever thread
    calls it.  On the card autograd runs the backward pass, and with it the
    recompute of a ``torch.utils.checkpoint`` block, on a device thread of
    its own, where the caller's thread-local context is not set; a block
    bound here recomputes as its forward ran (the reference's
    ``jax.checkpoint`` recomputes inside the same trace).  An active
    :func:`record_constraints` list and :func:`observe_constraints`
    observer are bound with it."""
    bound = tuple(getattr(_state, k, None) for k in _BOUND)

    @functools.wraps(fn)
    def run(*args, **kwargs):
        prev = tuple(getattr(_state, k, None) for k in _BOUND)
        for k, v in zip(_BOUND, bound):
            setattr(_state, k, v)
        try:
            return fn(*args, **kwargs)
        finally:
            for k, v in zip(_BOUND, prev):
                setattr(_state, k, v)

    return run


def with_sharding_constraint(x: torch.Tensor, named: NamedSharding, *,
                             site: str = "activation") -> torch.Tensor:
    """``x`` itself, laid out as ``named`` says: on one card that layout is
    the whole tensor.  Raises where the reference's would, for a spec with
    more entries than ``x`` has dims.  ``site`` is what a
    :func:`record_constraints` block records the call as.  Inside an
    :func:`observe_constraints` block, what the observer returns (the same
    values)."""
    if len(named.spec) > x.dim():
        raise ValueError(f"{named.spec} has {len(named.spec)} entries for a tensor "
                         f"of rank {x.dim()}")
    records = getattr(_state, "records", None)
    if records is not None:
        records.append(Constraint(tuple(x.shape), x.dtype, named.spec, named.mesh, site))
    observer = getattr(_state, "observer", None)
    return x if observer is None else observer(x, named, site)


def constrain(x: torch.Tensor, logical: Sequence[Optional[str]], *,
              site: str = "activation") -> torch.Tensor:
    """``x`` constrained to the logical layout ``logical`` inside a
    :func:`sharding_context`, ``x`` itself outside one.  ``site`` is what the
    call is recorded as: ``"activation"``, or ``"shard_map"`` for an input of
    one of the reference's ``shard_map`` blocks (its transpose sums the
    cotangent over the axes the block replicates the input over)."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None:
        return x
    mesh, mapping = ctx
    if len(logical) != x.dim():
        return x  # shape-polymorphic call sites may not match; skip silently
    spec = P(*[_translate(a, mapping) for a in logical])
    return with_sharding_constraint(x, NamedSharding(mesh, spec), site=site)
