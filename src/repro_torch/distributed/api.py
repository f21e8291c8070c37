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
"""
from __future__ import annotations

import functools
import threading
from contextlib import contextmanager
from typing import Callable, Optional, Sequence

import torch

from repro_torch.launch.mesh import NamedSharding
from repro_torch.launch.mesh import PartitionSpec as P

_state = threading.local()


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


def bind_context(fn: Callable) -> Callable:
    """``fn``, run under the sharding context active now on whichever thread
    calls it.  On the card autograd runs the backward pass, and with it the
    recompute of a ``torch.utils.checkpoint`` block, on a device thread of
    its own, where the caller's thread-local context is not set; a block
    bound here recomputes as its forward ran (the reference's
    ``jax.checkpoint`` recomputes inside the same trace)."""
    ctx = getattr(_state, "ctx", None)

    @functools.wraps(fn)
    def run(*args, **kwargs):
        prev = getattr(_state, "ctx", None)
        _state.ctx = ctx
        try:
            return fn(*args, **kwargs)
        finally:
            _state.ctx = prev

    return run


def with_sharding_constraint(x: torch.Tensor, named: NamedSharding) -> torch.Tensor:
    """``x`` itself, laid out as ``named`` says: on one card that layout is
    the whole tensor.  Raises where the reference's would, for a spec with
    more entries than ``x`` has dims."""
    if len(named.spec) > x.dim():
        raise ValueError(f"{named.spec} has {len(named.spec)} entries for a tensor "
                         f"of rank {x.dim()}")
    return x


def constrain(x: torch.Tensor, logical: Sequence[Optional[str]]) -> torch.Tensor:
    ctx = getattr(_state, "ctx", None)
    if ctx is None:
        return x
    mesh, mapping = ctx
    if len(logical) != x.dim():
        return x  # shape-polymorphic call sites may not match; skip silently
    spec = P(*[_translate(a, mapping) for a in logical])
    return with_sharding_constraint(x, NamedSharding(mesh, spec))
