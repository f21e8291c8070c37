"""Production mesh construction (single-pod 16×16, multi-pod 2×16×16).

The port's mesh is a description: named axes and, at every position, the
``torch.device`` that holds that position's buffers.  Nothing is allocated
until a program runs on it (``distributed/broadcast.py`` allocates one
buffer per position), so a 512-position mesh costs nothing.  On one card
every position is that card; in a process that holds several, positions
take the cards in turn (position ``p`` on ``cuda:{p % device_count}``), and
a copy between positions becomes a peer copy.  ``mesh.shape`` maps each
axis name to its size, as ``jax.sharding.Mesh.shape`` does, so
``mesh.shape["data"]`` reads the same in both packages.

:class:`PartitionSpec` and :class:`NamedSharding` are the port's
counterparts of ``jax.sharding``'s: a spec names, for each dim of a tensor,
the mesh axes it is split over, and a named sharding pairs a spec with a
mesh.  ``distributed/sharding.py`` computes them and ``distributed/api.py``
applies them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True, eq=False)
class Mesh:
    axis_names: tuple[str, ...]
    devices: np.ndarray  # object array of torch.device, one per position

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


class PartitionSpec(tuple):
    """One entry per dim of a tensor: ``None`` (not split), a mesh axis name,
    or a tuple of names (split over their product, the first outermost).
    Trailing dims left out are not split.  A tuple, so it compares, hashes
    and unpacks by value, as ``jax.sharding.PartitionSpec`` does; unlike
    jax 0.9's, it keeps a one-name tuple as given."""

    def __new__(cls, *parts):
        for part in parts:
            ok = part is None or isinstance(part, str) or (
                isinstance(part, tuple) and all(isinstance(a, str) for a in part))
            if not ok:
                raise TypeError(f"PartitionSpec entry {part!r}: None, an axis name "
                                "or a tuple of names")
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"

    def axis_names(self) -> list[str]:
        """Every mesh axis the spec names, in order."""
        return [a for part in self if part is not None
                for a in ((part,) if isinstance(part, str) else part)]


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh.  Refused, as ``jax.sharding.NamedSharding`` refuses
    it, when the spec names an axis the mesh lacks or names one axis twice."""

    mesh: Mesh
    spec: PartitionSpec

    def __post_init__(self):
        names = self.spec.axis_names()
        missing = [a for a in names if a not in self.mesh.axis_names]
        if missing:
            raise ValueError(f"{self.spec} names axes {missing} that the mesh "
                             f"{self.mesh.axis_names} lacks")
        if len(set(names)) != len(names):
            raise ValueError(f"{self.spec} names a mesh axis twice")


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device="cuda") -> Mesh:
    """A mesh of ``shape`` with axes ``axes`` on the card, or on the CPU when
    ``device="cpu"``."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    device = torch.device(device)
    n = int(np.prod(shape))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh(device='cuda'): CUDA is not available; "
                "pass device='cpu' to lay the mesh out on the CPU"
            )
        cards = torch.cuda.device_count()
        flat = [torch.device("cuda", p % cards) for p in range(n)]
    else:
        flat = [device] * n
    devices = np.empty(n, dtype=object)
    devices[:] = flat
    return Mesh(tuple(axes), devices.reshape(shape))


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device="cuda") -> Mesh:
    """Small mesh for tests."""
    return make_mesh(shape, axes, device=device)
