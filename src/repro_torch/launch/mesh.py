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
