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

Collectives are not dispatched ops on one card; ``launch/dryrun.py``
derives them from the constraints ``distributed/api.py`` records and adds
them to the same :class:`HloStats`.

The roofline constants are an H100 SXM's (data sheet, dense, no sparsity).
"""
from __future__ import annotations

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
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
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
        return out


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


def analyze_callable(fn: Callable, *args, **kwargs) -> tuple[HloStats, object]:
    """Run ``fn(*args, **kwargs)`` under the counting modes; returns (its
    whole-program FLOPs and bytes, its result).  Run a train step's
    backward inside ``fn``, or its FLOPs (remat recompute included) go
    uncounted."""
    bytes_mode = _ByteCounter()
    with FlopCounterMode(display=False) as flops_mode, bytes_mode:
        out = fn(*args, **kwargs)
    n_bytes = float(bytes_mode.bytes)
    return HloStats(flops=float(flops_mode.get_total_flops()), bytes_accessed=n_bytes,
                    bytes_raw=n_bytes), out


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
