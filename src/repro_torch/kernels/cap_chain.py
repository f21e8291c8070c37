"""Cap-chain kernels of the vector flow engine (CUDA on Hopper).

One wide recompute front of the FaaSNet fluid model is an elementwise
minimum chain over per-flow gathered operands::

    rate(f) = min(per_stream_cap,
                  src_out_cap / n_out(src),
                  dst_in_cap  / n_in(dst),
                  decompress_rate,
                  block_size * qps(src) / n_out(src)   [block-mode only],
                  parent_rate)                          [+inf when absent]

``cap_chain_rates`` computes it in one hand-written CUDA kernel
(``csrc/cap_chain.cu``) for a CUDA tensor, and in the plain PyTorch version
``cap_chain_rates_torch`` for a CPU tensor.  ``nic_flow_counts`` is the
per-NIC active-flow count (an atomic bincount kernel; plain version
``nic_flow_counts_torch``).  The engine keeps those counts incrementally and
calls neither the kernel nor its plain version for them.

Bit-identity contract: both versions run in float64 and perform the same
IEEE-754 divisions, product and NaN-propagating minima, in the same operand
order, as the engine's numpy path, so the rates — and the event log — are
bit-identical.  The plain version divides a float64 tensor by a tensor,
never a Python float by a tensor: ``float / tensor`` in PyTorch computes
``reciprocal(t) * x``, which differs from IEEE division in the last bit.

Each wrapper counts its kernel launches in a plain integer attribute
(``cap_chain_rates.launches``, ``nic_flow_counts.launches``); the plain
versions count nothing.  A CUDA tensor always goes to the kernel: a failed
build or launch raises, it never falls back.
"""
from __future__ import annotations

import torch

__all__ = [
    "cap_chain_rates",
    "cap_chain_rates_torch",
    "nic_flow_counts",
    "nic_flow_counts_torch",
    "reset_launches",
]

_F64 = torch.float64
_I64 = torch.int64


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    # a fill on the device, not a host-to-device copy (CUDA-graph capturable)
    return torch.full((), x, dtype=_F64, device=like.device)


# ----------------------------------------------------------------------
# plain PyTorch versions
# ----------------------------------------------------------------------
def cap_chain_rates_torch(
    n_out: torch.Tensor,
    n_in: torch.Tensor,
    out_cap: torch.Tensor,
    qps: torch.Tensor,
    par_rate: torch.Tensor,
    blk: torch.Tensor,
    *,
    per_stream_cap: float,
    in_cap: float,
    decompress_rate: float,
    block_size: float,
) -> torch.Tensor:
    """Plain min-cap chain: the kernel's arithmetic in PyTorch ops."""
    no = n_out.to(_F64)
    r = torch.minimum(_const(per_stream_cap, no), out_cap.to(_F64) / no)
    r = torch.minimum(r, _const(in_cap, no) / n_in.to(_F64))
    r = torch.minimum(r, _const(decompress_rate, no))
    q = (_const(block_size, no) * qps.to(_F64)) / no
    r = torch.where(blk.to(torch.bool), torch.minimum(r, q), r)
    return torch.minimum(r, par_rate.to(_F64))


def nic_flow_counts_torch(nodes: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Plain per-NIC active-flow count: a scatter-add of ones."""
    nodes = _checked_nodes(nodes, n_nodes)
    counts = torch.zeros(n_nodes, dtype=_I64, device=nodes.device)
    return counts.index_add_(0, nodes, torch.ones_like(nodes))


def _checked_nodes(nodes: torch.Tensor, n_nodes: int) -> torch.Tensor:
    if nodes.dim() != 1 or nodes.dtype.is_floating_point or nodes.dtype == torch.bool:
        raise TypeError(f"nodes must be a 1-D integer tensor, got {nodes.dtype} {tuple(nodes.shape)}")
    nodes = nodes.to(_I64)
    if nodes.numel() and (int(nodes.min()) < 0 or int(nodes.max()) >= n_nodes):
        raise IndexError(f"node index outside [0, {n_nodes})")
    return nodes


# ----------------------------------------------------------------------
# wrappers: kernel for CUDA tensors, plain version for CPU tensors
# ----------------------------------------------------------------------
def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check_cap_chain_operands(n_out, n_in, out_cap, qps, par_rate, blk):
    n = n_out.numel()
    dev = n_out.device
    for name, t, dtypes in (
        ("n_out", n_out, None),
        ("n_in", n_in, None),
        ("out_cap", out_cap, (_F64,)),
        ("qps", qps, (_F64,)),
        ("par_rate", par_rate, (_F64,)),
        ("blk", blk, (torch.bool,)),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, n_out on {dev}")
        if t.dim() != 1 or t.numel() != n:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected ({n},)")
        if dtypes is None:
            if t.dtype.is_floating_point or t.dtype == torch.bool:
                raise TypeError(f"{name} must hold integer counts, got {t.dtype}")
        elif t.dtype not in dtypes:
            raise TypeError(f"{name} must be {dtypes[0]}, got {t.dtype}")


def cap_chain_rates(
    n_out: torch.Tensor,
    n_in: torch.Tensor,
    out_cap: torch.Tensor,
    qps: torch.Tensor,
    par_rate: torch.Tensor,
    blk: torch.Tensor,
    *,
    per_stream_cap: float,
    in_cap: float,
    decompress_rate: float,
    block_size: float,
) -> torch.Tensor:
    """Fused per-flow min-cap chain over one recompute front.

    All tensors are 1-D per-flow gathers of one length on one device:
    integer counts ``n_out``/``n_in``, float64 ``out_cap``/``qps``/
    ``par_rate`` and bool ``blk``.  Returns float64 rates on that device,
    bit-identical to the engine's numpy path.  A CUDA tensor launches the
    CUDA kernel; a CPU tensor takes :func:`cap_chain_rates_torch`.
    """
    caps = dict(
        per_stream_cap=per_stream_cap,
        in_cap=in_cap,
        decompress_rate=decompress_rate,
        block_size=block_size,
    )
    if n_out.device.type == "cpu":
        return cap_chain_rates_torch(n_out, n_in, out_cap, qps, par_rate, blk, **caps)
    if n_out.device.type != "cuda":
        raise ValueError(f"cap_chain_rates runs on cpu or cuda, not {n_out.device}")
    _check_cap_chain_operands(n_out, n_in, out_cap, qps, par_rate, blk)
    from ._build import library

    ops = [t.to(_I64).contiguous() for t in (n_out, n_in)]
    ops += [t.contiguous() for t in (out_cap, qps, par_rate, blk)]
    n = n_out.numel()
    rate = torch.empty(n, dtype=_F64, device=n_out.device)
    if n == 0:
        return rate
    with torch.cuda.device(n_out.device):
        rc = library("cap_chain").repro_cap_chain_rates(
            *(t.data_ptr() for t in ops),
            rate.data_ptr(),
            n,
            float(per_stream_cap),
            float(in_cap),
            float(decompress_rate),
            float(block_size),
            _stream(),
        )
    if rc != 0:
        raise RuntimeError(f"cap_chain_rates kernel launch failed: CUDA error {rc}")
    cap_chain_rates.launches += 1
    return rate


def nic_flow_counts(nodes: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Active-flow count per NIC index: int64 of length ``n_nodes``.

    Raises ``IndexError`` for an index outside ``[0, n_nodes)``.  A CUDA
    tensor launches the atomic bincount kernel; a CPU tensor takes
    :func:`nic_flow_counts_torch`.
    """
    if nodes.device.type == "cpu":
        return nic_flow_counts_torch(nodes, n_nodes)
    if nodes.device.type != "cuda":
        raise ValueError(f"nic_flow_counts runs on cpu or cuda, not {nodes.device}")
    from ._build import library

    nodes = _checked_nodes(nodes, n_nodes).contiguous()
    counts = torch.zeros(n_nodes, dtype=_I64, device=nodes.device)
    if nodes.numel() == 0:
        return counts
    with torch.cuda.device(nodes.device):
        rc = library("cap_chain").repro_nic_flow_counts(
            nodes.data_ptr(), nodes.numel(), counts.data_ptr(), _stream()
        )
    if rc != 0:
        raise RuntimeError(f"nic_flow_counts kernel launch failed: CUDA error {rc}")
    nic_flow_counts.launches += 1
    return counts


def reset_launches() -> None:
    """Set both wrappers' launch counts to 0."""
    cap_chain_rates.launches = 0
    nic_flow_counts.launches = 0


reset_launches()
