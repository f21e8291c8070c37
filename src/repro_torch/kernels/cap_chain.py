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
per-NIC active-flow count (a bincount kernel whose warps add each run of
equal ids with one atomic; plain version
``nic_flow_counts_torch``).  The engine keeps those counts incrementally and
calls neither the kernel nor its plain version for them.

Bit-identity contract: both versions run in float64 and perform the same
IEEE-754 divisions, product and NaN-propagating minima, in the same operand
order, as the engine's numpy path, so the rates — and the event log — are
bit-identical.  The plain version divides a float64 tensor by a tensor,
never a Python float by a tensor: ``float / tensor`` in PyTorch computes
``reciprocal(t) * x``, which differs from IEEE division in the last bit.

The engine's route is :class:`CapChainStaging`: one front's operands packed
into one host buffer (pinned on ``cuda``), rated by one C call that copies
the front in, launches K1, copies the rates back and synchronises; on
``cpu`` the plain ``cap_chain_front_torch`` reads the same packed buffer.

Each wrapper counts its kernel launches in a plain integer attribute
(``cap_chain_rates.launches``, ``nic_flow_counts.launches``; the staging
route adds to ``cap_chain_rates.launches``); the plain versions count
nothing.  A CUDA tensor always goes to the kernel: a failed build or launch
raises, it never falls back.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "CapChainStaging",
    "cap_chain_front_torch",
    "cap_chain_rates",
    "cap_chain_rates_torch",
    "packed_front_bytes",
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
    tensor launches the bincount kernel; a CPU tensor takes
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


# ----------------------------------------------------------------------
# the engine's route: one packed front, one copy each way
# ----------------------------------------------------------------------
def packed_front_bytes(n: int) -> int:
    """Bytes of a packed front of ``n`` flows: ``n_out``, ``n_in`` (int64),
    ``out_cap``, ``qps``, ``par_rate`` (float64) as five segments of ``8 n``
    bytes, then ``blk`` as ``n`` bytes, padded to a multiple of 8."""
    return 40 * n + -(-n // 8) * 8


def _packed_segments(raw: np.ndarray, n: int) -> tuple[np.ndarray, ...]:
    """Views ``(n_out, n_in, out_cap, qps, par_rate, blk)`` of a packed uint8
    front of ``n`` flows (the layout ``repro_cap_chain_front`` reads)."""
    seg = [raw[8 * n * k:8 * n * (k + 1)] for k in range(5)]
    return (seg[0].view(np.int64), seg[1].view(np.int64), seg[2].view(np.float64),
            seg[3].view(np.float64), seg[4].view(np.float64), raw[40 * n:41 * n].view(np.bool_))


def cap_chain_front_torch(packed: torch.Tensor, n: int, **caps: float) -> torch.Tensor:
    """The plain version of the packed route: :func:`cap_chain_rates_torch`
    on the six segments of a packed uint8 front of ``n`` flows on the CPU."""
    segs = _packed_segments(packed.numpy(), n)
    return cap_chain_rates_torch(*(torch.from_numpy(a) for a in segs), **caps)


class CapChainStaging:
    """One engine's buffers for the packed route of K1.

    A host buffer of packed fronts (:func:`packed_front_bytes`), pinned on
    ``cuda`` and plain on ``cpu``; on ``cuda`` also a device input buffer, a
    device output buffer and a pinned output buffer.  Each grows to the next
    power of two of flows that a front needs and is never shrunk.  The
    engine gathers a front into the numpy views :meth:`segments` returns,
    then :meth:`rates` rates it: one C call on ``cuda`` (copy in, K1, copy
    back, synchronise), :func:`cap_chain_front_torch` on ``cpu``.  The views
    are valid until the next :meth:`segments`; the rates belong to the
    caller.
    """

    def __init__(self, device: str | torch.device):
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"CapChainStaging runs on cpu or cuda, not {dev}")
        self.device = dev
        self.capacity = 0  # flows the buffers hold
        self._n = 0

    def _grow(self, n: int) -> None:
        cap = 1 << max(n - 1, 255).bit_length()
        pin = self.device.type == "cuda"
        self._host_in = torch.empty(packed_front_bytes(cap), dtype=torch.uint8, pin_memory=pin)
        self._host_raw = self._host_in.numpy()
        if pin:
            self._dev_in = torch.empty(packed_front_bytes(cap), dtype=torch.uint8, device=self.device)
            self._dev_out = torch.empty(cap, dtype=_F64, device=self.device)
            self._host_out = torch.empty(cap, dtype=_F64, pin_memory=True)
            self._host_out_np = self._host_out.numpy()
        self.capacity = cap

    def segments(self, n: int) -> tuple[np.ndarray, ...]:
        """Views ``(n_out, n_in, out_cap, qps, par_rate, blk)`` of a front of
        ``n`` flows in the packed host buffer, to be filled in place."""
        if n > self.capacity or not self.capacity:
            self._grow(n)
        self._n = n
        return _packed_segments(self._host_raw, n)

    def rates(self, *, per_stream_cap: float, in_cap: float, decompress_rate: float,
              block_size: float) -> np.ndarray:
        """Rates of the front last laid out by :meth:`segments`, as a float64
        array the caller owns, bit-identical to the engine's numpy path."""
        n = self._n
        caps = dict(per_stream_cap=per_stream_cap, in_cap=in_cap,
                    decompress_rate=decompress_rate, block_size=block_size)
        if n == 0:
            return np.empty(0, dtype=np.float64)
        if self.device.type == "cpu":
            return cap_chain_front_torch(self._host_in, n, **caps).numpy()
        from ._build import library

        with torch.cuda.device(self.device):
            rc = library("cap_chain").repro_cap_chain_front(
                self._host_in.data_ptr(), self._dev_in.data_ptr(), self._dev_out.data_ptr(),
                self._host_out.data_ptr(), n, float(per_stream_cap), float(in_cap),
                float(decompress_rate), float(block_size),
                torch.cuda.current_stream(self.device).cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"cap_chain front failed: CUDA error {rc}")
        cap_chain_rates.launches += 1
        return self._host_out_np[:n].copy()


def reset_launches() -> None:
    """Set both wrappers' launch counts to 0."""
    cap_chain_rates.launches = 0
    nic_flow_counts.launches = 0


reset_launches()
