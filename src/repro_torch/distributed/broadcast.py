"""Weight broadcast to DP replicas — FaaSNet's function tree on the device plane.

The host-plane FT streams image blocks down a balanced binary tree of VMs;
the device-plane analogue replicates a weight buffer from DP-replica 0 to
all replicas.  Schedules (selectable, compared in §Perf):

  * ``naive``     — root sends the full payload to each replica in turn
                    (DP-1 serialized sends) — the "registry" baseline:
                    every consumer is served by one source.
  * ``allgather`` — gather every replica's buffer + take replica 0's copy:
                    one op, but DP× the payload moves per device.
  * ``binomial``  — ⌈log₂DP⌉ rounds, doubling the holder set each round;
                    every round moves the full payload.
  * ``pipelined`` — **the FaaSNet schedule**: payload split into B blocks
                    that stream down a *complete binary tree* (heap layout,
                    the same balanced shape the FT maintains), each parent
                    alternating between its two children round-robin — the
                    single-port constraint that made FaaSNet pick fan-out 2
                    (paper Fig. 16: outbound ≈ 2× inbound).  Time ≈
                    (2B + 2·depth) block-times ≈ 2·payload/bw, independent
                    of DP — vs DP·payload (naive) or log₂DP·payload
                    (binomial).
  * int8 compression (``compress=True``) halves wire bytes — the on-device
    analogue of the paper's zstd-block trade of cheap compute for scarce
    bandwidth (§3.5).

All schedules run on the positions of a :class:`repro_torch.launch.mesh.Mesh`,
one buffer per position: each ``ppermute`` of the JAX package becomes a
device-to-device copy between position buffers (a peer copy where positions
sit on different cards; on one card every copy runs through the same HBM,
so the schedules differ there in serialized link traffic, the report's
time model, and not in bytes copied).  They are exact: non-root replicas
start from garbage and end bit-identical to the root.
``tests/test_torch_broadcast.py`` holds rounds, flat images, every
position's buffer and the returned tree equal to the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.models.params import tree_leaves_with_path, tree_unflatten
from repro_torch.optim.compress import dequantize_int8, quantize_int8

PyTree = Any
SCHEDULES = ("naive", "allgather", "binomial", "pipelined")


# ----------------------------------------------------------------------
# Flatten a param pytree into one contiguous buffer (the "image")
# ----------------------------------------------------------------------
@dataclass
class FlatSpec:
    treedef: Any  # the tree's structure: every leaf replaced by 0
    shapes: list[tuple[int, ...]]
    dtypes: list[torch.dtype]
    sizes: list[int]
    pad: int
    total: int


def flatten_pytree(tree: PyTree, dtype=torch.bfloat16, pad_to: int = 1):
    """Every leaf, in JAX's flattening order (dict keys sorted, ``None`` an
    empty subtree), cast to ``dtype`` and laid end to end, then zero-padded
    to a multiple of ``pad_to``.  Bit-equal to the JAX package's image of
    the same leaves."""
    leaves = [leaf for _, leaf in tree_leaves_with_path(tree)]
    shapes = [tuple(l.shape) for l in leaves]
    dtypes = [l.dtype for l in leaves]
    sizes = [l.numel() for l in leaves]
    total = sum(sizes)
    pad = (-total) % pad_to
    flat = torch.empty(total + pad, dtype=dtype, device=leaves[0].device)
    off = 0
    for leaf, size in zip(leaves, sizes):
        flat[off : off + size].copy_(leaf.reshape(-1))  # the same rounding as .to(dtype)
        off += size
    flat[total:].zero_()
    spec = FlatSpec(tree_unflatten(tree, [0] * len(leaves)), shapes, dtypes, sizes, pad,
                    total + pad)
    return flat, spec


def unflatten_pytree(flat: torch.Tensor, spec: FlatSpec) -> PyTree:
    """The tree of ``spec``, each leaf cast back to its own dtype, in storage
    of its own (no leaf is a view of ``flat``)."""
    out, off = [], 0
    for shape, dtype, size in zip(spec.shapes, spec.dtypes, spec.sizes):
        out.append(flat[off : off + size].reshape(shape).to(dtype, copy=True))
        off += size
    return tree_unflatten(spec.treedef, out)


# ----------------------------------------------------------------------
# FaaSNet schedule generation (host-side, static)
# ----------------------------------------------------------------------
@dataclass
class Round:
    perm: list[tuple[int, int]]  # (src, dst) replica pairs this round
    send_blk: np.ndarray  # (DP,) block index each replica sends (or 0)
    recv_blk: np.ndarray  # (DP,) block index each replica writes (or 0)
    recv_mask: np.ndarray  # (DP,) bool — replica receives this round


def _heap_children(i: int, n: int) -> list[int]:
    return [c for c in (2 * i + 1, 2 * i + 2) if c < n]


def faasnet_rounds(dp: int, n_blocks: int) -> list[Round]:
    """Single-port, complete-binary-tree, block-streaming schedule."""
    have: list[set[int]] = [set(range(n_blocks)) if i == 0 else set() for i in range(dp)]
    # per-node FIFO of (block, child) send tasks; children alternate by turn
    pending: list[list[tuple[int, int]]] = [[] for _ in range(dp)]
    for b in range(n_blocks):
        for c in _heap_children(0, dp):
            pending[0].append((b, c))
    rounds: list[Round] = []
    done_total = dp * n_blocks
    while sum(len(h) for h in have) < done_total:
        perm, sb, rb, rm = [], np.zeros(dp, np.int32), np.zeros(dp, np.int32), np.zeros(dp, bool)
        busy_dst: set[int] = set()
        sends: list[tuple[int, int, int]] = []  # (src, dst, blk)
        for i in range(dp):
            # pick the first sendable task whose dst is free this round
            for ti, (blk, dst) in enumerate(pending[i]):
                if dst not in busy_dst and blk in have[i] and blk not in have[dst]:
                    sends.append((i, dst, blk))
                    busy_dst.add(dst)
                    pending[i].pop(ti)
                    break
        if not sends:
            raise AssertionError("schedule deadlock (should not happen)")
        for src, dst, blk in sends:
            perm.append((src, dst))
            sb[src] = blk
            rb[dst] = blk
            rm[dst] = True
            have[dst].add(blk)
            for c in _heap_children(dst, dp):
                pending[dst].append((blk, c))
        rounds.append(Round(perm, sb, rb, rm))
    return rounds


def binomial_rounds(dp: int) -> list[list[tuple[int, int]]]:
    out = []
    r = 1
    while r < dp:
        out.append([(i, i + r) for i in range(r) if i + r < dp])
        r *= 2
    return out


# ----------------------------------------------------------------------
# Device-side application
# ----------------------------------------------------------------------
def _copy_round(bufs: list[torch.Tensor], sends) -> int:
    """One round of ``(src, dst, src_off, dst_off, n)`` copies between position
    buffers, with the semantics of one ``ppermute``: every send reads its
    source as it stood before the round.  A source range that this round also
    overwrites is staged before any write (no schedule here needs it).
    Returns the elements copied, staging included."""
    written: dict[int, tuple[int, int]] = {}
    for _, dst, _, d_off, n in sends:
        if dst in written:
            raise ValueError(f"position {dst} receives twice in one round")
        written[dst] = (d_off, d_off + n)
    copied, staged = 0, []
    for src, dst, s_off, d_off, n in sends:
        chunk = bufs[src][s_off : s_off + n]
        w = written.get(src)
        if w is not None and w[0] < s_off + n and s_off < w[1]:
            chunk = chunk.clone()
            copied += n
        staged.append((dst, d_off, n, chunk))
    for dst, d_off, n, chunk in staged:
        bufs[dst][d_off : d_off + n].copy_(chunk)
        copied += n
    return copied


def broadcast_buffers(bufs: list[torch.Tensor], *, dp, schedule, n_blocks, rounds_info) -> int:
    """Runs on one model column: ``bufs`` are its ``dp`` flat position buffers
    (position 0 the root), updated in place.  Returns the bytes copied."""
    if len(bufs) != dp:
        raise ValueError(f"{len(bufs)} buffers for dp={dp}")
    n = bufs[0].shape[0]
    copied = 0
    if schedule == "allgather":
        # one (dp, n) gather per column, then row 0 to every other position
        g = torch.empty((dp, n), dtype=bufs[0].dtype, device=bufs[0].device)
        for i, b in enumerate(bufs):
            g[i].copy_(b)
        for b in bufs[1:]:
            b.copy_(g[0])
        copied = (2 * dp - 1) * n
    elif schedule == "naive":
        for dst in range(1, dp):
            copied += _copy_round(bufs, [(0, dst, 0, 0, n)])
    elif schedule == "binomial":
        for perm in rounds_info:
            copied += _copy_round(bufs, [(s, d, 0, 0, n) for s, d in perm])
    elif schedule == "pipelined":  # FaaSNet
        chunk = n // n_blocks
        for rnd in rounds_info:
            if sorted(d for _, d in rnd.perm) != np.flatnonzero(rnd.recv_mask).tolist():
                raise ValueError("a round's recv_mask differs from its perm's destinations")
            copied += _copy_round(bufs, [
                (s, d, int(rnd.send_blk[s]) * chunk, int(rnd.recv_blk[d]) * chunk, chunk)
                for s, d in rnd.perm
            ])
    else:
        raise ValueError(f"schedule {schedule!r} not in {SCHEDULES}")
    return copied * bufs[0].element_size()


@dataclass
class BroadcastReport:
    schedule: str
    dp: int
    n_blocks: int
    payload_bytes: int
    rounds: int
    serialized_bytes: int  # per-link serialized traffic (time model numerator)

    def modeled_time_s(self, link_bw: float) -> float:
        """Serialized bytes over one link of ``link_bw`` bytes/s."""
        return self.serialized_bytes / link_bw


def _stale_buffer(like: torch.Tensor, device) -> torch.Tensor:
    """A non-root position's buffer before the broadcast: uninitialised, the
    stale state every schedule must overwrite (tests fill it instead)."""
    return torch.empty(like.shape, dtype=like.dtype, device=device)


def _position_buffers(payload: torch.Tensor, columns) -> list[list[torch.Tensor]]:
    return [[payload.to(col[0])] + [_stale_buffer(payload, d) for d in col[1:]]
            for col in columns]


def tree_broadcast(
    params: PyTree,
    mesh: Mesh,
    *,
    schedule: str = "pipelined",
    n_blocks: int = 32,
    dtype=torch.bfloat16,
    compress: bool = False,
    return_buffers: bool = False,
):
    """Replicate ``params`` from DP-replica 0 to all DP replicas.

    Every position of the mesh holds a full payload (the JAX package's
    ``in_specs=P()``): the ``pod`` and ``data`` axes give each model column
    its dp replicas, and every column runs the same schedule on its own
    buffers.  Position 0 of a column starts from the flattened params on its
    device, every other position from an uninitialised buffer (stale/garbage).
    The tree returned is read back from the *last* data position of column
    0, not from the root, so a schedule that fails to deliver shows in what
    the caller gets.  Returns ``(params, report)``; with
    ``return_buffers=True``, ``(params, report, (payload_bufs, scale_bufs))``,
    each a list over model columns of lists over data positions
    (``scale_bufs`` is None without ``compress``).
    """
    axes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    dp = int(np.prod([mesh.shape[a] for a in axes]))
    data_dims = [mesh.axis_names.index(a) for a in axes]
    columns = np.moveaxis(mesh.devices, data_dims, range(len(axes))).reshape(dp, -1).T
    flat, spec = flatten_pytree(params, dtype=dtype, pad_to=n_blocks)
    if compress:
        q, scale = quantize_int8(flat.view(n_blocks, -1))
        payload = q.reshape(-1)
        scale_flat = scale.reshape(-1)
    else:
        payload = flat

    if schedule == "pipelined":
        rounds_info = faasnet_rounds(dp, n_blocks)
        n_rounds = len(rounds_info)
        ser_bytes = n_rounds * (payload.nbytes // n_blocks)
    elif schedule == "binomial":
        rounds_info = binomial_rounds(dp)
        n_rounds = len(rounds_info)
        ser_bytes = n_rounds * payload.nbytes
    elif schedule == "naive":
        rounds_info = None
        n_rounds = dp - 1
        ser_bytes = (dp - 1) * payload.nbytes
    elif schedule == "allgather":
        rounds_info = None
        n_rounds = 1
        ser_bytes = dp * payload.nbytes
    else:
        raise ValueError(f"schedule {schedule!r} not in {SCHEDULES}")

    body = partial(broadcast_buffers, dp=dp, schedule=schedule, n_blocks=n_blocks,
                   rounds_info=rounds_info)
    bufs = _position_buffers(payload, columns)
    for col in bufs:
        body(col)
    scale_bufs = None
    if compress:
        scale_bufs = _position_buffers(scale_flat, columns)
        for col in scale_bufs:
            body(col)
        flat_out = dequantize_int8(bufs[0][-1].view(n_blocks, -1), scale_bufs[0][-1]).reshape(-1)
    else:
        flat_out = bufs[0][-1]
    report = BroadcastReport(
        schedule=schedule, dp=dp, n_blocks=n_blocks,
        payload_bytes=int(payload.nbytes), rounds=n_rounds,
        serialized_bytes=int(ser_bytes),
    )
    out = unflatten_pytree(flat_out, spec)
    return (out, report, (bufs, scale_bufs)) if return_buffers else (out, report)
