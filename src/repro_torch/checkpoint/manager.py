"""Checkpointing in the FaaSNet I/O-efficient block format (paper §3.5).

A checkpoint is ONE byte stream (all leaves concatenated, raw little-endian,
bf16 as 16-bit words) stored as separately compressed fixed-size blocks
with an offset table, plus a JSON manifest mapping each leaf path to its
(offset, size) within the raw stream.  That layout is what the paper's
on-demand fetch needs:

  * **lazy restore** — read only the blocks covering the leaves a consumer
    needs first (embedding + first layer group for a serving cold start);
  * **tree distribution** — the compressed blocks are the unit streamed
    down FTs;
  * **read-amplification accounting** — ``BlockReader.stats`` reproduces
    the paper's Fig. 20 analysis on real checkpoints.

The port's leaf paths, their order (dict keys sorted, sequences in index
order, as ``jax.tree_util`` flattens), the raw stream and the manifest are
the JAX package's, so a checkpoint written by either package restores in
the other.  Saves are atomic (tmp + rename) and optionally asynchronous;
``latest_step`` finds the newest *complete* checkpoint.
"""
from __future__ import annotations

import json
import os
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.blockstore import (
    DEFAULT_BLOCK_SIZE,
    BlockReader,
    write_blockstore_chunks,
)
from repro_torch.models.params import tree_leaves_with_path, tree_unflatten

PyTree = Any


def _leaf_paths(tree: PyTree) -> list[tuple[str, Any]]:
    return [("/".join(map(str, path)), leaf) for path, leaf in tree_leaves_with_path(tree)]


def _leaf_spec(leaf) -> tuple[str, tuple[int, ...], int]:
    """A leaf's dtype name, shape and raw byte count, without touching its data."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            dtype = "bfloat16"
        else:
            dtype = str(torch.empty(0, dtype=leaf.dtype).numpy().dtype)
        return dtype, tuple(leaf.shape), leaf.numel() * leaf.element_size()
    arr = np.asarray(leaf)
    return str(arr.dtype), tuple(arr.shape), arr.nbytes


def _leaf_buffer(leaf) -> np.ndarray:
    """A leaf's raw little-endian bytes (bf16 as 16-bit words) as a flat uint8
    array: a view of a contiguous host leaf, else one host copy."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        leaf = t.numpy()
    arr = np.ascontiguousarray(np.asarray(leaf)).reshape(-1)
    if arr.dtype.name == "bfloat16":
        arr = arr.view(np.uint16)
    return arr.view(np.uint8)


def _one_ahead(fn: Callable, items: list) -> Iterator:
    """``map(fn, items)`` with the next item's ``fn`` (a leaf's copy to the
    host) running on a helper thread while the caller uses the current one."""
    with ThreadPoolExecutor(1) as ex:
        ahead = None
        for item in items:
            nxt = ex.submit(fn, item)
            if ahead is not None:
                yield ahead.result()
            ahead = nxt
        if ahead is not None:
            yield ahead.result()


@dataclass
class LeafMeta:
    path: str
    shape: tuple[int, ...]
    dtype: str
    offset: int  # into the raw (uncompressed) stream
    nbytes: int


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        *,
        block_size: int = DEFAULT_BLOCK_SIZE,
        keep: int = 3,
        async_save: bool = False,
    ) -> None:
        self.dir = directory
        self.block_size = block_size
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def _paths(self, step: int) -> tuple[str, str]:
        return (
            os.path.join(self.dir, f"ckpt_{step:08d}.blocks"),
            os.path.join(self.dir, f"ckpt_{step:08d}.json"),
        )

    def save(self, step: int, tree: PyTree) -> None:
        """Write ``tree`` (tensors or numpy arrays) as checkpoint ``step``.

        The raw stream is cut into blocks as the leaves' bytes come, never
        joined.  A synchronous save streams each leaf from where it lies (a
        device leaf is copied to the host while the one before it is
        compressed); an asynchronous one copies every leaf's bytes before it
        returns (one payload on the host), so the caller may change the tree
        while the blocks are written.
        """
        pairs = _leaf_paths(tree)
        metas: list[LeafMeta] = []
        off = 0
        for path, leaf in pairs:
            dtype, shape, nbytes = _leaf_spec(leaf)
            metas.append(LeafMeta(path, shape, dtype, off, nbytes))
            off += nbytes
        if self.async_save:
            bufs = [_leaf_buffer(leaf).copy() for _, leaf in pairs]
            chunks = lambda: iter(bufs)  # noqa: E731
        else:
            chunks = lambda: _one_ahead(_leaf_buffer, [leaf for _, leaf in pairs])  # noqa: E731

        def write() -> None:
            bpath, mpath = self._paths(step)
            manifest = write_blockstore_chunks(chunks(), off, bpath, block_size=self.block_size)
            doc = {
                "step": step,
                "block_manifest": manifest.to_dict(),
                "leaves": [m.__dict__ for m in metas],
            }
            tmp = mpath + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, mpath)  # manifest last => presence implies complete
            self._gc()

        if self.async_save:
            self.wait()
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            for p in self._paths(s):
                try:
                    os.remove(p)
                except FileNotFoundError:
                    pass

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.dir):
            m = re.match(r"ckpt_(\d+)\.json$", name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def _load_manifest(self, step: int) -> tuple[dict, list[LeafMeta]]:
        _, mpath = self._paths(step)
        with open(mpath) as f:
            doc = json.load(f)
        metas = [LeafMeta(**{**m, "shape": tuple(m["shape"])}) for m in doc["leaves"]]
        return doc, metas

    @staticmethod
    def _load(reader: BlockReader, meta: LeafMeta, device) -> torch.Tensor:
        """Leaf ``meta`` read straight into its own host memory, then put on
        ``device`` (a host leaf is that memory)."""
        buf = torch.empty(meta.nbytes, dtype=torch.uint8)
        reader.read_range_into(meta.offset, meta.nbytes, buf.numpy())
        if meta.dtype == "bfloat16":
            leaf = buf.view(torch.bfloat16).reshape(meta.shape)
        else:
            leaf = torch.from_numpy(buf.numpy().view(np.dtype(meta.dtype)).reshape(meta.shape))
        return leaf.to(device)

    @staticmethod
    def _zeros(meta: LeafMeta, device) -> torch.Tensor:
        if meta.dtype == "bfloat16":
            return torch.zeros(meta.shape, dtype=torch.bfloat16, device=device)
        return torch.from_numpy(np.zeros(meta.shape, np.dtype(meta.dtype))).to(device)

    def restore(self, step: int, like: PyTree, *, device="cuda") -> PyTree:
        """Full restore into the structure of ``like``, as tensors on ``device``."""
        _, metas = self._load_manifest(step)
        with BlockReader(self._paths(step)[0]) as reader:
            by_path = {m.path: m for m in metas}
            leaves = []
            for path, _ in _leaf_paths(like):
                m = by_path[path]
                leaves.append(self._load(reader, m, device))
        return tree_unflatten(like, leaves)

    def restore_lazy(
        self,
        step: int,
        like: PyTree,
        first: Callable[[str], bool],
        *,
        device="cuda",
    ) -> tuple[PyTree, Callable[[], PyTree], BlockReader]:
        """On-demand restore (paper §3.5): load leaves matching ``first`` now.

        Returns (partial tree with zeros elsewhere, finish() to complete it,
        reader for fetch statistics).  ``finish()`` returns the full tree:
        the partial tree's own first leaves, and each other leaf decoded once.
        ``like`` gives paths and structure only (its leaves may be ``meta``
        tensors); a caller that drops the partial tree before ``finish()``
        holds one copy of the weights on ``device``.
        """
        _, metas = self._load_manifest(step)
        reader = BlockReader(self._paths(step)[0])
        by_path = {m.path: m for m in metas}
        paths = [path for path, _ in _leaf_paths(like)]

        loaded = {p: self._load(reader, by_path[p], device) for p in paths if first(p)}
        partial_tree = tree_unflatten(
            like, [loaded[p] if p in loaded else self._zeros(by_path[p], device) for p in paths]
        )

        def finish() -> PyTree:
            leaves = []
            for p in paths:
                m = by_path[p]
                if p in loaded:
                    # The JAX package reads these leaves again; their blocks
                    # are cached, so that read only counts their bytes as
                    # useful once more (read_amplification carries it).
                    reader.stats.useful_bytes += m.nbytes
                    leaves.append(loaded[p])
                else:
                    leaves.append(self._load(reader, m, device))
            return tree_unflatten(like, leaves)

        return partial_tree, finish, reader

    def iter_blocks(self, step: int) -> Iterator[bytes]:
        """Compressed blocks in order — the unit FaaSNet streams down FTs."""
        with BlockReader(self._paths(step)[0]) as reader:
            for i in range(reader.manifest.n_blocks):
                yield reader.fetch_block_compressed(i)
