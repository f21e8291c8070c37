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
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.blockstore import (
    DEFAULT_BLOCK_SIZE,
    BlockReader,
    write_blockstore,
)
from repro_torch.models.params import tree_leaves_with_path, tree_unflatten

PyTree = Any


def _leaf_paths(tree: PyTree) -> list[tuple[str, Any]]:
    return [("/".join(map(str, path)), leaf) for path, leaf in tree_leaves_with_path(tree)]


def _leaf_bytes(leaf) -> tuple[bytes, str, tuple[int, ...]]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().tobytes(), "bfloat16", tuple(t.shape)
        leaf = t.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16).tobytes(), "bfloat16", tuple(arr.shape)
    return arr.tobytes(), str(arr.dtype), tuple(arr.shape)


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
        """Write ``tree`` (tensors or numpy arrays) as checkpoint ``step``."""
        metas: list[LeafMeta] = []
        bufs: list[bytes] = []
        off = 0
        for path, leaf in _leaf_paths(tree):
            raw, dtype, shape = _leaf_bytes(leaf)
            metas.append(LeafMeta(path, shape, dtype, off, len(raw)))
            bufs.append(raw)
            off += len(raw)
        payload = b"".join(bufs)

        def write() -> None:
            bpath, mpath = self._paths(step)
            manifest = write_blockstore(payload, bpath, block_size=self.block_size)
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
    def _decode(meta: LeafMeta, raw: bytes, device) -> torch.Tensor:
        if meta.dtype == "bfloat16":
            bits = np.frombuffer(raw, np.int16).reshape(meta.shape)
            return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
        arr = np.frombuffer(raw, np.dtype(meta.dtype)).reshape(meta.shape)
        return torch.from_numpy(arr.copy()).to(device)

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
                leaves.append(self._decode(m, reader.read_range(m.offset, m.nbytes), device))
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
        reader for fetch statistics).  ``finish()`` returns the full tree.
        """
        _, metas = self._load_manifest(step)
        reader = BlockReader(self._paths(step)[0])
        by_path = {m.path: m for m in metas}
        paths = [path for path, _ in _leaf_paths(like)]

        def load(pred):
            leaves = []
            for path in paths:
                m = by_path[path]
                if pred(path):
                    raw = reader.read_range(m.offset, m.nbytes)
                    leaves.append(self._decode(m, raw, device))
                else:
                    leaves.append(self._zeros(m, device))
            return tree_unflatten(like, leaves)

        partial_tree = load(first)

        def finish() -> PyTree:
            return load(lambda p: True)

        return partial_tree, finish, reader

    def iter_blocks(self, step: int) -> Iterator[bytes]:
        """Compressed blocks in order — the unit FaaSNet streams down FTs."""
        with BlockReader(self._paths(step)[0]) as reader:
            for i in range(reader.manifest.n_blocks):
                yield reader.fetch_block_compressed(i)
