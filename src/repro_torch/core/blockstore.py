"""I/O-efficient block format with on-demand fetch (paper §3.5).

Original payload (a container image in the paper; a checkpoint shard / code
package here) is split into fixed-size blocks, each compressed *separately*,
and written back-to-back.  An offset table records where each compressed
block begins, so a reader can satisfy an arbitrary ``(offset, length)``
range request by touching only ``ceil`` of the covering blocks — the
on-demand I/O mechanism.  Reads must align to block boundaries, which
causes bounded *read amplification* at the two ends of the range (paper
§4.6); :meth:`BlockReader.read_range` reports both useful and fetched bytes
so benchmarks can reproduce Figure 20.

Layout of a blockstore file::

    [magic u32][version u32][block_size u64][n_blocks u64][raw_size u64]
    [offset table: (n_blocks + 1) * u64]          # offsets into data area
    [compressed block 0][compressed block 1]...

Compression codec: zstd when the ``zstandard`` package is available (the
paper's production choice), with a pure-stdlib ``zlib`` fallback so the
format — and everything layered on it — works on a bare interpreter.  The
codec is encoded in the header ``version`` field (1 = zstd, 2 = zlib), so
readers always know how a file was written; reading a zstd file without
``zstandard`` installed raises a clear error instead of corrupt output.

The format is used by three layers:
  * ``checkpoint/`` — every checkpoint shard is a blockstore file, byte for
    byte the file the JAX package writes for the same payload and codec;
  * ``core/image.py`` / ``sim/`` — the unit streamed down an FT edge is one
    (compressed) block;
  * code-package distribution (paper §4.5) — same format, same path.
"""
from __future__ import annotations

import io
import os
import struct
import threading
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator

import numpy as np

try:  # optional: zstd is the production codec, zlib the stdlib fallback
    import zstandard as _zstd
except ImportError:  # pragma: no cover - exercised on bare interpreters
    _zstd = None

MAGIC = 0xFAA5_0001
# Header ``version`` doubles as the codec id so old files stay readable.
VERSION_ZSTD = 1
VERSION_ZLIB = 2
VERSION = VERSION_ZSTD  # kept for backwards compatibility of the constant
DEFAULT_BLOCK_SIZE = 512 * 1024  # paper's production setting (512 KB)

_CODEC_BY_VERSION = {VERSION_ZSTD: "zstd", VERSION_ZLIB: "zlib"}
_VERSION_BY_CODEC = {v: k for k, v in _CODEC_BY_VERSION.items()}

_HEADER = struct.Struct("<IIQQQ")


def have_zstd() -> bool:
    return _zstd is not None


def default_codec() -> str:
    return "zstd" if _zstd is not None else "zlib"


class _ZstdCodec:
    name = "zstd"

    def __init__(self, level: int = 3) -> None:
        if _zstd is None:
            raise RuntimeError(
                "file requires the 'zstandard' package (codec zstd), which is "
                "not installed; re-write the payload with codec='zlib'"
            )
        self._c = _zstd.ZstdCompressor(level=level)
        self._d = _zstd.ZstdDecompressor()

    def compress(self, data: bytes) -> bytes:
        return self._c.compress(data)

    def decompress(self, data: bytes, raw_size: int) -> bytes:
        return self._d.decompress(data, max_output_size=raw_size)


class _ZlibCodec:
    name = "zlib"

    def __init__(self, level: int = 6) -> None:
        self._level = min(max(level, 0), 9)

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data, self._level)

    def decompress(self, data: bytes, raw_size: int) -> bytes:
        out = zlib.decompress(data, bufsize=max(raw_size, 1))
        if len(out) > raw_size:
            raise ValueError(f"block decompressed to {len(out)} > {raw_size} bytes")
        return out


def _make_codec(name: str, level: int | None = None):
    """Build a codec; ``level=None`` means the codec's own default (zstd 3 / zlib 6)."""
    if name == "zstd":
        return _ZstdCodec() if level is None else _ZstdCodec(level)
    if name == "zlib":
        return _ZlibCodec() if level is None else _ZlibCodec(level)
    raise ValueError(f"unknown blockstore codec {name!r}")


def default_workers() -> int:
    """The cores this process may run on: zlib and zstd release the GIL."""
    return len(os.sched_getaffinity(0))


class _ThreadCodecs:
    """One codec per thread (a zstd context is not safe across threads)."""

    def __init__(self, name: str, level: int | None = None) -> None:
        self._make = lambda: _make_codec(name, level)
        self._local = threading.local()
        self._make()  # raise here, not on a worker, if the codec is missing

    def get(self):
        codec = getattr(self._local, "codec", None)
        if codec is None:
            codec = self._local.codec = self._make()
        return codec


def _ordered_map(fn: Callable, items: Iterable, pool: ThreadPoolExecutor | None,
                 ahead: int) -> Iterator:
    """``map(fn, items)`` on ``pool``, results in order, at most ``ahead``
    items in flight (so a long stream is never held whole)."""
    if pool is None:
        yield from map(fn, items)
        return
    window: deque = deque()
    try:
        for item in items:
            window.append(pool.submit(fn, item))
            if len(window) >= ahead:
                yield window.popleft().result()
        while window:
            yield window.popleft().result()
    finally:
        for fut in window:
            fut.cancel()


def _cut_blocks(chunks: Iterable, block_size: int) -> Iterator:
    """The concatenation of ``chunks`` (bytes-like) cut into ``block_size``
    blocks, the last one short; blocks inside one chunk are views of it."""
    pending = bytearray()
    for chunk in chunks:
        mv = memoryview(chunk).cast("B")
        if pending:
            take = min(block_size - len(pending), len(mv))
            pending += mv[:take]
            mv = mv[take:]
            if len(pending) < block_size:
                continue
            yield bytes(pending)
            pending = bytearray()
        whole = len(mv) - len(mv) % block_size
        for i in range(0, whole, block_size):
            yield mv[i : i + block_size]
        pending += mv[whole:]
    if pending:
        yield bytes(pending)


@dataclass(frozen=True)
class BlockManifest:
    """The metadata-store entry for one payload (paper: the image manifest).

    The manifest is what a worker downloads first (provisioning protocol
    step 2): it is tiny, and from it the worker derives exactly which blocks
    any byte range needs.
    """

    block_size: int
    n_blocks: int
    raw_size: int
    offsets: tuple[int, ...]  # n_blocks + 1 entries into the data area
    codec: str = field(default="zstd", compare=False)

    def compressed_size(self) -> int:
        return self.offsets[-1]

    def block_range_for(self, offset: int, length: int) -> tuple[int, int]:
        """[first, last] block indices covering raw range [offset, offset+length)."""
        if length <= 0:
            return (0, -1)
        first = offset // self.block_size
        last = (offset + length - 1) // self.block_size
        return first, min(last, self.n_blocks - 1)

    def block_compressed_size(self, i: int) -> int:
        return self.offsets[i + 1] - self.offsets[i]

    def block_raw_size(self, i: int) -> int:
        if i < self.n_blocks - 1:
            return self.block_size
        rem = self.raw_size - self.block_size * (self.n_blocks - 1)
        return rem

    def to_dict(self) -> dict:
        return {
            "block_size": self.block_size,
            "n_blocks": self.n_blocks,
            "raw_size": self.raw_size,
            "offsets": list(self.offsets),
            "codec": self.codec,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BlockManifest":
        return cls(
            d["block_size"],
            d["n_blocks"],
            d["raw_size"],
            tuple(d["offsets"]),
            d.get("codec", "zstd"),
        )


def write_blockstore(
    payload: bytes,
    path: str,
    *,
    block_size: int = DEFAULT_BLOCK_SIZE,
    level: int | None = None,
    codec: str | None = None,
    workers: int | None = None,
) -> BlockManifest:
    """Convert ``payload`` into the I/O-efficient format (gateway's job, §3.1).

    ``codec`` defaults to zstd when available, else the stdlib zlib fallback.
    ``level=None`` uses the selected codec's own default (zstd 3, zlib 6) —
    a pinned numeric level applies verbatim to whichever codec is chosen.
    Blocks are compressed on ``workers`` threads (default: the usable
    cores); the file is byte for byte the one a single thread writes.
    """
    return write_blockstore_chunks(
        [payload], memoryview(payload).nbytes, path,
        block_size=block_size, level=level, codec=codec, workers=workers,
    )


def write_blockstore_chunks(
    chunks: Iterable,
    raw_size: int,
    path: str,
    *,
    block_size: int = DEFAULT_BLOCK_SIZE,
    level: int | None = None,
    codec: str | None = None,
    workers: int | None = None,
) -> BlockManifest:
    """:func:`write_blockstore` of the concatenation of ``chunks`` (bytes-like,
    ``raw_size`` bytes in all), streamed: blocks are cut across chunk
    boundaries and written in order as they are compressed, so neither the
    payload nor its compressed blocks are ever held whole."""
    codec = codec or default_codec()
    codecs = _ThreadCodecs(codec, level)
    workers = default_workers() if workers is None else workers
    n_blocks = max(1, -(-raw_size // block_size))
    blocks = _cut_blocks(chunks, block_size) if raw_size else iter([b""])

    def compress(block) -> tuple[int, bytes]:
        return len(block), codecs.get().compress(block)

    offsets = [0]
    seen = 0
    tmp = path + ".tmp"
    pool = ThreadPoolExecutor(workers) if workers > 1 else None
    try:
        with open(tmp, "wb") as f:
            f.write(
                _HEADER.pack(MAGIC, _VERSION_BY_CODEC[codec], block_size, n_blocks, raw_size)
            )
            table_at = f.tell()
            f.write(bytes(8 * (n_blocks + 1)))  # the offset table, filled in below
            for n_raw, comp in _ordered_map(compress, blocks, pool, 32 * workers):
                f.write(comp)
                offsets.append(offsets[-1] + len(comp))
                seen += n_raw
            if seen != raw_size or len(offsets) != n_blocks + 1:
                raise ValueError(f"chunks hold {seen} bytes, not raw_size {raw_size}")
            f.seek(table_at)
            f.write(struct.pack(f"<{n_blocks + 1}Q", *offsets))
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    os.replace(tmp, path)  # atomic publish (crash-safe checkpointing relies on it)
    return BlockManifest(block_size, n_blocks, raw_size, tuple(offsets), codec)


def read_manifest(path: str) -> BlockManifest:
    with open(path, "rb") as f:
        magic, version, block_size, n_blocks, raw_size = _HEADER.unpack(
            f.read(_HEADER.size)
        )
        if magic != MAGIC:
            raise ValueError(f"{path}: not a blockstore file (magic {magic:#x})")
        if version not in _CODEC_BY_VERSION:
            raise ValueError(f"{path}: unsupported version {version}")
        offsets = struct.unpack(f"<{n_blocks + 1}Q", f.read(8 * (n_blocks + 1)))
    return BlockManifest(
        block_size, n_blocks, raw_size, tuple(offsets), _CODEC_BY_VERSION[version]
    )


@dataclass
class ReadStats:
    """Accounting for the read-amplification analysis (paper Fig. 20)."""

    useful_bytes: int = 0  # bytes the caller asked for
    fetched_compressed: int = 0  # compressed bytes moved over the "network"
    fetched_raw: int = 0  # raw bytes materialized after decompression
    blocks_fetched: int = 0

    def amplification(self) -> float:
        return self.fetched_raw / self.useful_bytes if self.useful_bytes else 0.0


class BlockReader:
    """On-demand reader over a blockstore file with a block cache.

    Models the FaaSNet worker's lazy fetch: a range read touches only the
    covering blocks; previously fetched blocks are served from cache (the
    worker's local storage) without re-counting network bytes.

    I/O discipline: one persistent file handle for the reader's lifetime
    (use :meth:`close` or the context-manager protocol), and
    :meth:`read_range` coalesces runs of contiguous uncached blocks into a
    single seek+read — the compressed blocks are back-to-back on disk, so a
    cold sequential range costs one syscall instead of one per block.
    ``stats`` accounting is unchanged: the same per-block useful/fetched
    byte and block counts as the one-read-per-block implementation.  A
    run's blocks are decompressed on ``workers`` threads (default: the
    usable cores) and cached and counted in block order.
    """

    def __init__(self, path: str, manifest: BlockManifest | None = None, *,
                 workers: int | None = None) -> None:
        self.path = path
        self.manifest = manifest or read_manifest(path)
        self._data_start = _HEADER.size + 8 * (self.manifest.n_blocks + 1)
        self._cache: dict[int, bytes] = {}
        # decompress side: level moot; one codec per thread of the run pool
        self._codecs = _ThreadCodecs(self.manifest.codec)
        self._workers = default_workers() if workers is None else workers
        self._pool: ThreadPoolExecutor | None = None
        self._span: bytearray | None = None  # the runs' read buffer, reused
        self.stats = ReadStats()
        self._f = open(path, "rb")
        self.file_reads = 0  # seek+read syscall pairs issued (coalescing telemetry)

    # -- lifecycle -------------------------------------------------------
    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
        self._span = None

    def __enter__(self) -> "BlockReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass

    def _seek(self, data_offset: int) -> None:
        if self._f is None:
            raise ValueError(f"BlockReader for {self.path} is closed")
        self._f.seek(self._data_start + data_offset)
        self.file_reads += 1

    def _read_at(self, data_offset: int, size: int) -> bytes:
        self._seek(data_offset)
        return self._f.read(size)

    def _read_span(self, data_offset: int, size: int) -> memoryview:
        """:meth:`_read_at` into the reader's span buffer, kept from run to run:
        a fresh buffer of a multi-GB run costs more in page faults than the
        copy out of the page cache."""
        if self._span is None or len(self._span) < size:
            self._span = None  # the smaller one goes before the larger comes
            self._span = bytearray(size)
        view = memoryview(self._span)[:size]
        self._seek(data_offset)
        if self._f.readinto(view) != size:
            raise ValueError(f"{self.path}: short read of {size} bytes at {data_offset}")
        return view

    def _map(self, fn: Callable, *args) -> Iterator:
        """``map(fn, *args)``, on the reader's pool when it has workers."""
        if self._workers <= 1 or len(args[0]) <= 1:
            return map(fn, *args)
        if self._pool is None:
            self._pool = ThreadPoolExecutor(self._workers)
        return self._pool.map(fn, *args)

    # -- block-level -----------------------------------------------------
    def fetch_block_compressed(self, i: int) -> bytes:
        """Raw compressed block i — the unit streamed down FT edges."""
        m = self.manifest
        return self._read_at(m.offsets[i], m.block_compressed_size(i))

    def _decompress(self, i: int, comp) -> bytes:
        return self._codecs.get().decompress(comp, self.manifest.block_raw_size(i))

    def _ingest(self, i: int, comp, raw: bytes) -> bytes:
        """Cache block ``i`` and account for its network fetch."""
        self._cache[i] = raw
        self.stats.blocks_fetched += 1
        self.stats.fetched_compressed += len(comp)
        self.stats.fetched_raw += len(raw)
        return raw

    def get_block(self, i: int) -> bytes:
        if i in self._cache:
            return self._cache[i]
        comp = self.fetch_block_compressed(i)
        return self._ingest(i, comp, self._decompress(i, comp))

    def _fetch_run(self, first: int, last: int) -> None:
        """Fetch uncached blocks [first, last] with one read per contiguous run,
        each run's blocks decompressed on the reader's thread pool."""
        m = self.manifest
        i = first
        while i <= last:
            if i in self._cache:
                i += 1
                continue
            j = i
            while j + 1 <= last and (j + 1) not in self._cache:
                j += 1
            span = self._read_span(m.offsets[i], m.offsets[j + 1] - m.offsets[i])
            base = m.offsets[i]
            ids = range(i, j + 1)
            comps = [span[m.offsets[k] - base : m.offsets[k + 1] - base] for k in ids]
            for k, comp, raw in zip(ids, comps, self._map(self._decompress, ids, comps)):
                self._ingest(k, comp, raw)
            del comps, span  # no view of the buffer outlives the run
            i = j + 1

    # -- range-level (on-demand I/O) --------------------------------------
    def _range_blocks(self, offset: int, length: int) -> range:
        """Check the range, count it as useful, fetch its uncached blocks;
        the covering block ids."""
        m = self.manifest
        if length < 0:
            raise ValueError(f"negative read length {length}")
        if offset < 0 or offset + length > m.raw_size:
            raise ValueError(
                f"range [{offset}, {offset + length}) outside payload of {m.raw_size}"
            )
        self.stats.useful_bytes += length
        first, last = m.block_range_for(offset, length)
        if first <= last:
            self._fetch_run(first, last)
        return range(first, last + 1)

    def _piece(self, i: int, offset: int, length: int) -> bytes | memoryview:
        """The part of cached block ``i`` inside raw range [offset, offset+length)."""
        raw = self.get_block(i)
        lo = max(0, offset - i * self.manifest.block_size)
        hi = min(len(raw), offset + length - i * self.manifest.block_size)
        return raw if (lo, hi) == (0, len(raw)) else memoryview(raw)[lo:hi]

    def read_range(self, offset: int, length: int) -> bytes:
        out = io.BytesIO()
        for i in self._range_blocks(offset, length):
            out.write(self._piece(i, offset, length))
        return out.getvalue()

    def read_range_into(self, offset: int, length: int, out) -> None:
        """:meth:`read_range` into the writable buffer ``out`` of ``length``
        bytes (a leaf's own host memory: no further copy), with the same
        accounting; the blocks are copied in on the reader's pool."""
        dst = np.frombuffer(memoryview(out).cast("B"), np.uint8)
        if dst.size != length:
            raise ValueError(f"buffer of {dst.size} bytes for a range of {length}")
        ids = self._range_blocks(offset, length)
        if not ids:
            return
        bs = self.manifest.block_size
        starts = [max(0, i * bs - offset) for i in ids]
        pieces = [self._piece(i, offset, length) for i in ids]

        def copy(group: range) -> None:  # numpy copies release the GIL
            for g in group:
                piece = np.frombuffer(pieces[g], np.uint8)
                dst[starts[g] : starts[g] + piece.size] = piece

        groups = [range(g, min(g + 16, len(ids))) for g in range(0, len(ids), 16)]
        for _ in self._map(copy, groups):
            pass

    def read_all(self) -> bytes:
        return self.read_range(0, self.manifest.raw_size)
