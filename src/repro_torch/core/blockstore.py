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
import zlib
from dataclasses import dataclass, field

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
) -> BlockManifest:
    """Convert ``payload`` into the I/O-efficient format (gateway's job, §3.1).

    ``codec`` defaults to zstd when available, else the stdlib zlib fallback.
    ``level=None`` uses the selected codec's own default (zstd 3, zlib 6) —
    a pinned numeric level applies verbatim to whichever codec is chosen.
    """
    codec = codec or default_codec()
    cctx = _make_codec(codec, level)
    n_blocks = max(1, -(-len(payload) // block_size))
    blocks = [
        cctx.compress(payload[i * block_size : (i + 1) * block_size])
        for i in range(n_blocks)
    ]
    offsets = [0]
    for b in blocks:
        offsets.append(offsets[-1] + len(b))
    manifest = BlockManifest(block_size, n_blocks, len(payload), tuple(offsets), codec)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(
            _HEADER.pack(
                MAGIC, _VERSION_BY_CODEC[codec], block_size, n_blocks, len(payload)
            )
        )
        f.write(struct.pack(f"<{n_blocks + 1}Q", *offsets))
        for b in blocks:
            f.write(b)
    os.replace(tmp, path)  # atomic publish (crash-safe checkpointing relies on it)
    return manifest


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
    byte and block counts as the one-read-per-block implementation.
    """

    def __init__(self, path: str, manifest: BlockManifest | None = None) -> None:
        self.path = path
        self.manifest = manifest or read_manifest(path)
        self._data_start = _HEADER.size + 8 * (self.manifest.n_blocks + 1)
        self._cache: dict[int, bytes] = {}
        self._codec = _make_codec(self.manifest.codec)  # decompress side: level moot
        self.stats = ReadStats()
        self._f = open(path, "rb")
        self.file_reads = 0  # seek+read syscall pairs issued (coalescing telemetry)

    # -- lifecycle -------------------------------------------------------
    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "BlockReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass

    def _read_at(self, data_offset: int, size: int) -> bytes:
        if self._f is None:
            raise ValueError(f"BlockReader for {self.path} is closed")
        self._f.seek(self._data_start + data_offset)
        self.file_reads += 1
        return self._f.read(size)

    # -- block-level -----------------------------------------------------
    def fetch_block_compressed(self, i: int) -> bytes:
        """Raw compressed block i — the unit streamed down FT edges."""
        m = self.manifest
        return self._read_at(m.offsets[i], m.block_compressed_size(i))

    def _ingest(self, i: int, comp: bytes) -> bytes:
        """Decompress + cache block ``i`` and account for the network fetch."""
        raw = self._codec.decompress(comp, self.manifest.block_raw_size(i))
        self._cache[i] = raw
        self.stats.blocks_fetched += 1
        self.stats.fetched_compressed += len(comp)
        self.stats.fetched_raw += len(raw)
        return raw

    def get_block(self, i: int) -> bytes:
        if i in self._cache:
            return self._cache[i]
        return self._ingest(i, self.fetch_block_compressed(i))

    def _fetch_run(self, first: int, last: int) -> None:
        """Fetch uncached blocks [first, last] with one read per contiguous run."""
        m = self.manifest
        i = first
        while i <= last:
            if i in self._cache:
                i += 1
                continue
            j = i
            while j + 1 <= last and (j + 1) not in self._cache:
                j += 1
            span = self._read_at(m.offsets[i], m.offsets[j + 1] - m.offsets[i])
            base = m.offsets[i]
            for k in range(i, j + 1):
                self._ingest(k, span[m.offsets[k] - base : m.offsets[k + 1] - base])
            i = j + 1

    # -- range-level (on-demand I/O) --------------------------------------
    def read_range(self, offset: int, length: int) -> bytes:
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
        out = io.BytesIO()
        for i in range(first, last + 1):
            raw = self.get_block(i)
            lo = max(0, offset - i * m.block_size)
            hi = min(len(raw), offset + length - i * m.block_size)
            out.write(raw[lo:hi])
        return out.getvalue()

    def read_all(self) -> bytes:
        return self.read_range(0, self.manifest.raw_size)
