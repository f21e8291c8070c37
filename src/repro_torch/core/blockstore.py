"""Block geometry of the I/O-efficient block format (paper §3.5).

The payload (a container image in the paper) is split into fixed-size
blocks, each compressed separately and written back-to-back; an offset
table records where each compressed block begins.  The provisioning path
needs only the geometry: :class:`BlockManifest` says which blocks cover a
byte range and how large each is, and ``core/image.py`` builds one per
layer.  The reader, the writer and the codecs belong to the checkpoint
path and are not part of this package yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field

DEFAULT_BLOCK_SIZE = 512 * 1024  # paper's production setting (512 KB)


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
