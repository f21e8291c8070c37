"""Block/layer image model for on-demand provisioning (paper §3.1–§3.2).

The paper's I/O claim (§3.2, Fig. 20) has three parts this module makes
first-class:

  * images are stacks of **content-addressed layers** — two functions built
    from the same base image share those layers' blocks byte-for-byte;
  * a container is *runnable* once the **boot working set** — the leading
    prefix of blocks, front-to-back across layers — has landed, long before
    the full image has materialized;
  * every VM keeps a **block cache**: blocks that already landed (for any
    function) are served locally and never re-fetched, and a peer holding
    them can seed them downstream (§3.1).

:class:`ImageSpec` turns a layer stack into block geometry by reusing
:class:`~repro_torch.core.blockstore.BlockManifest` — each layer gets an
identity-offset manifest (block boundaries, covering-range math, tail-block
sizing), so the simulator and the real on-disk format agree on which blocks
a byte range touches.  :class:`BlockCache` tracks per-VM resident block
*prefixes* per layer digest — both boot working sets and fully materialized
layers are prefixes, so residency is a single block count with max-merge
semantics.  The plan builders in :mod:`repro_torch.core.topology` consume both to
emit per-layer flows that skip resident blocks.
"""
from __future__ import annotations

from dataclasses import dataclass

from .blockstore import DEFAULT_BLOCK_SIZE, BlockManifest


@dataclass(frozen=True)
class LayerSpec:
    """One content-addressed layer: the unit of cross-function sharing."""

    digest: str
    size: int

    def __post_init__(self) -> None:
        if self.size < 0:
            raise ValueError(f"layer {self.digest!r} has negative size {self.size}")


@dataclass(frozen=True)
class ImageSpec:
    """A container image: ordered layers + block geometry + boot working set.

    ``boot_fraction`` is the fraction of the image (front-to-back across
    layers, base layers first) that must land before the container is
    *runnable* — the same knob the scalar model calls ``startup_fraction``,
    now resolved to concrete block prefixes per layer.
    """

    name: str
    layers: tuple[LayerSpec, ...]
    block_size: int = DEFAULT_BLOCK_SIZE
    boot_fraction: float = 0.15

    def __post_init__(self) -> None:
        if not self.layers:
            raise ValueError(f"image {self.name!r} has no layers")
        if self.block_size <= 0:
            raise ValueError(f"block_size must be positive (got {self.block_size})")
        if not 0.0 < self.boot_fraction <= 1.0:
            raise ValueError(
                f"boot_fraction must be in (0, 1] (got {self.boot_fraction})"
            )
        digests = [la.digest for la in self.layers]
        if len(set(digests)) != len(digests):
            raise ValueError(f"image {self.name!r} repeats a layer digest")
        # Identity-keyed memo caches (object.__setattr__: the dataclass is
        # frozen, and these are derived state, not fields — eq/hash/repr are
        # untouched).  layer()/geometry()/boot_blocks() are pure functions
        # of the frozen spec but sit on the content-affinity hot path —
        # scored once per candidate VM per reservation — where recomputing
        # block geometry dominated giga-replay wall time.
        object.__setattr__(
            self, "_layer_by_digest", {la.digest: la for la in self.layers}
        )
        object.__setattr__(self, "_geom_cache", {})
        object.__setattr__(self, "_boot_blocks_cache", None)

    # -- layer lookup ----------------------------------------------------
    def layer(self, digest: str) -> LayerSpec:
        try:
            return self._layer_by_digest[digest]
        except KeyError:
            raise KeyError(
                f"image {self.name!r} has no layer {digest!r}"
            ) from None

    def total_bytes(self) -> int:
        return sum(la.size for la in self.layers)

    # -- block geometry (BlockManifest reuse) -----------------------------
    def geometry(self, digest: str) -> BlockManifest:
        """Identity-offset manifest for one layer: pure block math.

        Offsets equal the raw block boundaries (no compression modeled at
        this granularity), so ``block_range_for`` / ``block_raw_size`` — the
        exact covering-range arithmetic the on-disk format uses — apply
        verbatim to the simulated layer.
        """
        g = self._geom_cache.get(digest)
        if g is not None:
            return g
        size = self.layer(digest).size
        bs = self.block_size
        n = max(1, -(-size // bs))
        offsets = tuple(min(i * bs, size) for i in range(n)) + (size,)
        g = BlockManifest(bs, n, size, offsets)
        self._geom_cache[digest] = g
        return g

    def layer_blocks(self, digest: str) -> int:
        return self.geometry(digest).n_blocks

    def prefix_bytes(self, digest: str, n_blocks: int) -> int:
        """Raw bytes held by the first ``n_blocks`` blocks of a layer."""
        g = self.geometry(digest)
        if n_blocks <= 0:
            return 0
        if n_blocks >= g.n_blocks:
            return g.raw_size
        return n_blocks * g.block_size

    # -- boot working set -------------------------------------------------
    def boot_bytes(self) -> int:
        """Unaligned boot working-set size (the scalar model's ``need``)."""
        return int(self.total_bytes() * self.boot_fraction)

    def boot_blocks(self) -> dict[str, int]:
        """Per-layer boot-prefix block counts, front-to-back across layers.

        The boot budget is consumed layer by layer (base layers first); the
        blocks *covering* each layer's share are the runnable prefix —
        block alignment is where Fig. 20's read amplification comes from.
        """
        cached = self._boot_blocks_cache
        if cached is not None:
            return dict(cached)
        budget = self.boot_bytes()
        out: dict[str, int] = {}
        for la in self.layers:
            take = min(budget, la.size)
            budget -= take
            if take <= 0:
                out[la.digest] = 0
                continue
            first, last = self.geometry(la.digest).block_range_for(0, take)
            out[la.digest] = last - first + 1
        object.__setattr__(self, "_boot_blocks_cache", dict(out))
        return out

    def boot_prefix_bytes(self, digest: str) -> int:
        """Block-aligned bytes that must land for this layer's boot share."""
        return self.prefix_bytes(digest, self.boot_blocks()[digest])

    def boot_read_amplification(self) -> float:
        """Fetched/useful ratio for the boot working set (paper Fig. 20).

        Block alignment rounds each layer's boot share up to whole blocks;
        bigger blocks waste more bytes past the working-set edge, so this
        grows with ``block_size`` — the sweep ``bench_blocks.py`` plots.
        """
        useful = self.boot_bytes()
        if useful <= 0:
            return 1.0
        fetched = sum(self.boot_prefix_bytes(la.digest) for la in self.layers)
        return fetched / useful


class BlockCache:
    """Per-VM resident block prefixes, keyed by layer digest (§3.1).

    Residency is a *prefix* block count per (vm, digest): boot working sets
    and fully materialized layers are both prefixes, and a parent always
    holds (or is concurrently fetching) any prefix its child needs, so one
    integer with max-merge updates captures the whole state.  This is
    data-plane state — it lives with the VMs, not the scheduler, and
    deliberately does NOT ride the failover snapshot (a restored scheduler
    rediscovers residency exactly like a real one would).
    """

    def __init__(self) -> None:
        self._vm: dict[str, dict[str, int]] = {}

    def resident_blocks(self, vm_id: str, digest: str) -> int:
        return self._vm.get(vm_id, {}).get(digest, 0)

    def add_prefix(self, vm_id: str, digest: str, n_blocks: int) -> None:
        """Record that the first ``n_blocks`` of a layer landed (max-merge)."""
        if n_blocks <= 0:
            return
        d = self._vm.setdefault(vm_id, {})
        if n_blocks > d.get(digest, 0):
            d[digest] = n_blocks

    def add_image(self, vm_id: str, image: ImageSpec) -> None:
        """A full image materialized on the VM: every layer fully resident."""
        for la in image.layers:
            self.add_prefix(vm_id, la.digest, image.layer_blocks(la.digest))

    def evict(self, vm_id: str) -> None:
        """VM reclaimed: its block cache goes with it."""
        self._vm.pop(vm_id, None)

    def vms(self):
        """VM ids holding any resident blocks (content-root candidate set)."""
        return self._vm.keys()

    def resident_bytes(self, vm_id: str, image: ImageSpec) -> int:
        """Bytes of ``image`` already on the VM (content-aware placement score)."""
        held = self._vm.get(vm_id)
        if not held:
            return 0
        total = 0
        for la in image.layers:
            n = held.get(la.digest, 0)
            if n:
                total += image.prefix_bytes(
                    la.digest, min(n, image.layer_blocks(la.digest))
                )
        return total

    def missing_layer_bytes(
        self, vm_id: str, image: ImageSpec, digest: str
    ) -> tuple[int, int]:
        """(full-layer, boot-prefix) bytes a VM still needs of one layer.

        The first element sizes the materialization flow (everything not
        resident); the second is the runnable prefix within that flow —
        boot blocks not yet resident.  Both are 0 for a fully cached layer.
        """
        have = image.prefix_bytes(
            digest,
            min(self.resident_blocks(vm_id, digest), image.layer_blocks(digest)),
        )
        full = image.layer(digest).size - have
        boot = max(0, image.boot_prefix_bytes(digest) - have)
        return full, boot


# ----------------------------------------------------------------------
# Workload builders: the layer-sharing scenarios the ROADMAP names
# ----------------------------------------------------------------------
def shared_base_images(
    n_functions: int,
    n_bases: int,
    *,
    image_bytes: int,
    base_fraction: float = 0.8,
    base_layers: int = 3,
    block_size: int = DEFAULT_BLOCK_SIZE,
    boot_fraction: float = 0.15,
) -> list[ImageSpec]:
    """N functions built from ``n_bases`` shared base images (+1 private layer).

    Function ``i`` stacks the content-addressed base layers of base
    ``i % n_bases`` under a function-private app layer — the "25 functions
    on 3 base images" scenario: base blocks dedup across every function on
    the same base, only the private layer is unique traffic.
    """
    if n_functions < 1 or n_bases < 1:
        raise ValueError("need >= 1 function and >= 1 base")
    base_bytes = int(image_bytes * base_fraction)
    per_layer = base_bytes // base_layers
    sizes = [per_layer] * (base_layers - 1) + [base_bytes - per_layer * (base_layers - 1)]
    private = image_bytes - base_bytes
    images = []
    for i in range(n_functions):
        b = i % n_bases
        layers = tuple(
            LayerSpec(f"base{b}:L{j}", sz) for j, sz in enumerate(sizes)
        ) + (LayerSpec(f"fn{i}:app", private),)
        images.append(
            ImageSpec(f"fn{i}", layers, block_size=block_size, boot_fraction=boot_fraction)
        )
    return images


def disjoint_images(
    n_functions: int,
    *,
    image_bytes: int,
    base_fraction: float = 0.8,
    base_layers: int = 3,
    block_size: int = DEFAULT_BLOCK_SIZE,
    boot_fraction: float = 0.15,
) -> list[ImageSpec]:
    """Same layer structure as :func:`shared_base_images`, zero sharing.

    Every function gets its own "base" (``n_bases == n_functions``), so the
    two builders differ only in digest identity — the clean A/B for how much
    layer sharing is worth.
    """
    return shared_base_images(
        n_functions,
        n_functions,
        image_bytes=image_bytes,
        base_fraction=base_fraction,
        base_layers=base_layers,
        block_size=block_size,
        boot_fraction=boot_fraction,
    )
