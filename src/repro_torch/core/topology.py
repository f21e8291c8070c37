"""Distribution topologies: FaaSNet FTs vs the paper's comparison systems.

The simulator (``repro_torch.sim``) is topology-agnostic: each system under test
is described by a :class:`DistributionPlan` — for every node that needs the
payload, *whom* it fetches each piece from and what control-plane overheads
apply.  This module builds plans for:

  * ``faasnet``    — per-function balanced binary FT (this paper);
  * ``baseline``   — every VM pulls the whole image from the central
                     registry (Alibaba's production setup, `docker pull`);
  * ``on_demand``  — like ``baseline`` but fetches only the startup subset
                     of blocks, still from the registry (paper's optimized
                     baseline);
  * ``kraken``     — layer-granularity trees with a dedicated origin/root
                     serving seeding + metadata + coordination (paper §3.4,
                     Figure 10: overlapping layer trees form an all-to-all
                     mesh across VMs);
  * ``dadi_p2p``   — tree-structured P2P with a single resource-constrained
                     root VM that both seeds data and manages topology.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field

from .function_tree import FunctionTree
from .registry import (  # noqa: F401  (REGISTRY re-exported for compat)
    REGISTRY,
    RegistrySpec,
    ShardResolver,
    as_resolver,
)

# Every registry-sourced plan builder takes ``registry`` — a
# :class:`RegistrySpec`, a shared :class:`ShardResolver`, or ``None`` for the
# legacy single-shard registry — and emits flows whose source is a concrete
# shard id (the 1-shard id *is* the legacy ``__registry__`` sentinel, so
# default plans are unchanged).  Pass one resolver across plans when a
# stateful policy (least_loaded / replicated) must see every assignment.


@dataclass(frozen=True)
class Flow:
    """One piece of payload moving src → dst (control plane already resolved)."""

    src: str
    dst: str
    piece: str  # e.g. "img" for whole payload, "layer3", "blk:17"
    bytes: int
    # Leading bytes of this flow that belong to the dst's boot working set
    # (paper §3.2): once they land the engine fires ``on_node_runnable`` for
    # the dst, ahead of full arrival.  0 (the default) means the flow carries
    # no runnable prefix — scalar plans are unchanged.
    runnable_bytes: int = 0


@dataclass
class DistributionPlan:
    """Everything the simulator needs to time one provisioning wave."""

    flows: list[Flow]
    # Per-node extra control-plane latency before its first fetch starts
    # (metadata RPCs, manifest download, coordination with a root).
    control_latency: dict[str, float] = field(default_factory=dict)
    # Nodes whose CPU does coordination work per downstream request (the
    # Kraken origin / DADI root bottleneck): dst-node -> coordinator node.
    coordinator: dict[str, str] = field(default_factory=dict)
    # Whether a node may forward a piece downstream before holding all of it
    # (FaaSNet streams block-by-block; docker-pull systems do not).
    streaming: bool = True


# ----------------------------------------------------------------------
# FaaSNet
# ----------------------------------------------------------------------
def faasnet_plan(
    ft: FunctionTree,
    *,
    image_bytes: int,
    startup_fraction: float = 1.0,
    manifest_latency: float = 0.010,
    piece: str = "img",
    registry: RegistrySpec | ShardResolver | None = None,
) -> DistributionPlan:
    """Blocks stream down FT edges; root fetches from its blob's shard.

    ``startup_fraction`` < 1 models on-demand fetch: only that fraction of
    the payload must arrive before the container can start (§3.5).
    ``piece`` labels the payload — pass the function id when many FTs share
    one simulation so flows stay distinguishable in traces and logs (it is
    also the blob key the shard resolver hashes under ``hash_by_function``).
    """
    need = int(image_bytes * startup_fraction)
    resolver = as_resolver(registry)
    flows = []
    control = {}
    for node in ft.bfs():
        up = ft.parent_of(node.vm_id) or resolver.source_for(piece, nbytes=need)
        flows.append(Flow(up, node.vm_id, piece, need))
        control[node.vm_id] = manifest_latency  # fetch .tar manifest from MDS
    return DistributionPlan(flows=flows, control_latency=control, streaming=True)


# ----------------------------------------------------------------------
# Centralized baselines
# ----------------------------------------------------------------------
def baseline_plan(
    nodes: list[str],
    *,
    image_bytes: int,
    piece: str = "img",
    registry: RegistrySpec | ShardResolver | None = None,
) -> DistributionPlan:
    """docker pull: whole image from its registry shard, no streaming start."""
    resolver = as_resolver(registry)
    flows = [
        Flow(resolver.source_for(piece, nbytes=image_bytes), n, piece, image_bytes)
        for n in nodes
    ]
    return DistributionPlan(flows=flows, streaming=False)


def on_demand_plan(
    nodes: list[str],
    *,
    image_bytes: int,
    startup_fraction: float,
    manifest_latency: float = 0.010,
    piece: str = "img",
    registry: RegistrySpec | ShardResolver | None = None,
) -> DistributionPlan:
    """Registry-served lazy fetch: less data, same per-shard bottleneck."""
    need = int(image_bytes * startup_fraction)
    resolver = as_resolver(registry)
    flows = [
        Flow(resolver.source_for(piece, nbytes=need), n, piece, need)
        for n in nodes
    ]
    control = {n: manifest_latency for n in nodes}
    return DistributionPlan(flows=flows, control_latency=control, streaming=True)


# ----------------------------------------------------------------------
# Kraken-like: layer trees + origin root (paper Figure 10)
# ----------------------------------------------------------------------
def kraken_plan(
    nodes: list[str],
    *,
    layer_bytes: list[int],
    origin: str,
    seed: int = 0,
    max_peers: int = 4,
    manifest_latency: float = 0.010,
) -> DistributionPlan:
    """Each layer forms its own random peer graph rooted at the origin.

    Every node fetches every layer; the source for (node, layer) is a random
    peer among the up-to-``max_peers`` nodes immediately before it in that
    layer's join order (the layer's first joiner seeds from the origin).
    Because layer trees are independent, a node ends
    up with inbound+outbound edges across many trees — the all-to-all mesh
    the paper argues overwhelms 1 Gbps NICs.  The origin additionally
    coordinates every (node, layer) announce — serialized on its CPU by the
    simulator (``SimConfig.coordinator_cost_s``) — so it is both data seeder
    and metadata bottleneck.

    Kraken never touches the registry directly (the origin VM pre-seeds the
    layers), so this builder takes no ``registry`` argument: sharding the
    registry cannot help it — exactly the contrast the shard sweep shows.
    """
    rng = random.Random(seed)
    flows = []
    coordinator = {}
    for li, lb in enumerate(layer_bytes):
        order = list(nodes)
        rng.shuffle(order)  # per-layer join order differs → overlapping trees
        for i, n in enumerate(order):
            if i == 0:
                src = origin
            else:
                src = order[rng.randrange(max(0, i - max_peers), i)]
            flows.append(Flow(src, n, f"layer{li}", lb))
        for n in order:
            coordinator[n] = origin
    control = {n: manifest_latency for n in nodes}
    return DistributionPlan(
        flows=flows, control_latency=control, coordinator=coordinator, streaming=False
    )


# ----------------------------------------------------------------------
# DADI + P2P: single tree, resource-constrained root doing double duty
# ----------------------------------------------------------------------
def dadi_plan(
    nodes: list[str],
    *,
    image_bytes: int,
    root: str,
    fanout: int = 4,
    startup_fraction: float = 1.0,
    manifest_latency: float = 0.010,
    registry: RegistrySpec | ShardResolver | None = None,
) -> DistributionPlan:
    """Static tree rooted at a dedicated VM; root also manages the topology.

    DADI's tree has higher fan-out and is not rebalanced; the root VM pays a
    serialized coordination cost for every joining node (paper §4.3: 'the
    root VM ... is responsible for a series of extra tasks such as
    layer-tree topology establishment and coordination'), applied via
    ``SimConfig.coordinator_cost_s``.
    """
    need = int(image_bytes * startup_fraction)
    resolver = as_resolver(registry)
    flows = [Flow(resolver.source_for("img", nbytes=need), root, "img", need)]
    coordinator = {}
    parents = [root]
    i = 0
    for n in nodes:
        if n == root:
            continue
        parent = parents[i // fanout]
        i += 1
        flows.append(Flow(parent, n, "img", need))
        parents.append(n)
        coordinator[n] = root
    control = {n: manifest_latency for n in nodes}
    return DistributionPlan(
        flows=flows, control_latency=control, coordinator=coordinator, streaming=True
    )


# ----------------------------------------------------------------------
# Block-level plans (paper §3.1–§3.2): per-layer flows, cache-aware
# ----------------------------------------------------------------------
# These builders replace the scalar ``image_bytes * startup_fraction`` model
# with an :class:`~repro_torch.core.image.ImageSpec`: one flow per *missing* layer
# (blocks already resident in the VM's :class:`~repro_torch.core.image.BlockCache`
# are served locally and never travel), with ``Flow.runnable_bytes`` marking
# each flow's share of the boot working set so the engines can fire the
# runnable milestone ahead of full arrival.  Pieces are layer *digests* —
# content-addressed, so shard hashing and streaming chains line up across
# functions sharing base layers.


def _cached_marker_flow(src: str, vm: str, image_name: str) -> Flow:
    """Zero-byte flow for a fully resident node: milestones must still fire."""
    return Flow(src, vm, f"{image_name}:cached", 0)


def faasnet_block_plan(
    ft: FunctionTree,
    *,
    image,
    cache=None,
    manifest_latency: float = 0.010,
    registry: RegistrySpec | ShardResolver | None = None,
) -> DistributionPlan:
    """Per-layer FT streaming with block-cache skips.

    Each missing layer streams down the node's FT edge as its own flow.  A
    parent holding the layer serves it from cache (§3.1) — there is then no
    parent-side flow with that digest, so the child's stream is unchained
    and runs at full NIC rate.  The root sources each missing layer from the
    shard its digest hashes to.
    """
    from .image import BlockCache

    cache = cache if cache is not None else BlockCache()
    resolver = as_resolver(registry)
    flows = []
    control = {}
    for node in ft.bfs():
        vm = node.vm_id
        parent = ft.parent_of(vm)
        n_before = len(flows)
        for la in image.layers:
            need, boot = cache.missing_layer_bytes(vm, image, la.digest)
            if need <= 0:
                continue
            src = parent or resolver.source_for(la.digest, nbytes=need)
            flows.append(Flow(src, vm, la.digest, need, runnable_bytes=boot))
        if len(flows) == n_before:
            src = parent or resolver.source_for(image.name, nbytes=0)
            flows.append(_cached_marker_flow(src, vm, image.name))
        control[vm] = manifest_latency
    return DistributionPlan(flows=flows, control_latency=control, streaming=True)


def on_demand_block_plan(
    nodes: list[str],
    *,
    image,
    cache=None,
    manifest_latency: float = 0.010,
    registry: RegistrySpec | ShardResolver | None = None,
) -> DistributionPlan:
    """Registry-served lazy block fetch: missing layers only, runnable at prefix."""
    from .image import BlockCache

    cache = cache if cache is not None else BlockCache()
    resolver = as_resolver(registry)
    flows = []
    for n in nodes:
        n_before = len(flows)
        for la in image.layers:
            need, boot = cache.missing_layer_bytes(n, image, la.digest)
            if need <= 0:
                continue
            src = resolver.source_for(la.digest, nbytes=need)
            flows.append(Flow(src, n, la.digest, need, runnable_bytes=boot))
        if len(flows) == n_before:
            flows.append(
                _cached_marker_flow(resolver.source_for(image.name, nbytes=0), n, image.name)
            )
    control = {n: manifest_latency for n in nodes}
    return DistributionPlan(flows=flows, control_latency=control, streaming=True)


def baseline_block_plan(
    nodes: list[str],
    *,
    image,
    cache=None,
    registry: RegistrySpec | ShardResolver | None = None,
) -> DistributionPlan:
    """docker pull with a layer cache: whole missing layers, runnable == arrival.

    Docker's cache is layer-granular and all-or-nothing — a partially
    resident layer is re-pulled whole — and a container cannot start before
    the full pull, so every flow's runnable prefix is its entire payload.
    """
    from .image import BlockCache

    cache = cache if cache is not None else BlockCache()
    resolver = as_resolver(registry)
    flows = []
    for n in nodes:
        n_before = len(flows)
        for la in image.layers:
            if cache.resident_blocks(n, la.digest) >= image.layer_blocks(la.digest):
                continue  # fully cached layer: docker skips it
            src = resolver.source_for(la.digest, nbytes=la.size)
            flows.append(Flow(src, n, la.digest, la.size, runnable_bytes=la.size))
        if len(flows) == n_before:
            flows.append(
                _cached_marker_flow(resolver.source_for(image.name, nbytes=0), n, image.name)
            )
    return DistributionPlan(flows=flows, streaming=False)
