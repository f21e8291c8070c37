"""First-class sharded container registry (paper §4.3, ROADMAP "Registry
sharding").

The paper's central scalability claim is that FaaSNet makes provisioning
latency *insensitive* to registry bandwidth, while ``docker pull`` and
on-demand fetch scale only as fast as the registry does — i.e. baseline
throughput grows ~linearly with registry replicas, FaaSNet's does not move.
Reproducing both directions of that claim needs the registry to be a real
subsystem rather than the single hardcoded ``REGISTRY`` pseudo-node the
simulator started with:

  * :class:`RegistrySpec` — N shards, per-shard egress capacity and QPS
    (optionally heterogeneous per shard, the Function-Delivery-Network
    setting of Jindal et al. 2021), and a blob-placement policy;
  * :class:`ShardResolver` — the stateful shard-assignment policy plan
    builders (:mod:`repro_torch.core.topology`) and the trace replays consult to
    turn "fetch from the registry" into "fetch from shard i";
  * node-id helpers (:func:`is_registry_node`, :func:`shard_index`) the
    engines use to recognize capped registry sources.

Placement policies
------------------
``hash_by_function``
    Each blob (keyed by the flow's ``piece`` — the function/image id) lives
    on exactly one shard, chosen by a stable CRC32 hash.  Models a sharded
    but *unreplicated* registry: one function's wave still hammers one
    shard.
``least_loaded``
    Each assignment goes to the shard with the fewest bytes assigned so
    far (ties break to the lowest index).  Models a load-balancing blob
    placer with global knowledge.
``replicated``
    Every shard holds every blob; fetchers round-robin across shards.
    Models registry *replicas* — the configuration the paper's "baseline
    scales with registry bandwidth" claim is about, and the one
    ``benchmarks/bench_registry_sweep.py`` sweeps.

Naming and backward compatibility
---------------------------------
A 1-shard registry names its only shard ``__registry__`` — the legacy
sentinel — so single-shard simulations are bit-identical to the
pre-sharding engine, event-log strings included (pinned by
``tests/test_registry.py``).  Multi-shard registries name shards
``__registry_shard{i}__``; the bare ``__registry__`` sentinel remains a
valid flow source everywhere and is treated as an alias for shard 0.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass

GBPS = 125e6  # 1 Gbit/s in bytes/s (canonically re-exported by sim.engine)

REGISTRY = "__registry__"  # legacy pseudo-node: the 1-shard registry / shard 0
_SHARD_PREFIX = "__registry_shard"
_SHARD_SUFFIX = "__"

PLACEMENT_POLICIES = ("hash_by_function", "least_loaded", "replicated")


def is_registry_node(node: str) -> bool:
    """True iff ``node`` is the legacy sentinel or a concrete shard id."""
    return node == REGISTRY or (
        node.startswith(_SHARD_PREFIX) and node.endswith(_SHARD_SUFFIX)
    )


def shard_index(node: str) -> int:
    """Shard index encoded in a registry node id (the sentinel is shard 0)."""
    if node == REGISTRY:
        return 0
    if node.startswith(_SHARD_PREFIX) and node.endswith(_SHARD_SUFFIX):
        return int(node[len(_SHARD_PREFIX) : -len(_SHARD_SUFFIX)])
    raise ValueError(f"{node!r} is not a registry node")


@dataclass(frozen=True)
class RegistrySpec:
    """Shape and capacity of the registry: N shards with per-shard caps.

    ``egress_cap`` and ``qps`` are *per shard*: adding shards adds capacity
    (the paper's replica scaling), it does not slice a fixed pool.  The
    optional ``egress_caps`` / ``qps_caps`` tuples override the scalars per
    shard for heterogeneous delivery targets.
    """

    shards: int = 1
    egress_cap: float = 5.0 * GBPS  # per-shard egress (bytes/s)
    qps: float = float("inf")  # per-shard block-request throttle (req/s)
    policy: str = "hash_by_function"
    egress_caps: tuple[float, ...] | None = None  # per-shard overrides
    qps_caps: tuple[float, ...] | None = None

    def __post_init__(self) -> None:
        if self.shards < 1:
            raise ValueError(f"registry needs >= 1 shard (got {self.shards})")
        if self.policy not in PLACEMENT_POLICIES:
            raise ValueError(
                f"unknown placement policy {self.policy!r}; "
                f"one of {PLACEMENT_POLICIES}"
            )
        for name, caps in (("egress_caps", self.egress_caps),
                           ("qps_caps", self.qps_caps)):
            if caps is not None and len(caps) != self.shards:
                raise ValueError(
                    f"{name} must have one entry per shard "
                    f"({len(caps)} != {self.shards})"
                )

    # -- node ids -------------------------------------------------------
    def shard_id(self, i: int) -> str:
        """Concrete node id of shard ``i`` (the sentinel when 1-sharded)."""
        if not 0 <= i < self.shards:
            raise IndexError(f"shard {i} out of range (shards={self.shards})")
        if self.shards == 1:
            return REGISTRY  # bit-compatible with the pre-sharding engine
        return f"{_SHARD_PREFIX}{i}{_SHARD_SUFFIX}"

    def shard_ids(self) -> list[str]:
        return [self.shard_id(i) for i in range(self.shards)]

    def canonical(self, node: str) -> str:
        """Map any registry alias (the legacy sentinel) to its shard id.

        Raises ``ValueError`` for a shard id this registry does not have —
        a plan built against a bigger registry than the engine's spec is a
        config bug that must not silently clamp to one shard's capacity.
        """
        i = shard_index(node)
        if i >= self.shards:
            raise ValueError(
                f"{node!r} does not exist in a {self.shards}-shard registry"
            )
        return self.shard_id(i)

    # -- per-shard capacities ------------------------------------------
    def egress_of(self, i: int) -> float:
        return self.egress_caps[i] if self.egress_caps is not None else self.egress_cap

    def qps_of(self, i: int) -> float:
        return self.qps_caps[i] if self.qps_caps is not None else self.qps

    def aggregate_egress_cap(self) -> float:
        return sum(self.egress_of(i) for i in range(self.shards))

    # -- legacy two-knob configs ----------------------------------------
    @classmethod
    def resolve(
        cls, spec: "RegistrySpec | None", *, egress_cap: float, qps: float
    ) -> "RegistrySpec":
        """``spec`` if given, else a 1-shard spec from the legacy caps.

        The one place the "None means the pre-sharding single registry"
        compat rule lives; every config's ``registry_spec()`` delegates here.
        """
        if spec is not None:
            return spec
        return cls(shards=1, egress_cap=egress_cap, qps=qps)

    # -- wire format (scheduler snapshots) ------------------------------
    def to_json(self) -> dict:
        out: dict = {
            "shards": self.shards,
            "egress_cap": self.egress_cap,
            "qps": self.qps if math.isfinite(self.qps) else None,
            "policy": self.policy,
        }
        if self.egress_caps is not None:
            out["egress_caps"] = list(self.egress_caps)
        if self.qps_caps is not None:
            out["qps_caps"] = [
                q if math.isfinite(q) else None for q in self.qps_caps
            ]
        return out

    @classmethod
    def from_json(cls, blob: dict) -> "RegistrySpec":
        qps = blob.get("qps")
        qps_caps = blob.get("qps_caps")
        return cls(
            shards=int(blob["shards"]),
            egress_cap=float(blob["egress_cap"]),
            qps=float("inf") if qps is None else float(qps),
            policy=blob.get("policy", "hash_by_function"),
            egress_caps=(
                tuple(float(c) for c in blob["egress_caps"])
                if blob.get("egress_caps") is not None
                else None
            ),
            qps_caps=(
                tuple(float("inf") if q is None else float(q) for q in qps_caps)
                if qps_caps is not None
                else None
            ),
        )


class ShardResolver:
    """Stateful shard assignment: plan builders ask it where blobs live.

    The resolver is control-plane state: the multi-tenant replay carries it
    across scheduler failovers via :meth:`snapshot` / :meth:`restore` so a
    restored scheduler keeps assigning shards exactly where the failed one
    would have (``least_loaded`` loads and the ``replicated`` round-robin
    cursor are both part of the wire snapshot).
    """

    def __init__(self, spec: RegistrySpec | None = None) -> None:
        self.spec = spec or RegistrySpec()
        self.loads: list[float] = [0.0] * self.spec.shards  # bytes assigned
        self._rr = 0  # round-robin cursor for the replicated policy

    # ------------------------------------------------------------------
    def shard_for(self, piece: str) -> int:
        """Shard index for one assignment (advances stateful policies)."""
        spec = self.spec
        if spec.policy == "hash_by_function":
            return zlib.crc32(piece.encode("utf-8")) % spec.shards
        if spec.policy == "least_loaded":
            return min(range(spec.shards), key=lambda i: (self.loads[i], i))
        i = self._rr % spec.shards  # replicated: round-robin over replicas
        self._rr += 1
        return i

    def source_for(self, piece: str, *, nbytes: int = 0) -> str:
        """Node id to fetch ``piece`` from; accounts ``nbytes`` to the shard."""
        i = self.shard_for(piece)
        self.loads[i] += nbytes
        return self.spec.shard_id(i)

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "spec": self.spec.to_json(),
            "loads": list(self.loads),
            "rr": self._rr,
        }

    @classmethod
    def restore(cls, blob: dict) -> "ShardResolver":
        r = cls(RegistrySpec.from_json(blob["spec"]))
        loads = [float(x) for x in blob.get("loads", [])]
        if len(loads) == r.spec.shards:
            r.loads = loads
        r._rr = int(blob.get("rr", 0))
        return r


def as_resolver(
    registry: "RegistrySpec | ShardResolver | None",
) -> ShardResolver:
    """Coerce a plan builder's ``registry`` argument to a resolver.

    ``None`` means the legacy single-shard registry; a spec gets a fresh
    resolver (fine for one-shot plans); an existing resolver is shared so
    stateful policies see every assignment across plans.
    """
    if registry is None:
        return ShardResolver()
    if isinstance(registry, RegistrySpec):
        return ShardResolver(registry)
    return registry
