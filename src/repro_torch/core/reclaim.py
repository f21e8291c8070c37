"""Pluggable VM/instance reclaim policies (paper §3.2 + ROADMAP follow-on).

The paper reclaims a VM after a fixed idle lifespan (15 min in Alibaba's
production config).  Trace-driven serverless work since then — Tomaras et
al., 2024 ("Prediction-driven resource provisioning for serverless container
runtimes"), and the keep-alive histograms of Shahrad et al. ("Serverless in
the Wild") — shows that a per-function *predicted* keep-alive reclaims dead
tenants quickly while keeping bursty ones warm.  This module makes the
policy pluggable so the multi-tenant harness can compare both on one trace
mix:

  * :class:`FixedTTLReclaim` — the paper's fixed idle lifespan (default);
  * :class:`HistogramReclaim` — a per-function idle-gap histogram whose
    keep-alive is a high quantile of the observed gaps (clamped to
    ``[min_ttl_s, max_ttl_s]``, falling back to the fixed TTL until enough
    gaps have been seen).

Policies are evaluated **per function-instance** (a ``(function, vm)``
pair), not per VM — on a shared pool one VM hosts many tenants' instances
and each ages independently.  All policy state is deterministic and
JSON-serializable: it rides the scheduler-failover snapshot
(:meth:`repro_torch.core.ft_manager.FTManager.snapshot`) so a restored scheduler
makes bit-identical reclaim decisions.
"""
from __future__ import annotations

__all__ = [
    "RECLAIM_POLICIES",
    "ReclaimPolicy",
    "FixedTTLReclaim",
    "HistogramReclaim",
    "resolve_reclaim_policy",
    "restore_reclaim_policy",
]

# Config-level shorthand names accepted by resolve_reclaim_policy (the
# authoritative list for CLI ``choices=`` — mirrors registry's
# PLACEMENT_POLICIES and sim's PLACEMENTS).
RECLAIM_POLICIES = ("fixed", "histogram")


class ReclaimPolicy:
    """Decides when an idle function instance should be reclaimed.

    Subclasses are auto-registered by their ``name`` so snapshots restore
    polymorphically; a custom policy must override :meth:`from_snapshot`
    (and :meth:`snapshot`) to survive a scheduler failover — the base
    implementation raises with that instruction rather than silently
    degrading to a built-in policy.
    """

    name = "base"
    _registry: dict[str, type["ReclaimPolicy"]] = {}

    def __init_subclass__(cls, **kwargs) -> None:
        super().__init_subclass__(**kwargs)
        name = cls.__dict__.get("name")
        if name:
            ReclaimPolicy._registry[name] = cls

    def should_reclaim(self, function_id: str, idle_s: float, now: float) -> bool:
        raise NotImplementedError

    def observe_gap(self, function_id: str, gap_s: float) -> None:
        """An instance of ``function_id`` was reused after ``gap_s`` idle.

        Predictive policies learn from this; the fixed policy ignores it.
        """

    # -- failover ------------------------------------------------------
    def snapshot(self) -> dict:
        return {"policy": self.name}

    @classmethod
    def from_snapshot(cls, blob: dict, *, default_ttl_s: float) -> "ReclaimPolicy":
        raise ValueError(
            f"reclaim policy {cls.name!r} does not implement from_snapshot; "
            f"custom policies must override snapshot()/from_snapshot() to "
            f"survive scheduler failover"
        )


class FixedTTLReclaim(ReclaimPolicy):
    """The paper's fixed idle lifespan: reclaim after ``ttl_s`` idle."""

    name = "fixed_ttl"

    def __init__(self, ttl_s: float = 15 * 60.0) -> None:
        self.ttl_s = float(ttl_s)

    def should_reclaim(self, function_id: str, idle_s: float, now: float) -> bool:
        return idle_s >= self.ttl_s

    def snapshot(self) -> dict:
        return {"policy": self.name, "ttl_s": self.ttl_s}

    @classmethod
    def from_snapshot(cls, blob: dict, *, default_ttl_s: float) -> "FixedTTLReclaim":
        return cls(blob.get("ttl_s", default_ttl_s))


class HistogramReclaim(ReclaimPolicy):
    """Keep-alive from a per-function idle-gap histogram.

    Gaps (idle time before an instance is reused) are bucketed at
    ``bucket_s`` resolution up to ``max_ttl_s``.  Once ``min_observations``
    gaps have been seen for a function, its keep-alive becomes the
    ``quantile`` of the histogram plus one safety bucket, clamped to
    ``[min_ttl_s, max_ttl_s]``; before that the policy behaves like the
    fixed ``default_ttl_s`` lifespan.  Functions whose instances are never
    reused (dead tenants) therefore learn nothing and fall back to the
    default — exactly the paper's behaviour — while bursty tenants with
    short observed gaps get reclaimed within a couple of buckets of their
    real reuse pattern.
    """

    name = "histogram"

    def __init__(
        self,
        default_ttl_s: float = 15 * 60.0,
        *,
        bucket_s: float = 15.0,
        min_ttl_s: float = 60.0,
        max_ttl_s: float | None = None,
        quantile: float = 0.99,
        min_observations: int = 12,
    ) -> None:
        if bucket_s <= 0:
            raise ValueError("bucket_s must be positive")
        if not 0.0 < quantile <= 1.0:
            raise ValueError("quantile must be in (0, 1]")
        self.default_ttl_s = float(default_ttl_s)
        self.bucket_s = float(bucket_s)
        self.min_ttl_s = float(min_ttl_s)
        self.max_ttl_s = float(max_ttl_s if max_ttl_s is not None else default_ttl_s)
        self.quantile = float(quantile)
        self.min_observations = int(min_observations)
        self.n_buckets = max(1, int(self.max_ttl_s / self.bucket_s)) + 1
        self.counts: dict[str, list[int]] = {}  # function_id -> bucket counts
        self.totals: dict[str, int] = {}  # function_id -> Σ counts (cached)
        # Learned-TTL memo: should_reclaim runs once per idle instance per
        # tick, but the quantile only moves on observe_gap — derived state,
        # never snapshotted.
        self._ttl_cache: dict[str, float] = {}

    def observe_gap(self, function_id: str, gap_s: float) -> None:
        if gap_s < 0:
            return
        b = min(int(gap_s / self.bucket_s), self.n_buckets - 1)
        hist = self.counts.get(function_id)
        if hist is None:
            hist = self.counts[function_id] = [0] * self.n_buckets
        hist[b] += 1
        self.totals[function_id] = self.totals.get(function_id, 0) + 1
        self._ttl_cache.pop(function_id, None)

    def keep_alive_s(self, function_id: str) -> float:
        """The learned keep-alive for one function (default until warmed up)."""
        cached = self._ttl_cache.get(function_id)
        if cached is not None:
            return cached
        total = self.totals.get(function_id, 0)
        if total < self.min_observations:
            ttl = self.default_ttl_s
        else:
            hist = self.counts[function_id]
            want = self.quantile * total
            acc = 0
            ttl = self.max_ttl_s
            for b, n in enumerate(hist):
                acc += n
                if acc >= want:
                    # one safety bucket past the quantile bucket's upper edge
                    ttl = min(self.max_ttl_s, max(self.min_ttl_s, (b + 2) * self.bucket_s))
                    break
        self._ttl_cache[function_id] = ttl
        return ttl

    def should_reclaim(self, function_id: str, idle_s: float, now: float) -> bool:
        return idle_s >= self.keep_alive_s(function_id)

    def snapshot(self) -> dict:
        return {
            "policy": self.name,
            "default_ttl_s": self.default_ttl_s,
            "bucket_s": self.bucket_s,
            "min_ttl_s": self.min_ttl_s,
            "max_ttl_s": self.max_ttl_s,
            "quantile": self.quantile,
            "min_observations": self.min_observations,
            "counts": {fid: list(h) for fid, h in sorted(self.counts.items())},
        }

    @classmethod
    def from_snapshot(cls, blob: dict, *, default_ttl_s: float) -> "HistogramReclaim":
        pol = cls(
            blob.get("default_ttl_s", default_ttl_s),
            bucket_s=blob.get("bucket_s", 15.0),
            min_ttl_s=blob.get("min_ttl_s", 60.0),
            max_ttl_s=blob.get("max_ttl_s"),
            quantile=blob.get("quantile", 0.99),
            min_observations=blob.get("min_observations", 12),
        )
        for fid, hist in blob.get("counts", {}).items():
            h = [int(n) for n in hist]
            # snapshots from a config with a different bucket count restore
            # by truncation/padding into the last (overflow) bucket
            if len(h) > pol.n_buckets:
                h = h[: pol.n_buckets - 1] + [sum(h[pol.n_buckets - 1 :])]
            elif len(h) < pol.n_buckets:
                h = h + [0] * (pol.n_buckets - len(h))
            pol.counts[fid] = h
            pol.totals[fid] = sum(h)
        return pol


def resolve_reclaim_policy(
    policy: "str | ReclaimPolicy | None", *, default_ttl_s: float
) -> ReclaimPolicy:
    """Config-level shorthand: ``"fixed"`` / ``"histogram"`` / an instance."""
    if policy is None or policy == "fixed" or policy == FixedTTLReclaim.name:
        return FixedTTLReclaim(default_ttl_s)
    if policy == HistogramReclaim.name:
        return HistogramReclaim(default_ttl_s)
    if isinstance(policy, ReclaimPolicy):
        return policy
    raise ValueError(
        f"unknown reclaim policy {policy!r}; one of {RECLAIM_POLICIES} "
        f"or a ReclaimPolicy instance"
    )


def restore_reclaim_policy(blob: "dict | None", *, default_ttl_s: float) -> ReclaimPolicy:
    """Rebuild a policy from :meth:`ReclaimPolicy.snapshot` output.

    Dispatches through the subclass registry keyed by ``policy`` name, so
    custom :class:`ReclaimPolicy` subclasses restore polymorphically (they
    must implement :meth:`ReclaimPolicy.from_snapshot`).  ``None`` (legacy
    snapshots that predate pluggable reclaim) restores the fixed policy
    built from the caller's TTL — the pre-refactor behaviour.
    """
    if blob is None:
        return FixedTTLReclaim(default_ttl_s)
    kind = blob.get("policy", FixedTTLReclaim.name)
    cls = ReclaimPolicy._registry.get(kind)
    if cls is None:
        raise ValueError(f"unknown reclaim policy in snapshot: {kind!r}")
    return cls.from_snapshot(blob, default_ttl_s=default_ttl_s)
