"""Elastic scaling: host join/leave with FT-managed weight provisioning.

A joining host is FaaSNet's "reserved VM": the coordinator inserts it into
the model's function tree, it streams checkpoint blocks from its upstream
peer (never the central store, as long as ≥1 warm host exists — paper
§3.4), and once enough blocks arrive it becomes schedulable.  Leaving /
failed hosts trigger tree repair.  The coordinator also proposes mesh
reshapes when the data-parallel width changes.

Joins are timed on the incremental :class:`FlowSim` (host-side, no device).
``tests/test_torch_elastic_fault.py`` holds join latencies, repaired trees
and mesh proposals equal to the JAX package's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.ft_manager import FTManager, VMInfo
from repro_torch.sim.engine import FlowSim, SimConfig


@dataclass
class JoinResult:
    host: str
    upstream: Optional[str]  # None => fetched from the central store
    provision_latency_s: float
    tree_height: int


@dataclass
class ElasticConfig:
    model_id: str = "model"
    payload_bytes: int = 2 * 10**9  # checkpoint size streamed to joiners
    startup_fraction: float = 1.0  # training needs all weights
    per_stream_cap: float = 30e6
    hop_latency: float = 0.05
    store_cap: float = 5e9  # central checkpoint store egress


class ElasticCoordinator:
    """Tracks membership; times provisioning with the flow simulator."""

    def __init__(self, cfg: ElasticConfig | None = None) -> None:
        self.cfg = cfg or ElasticConfig()
        self.mgr = FTManager()
        self._counter = 0
        self.history: list[JoinResult] = []

    @property
    def hosts(self) -> list[str]:
        ft = self.mgr.trees.get(self.cfg.model_id)
        return ft.vm_ids() if ft is not None else []

    # ------------------------------------------------------------------
    def join(self, host: str | None = None, now: float = 0.0) -> JoinResult:
        cfg = self.cfg
        if host is None:
            host = f"host{self._counter}"
            self._counter += 1
        if host not in self.mgr.vms:
            self.mgr.add_free_vm(VMInfo(host))
            self.mgr.reserve_vm(now)
        upstream = self.mgr.insert(cfg.model_id, host, now)
        # time the stream from upstream (or store) with the flow model
        sim = FlowSim(SimConfig(per_stream_cap=cfg.per_stream_cap,
                                registry_out_cap=cfg.store_cap,
                                hop_latency=cfg.hop_latency))
        from repro_torch.core.topology import REGISTRY, DistributionPlan, Flow

        src = upstream if upstream is not None else REGISTRY
        payload = int(cfg.payload_bytes * cfg.startup_fraction)
        done = {}
        sim.add_plan(
            DistributionPlan(flows=[Flow(src, host, "ckpt", payload)],
                             streaming=True),
            on_node_done=lambda vm, t: done.setdefault(vm, t),
        )
        sim.run()
        ft = self.mgr.trees[cfg.model_id]
        res = JoinResult(host, upstream, done.get(host, 0.0), ft.height)
        self.history.append(res)
        return res

    def leave(self, host: str) -> None:
        self.mgr.delete(self.cfg.model_id, host)
        vm = self.mgr.vms[host]
        vm.functions.discard(self.cfg.model_id)
        self.mgr.release_vm(host)

    def fail(self, host: str) -> list[str]:
        return self.mgr.on_vm_failure(host)

    # ------------------------------------------------------------------
    def propose_mesh(self, model_parallel: int = 16) -> tuple[int, int]:
        """(data, model) mesh shape for the current host count.

        Elastic DP: the data axis is the largest power of two ≤ #hosts;
        spare hosts stay warm in the FT as provisioning seeds.
        """
        n = len(self.hosts)
        if n == 0:
            return (0, model_parallel)
        dp = 2 ** int(math.log2(max(n, 1)))
        return (dp, model_parallel)
