"""Fault tolerance: heartbeats, straggler detection, restart policy.

Host-plane machinery mirroring the paper's §3.3 "FT Fault Tolerance": the
scheduler pings VMs (here: training hosts) and repairs trees on misses.
Device-plane recovery is checkpoint/restart (``CheckpointManager``) plus
re-replication of weights via ``broadcast.tree_broadcast`` (the JAX
package's; the port has no ``broadcast`` module yet).
``tests/test_torch_elastic_fault.py`` holds detections, restarts and
demotions equal to the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core.ft_manager import FTManager


@dataclass
class HeartbeatMonitor:
    """Detects dead hosts from missed heartbeats (paper: scheduler pings)."""

    timeout_s: float = 10.0
    last_seen: dict[str, float] = field(default_factory=dict)

    def beat(self, host: str, now: float) -> None:
        self.last_seen[host] = now

    def dead_hosts(self, now: float) -> list[str]:
        return [h for h, t in self.last_seen.items() if now - t > self.timeout_s]


@dataclass
class StragglerDetector:
    """EWMA step-time tracking; flags hosts persistently slower than the fleet.

    The mitigation mirrors FaaSNet's adaptivity: a flagged interior FT node
    is demoted to a leaf (delete + re-insert), so it stops throttling its
    subtree's inbound streams.
    """

    alpha: float = 0.2
    threshold: float = 1.5  # x fleet median
    ewma: dict[str, float] = field(default_factory=dict)

    def record(self, host: str, step_time_s: float) -> None:
        prev = self.ewma.get(host, step_time_s)
        self.ewma[host] = (1 - self.alpha) * prev + self.alpha * step_time_s

    def stragglers(self) -> list[str]:
        if len(self.ewma) < 2:
            return []
        vals = sorted(self.ewma.values())
        median = vals[len(vals) // 2]
        return [h for h, v in self.ewma.items() if v > self.threshold * median]


class FaultCoordinator:
    """Glues heartbeats + FT repair + checkpoint restart decisions."""

    def __init__(
        self,
        mgr: FTManager,
        monitor: Optional[HeartbeatMonitor] = None,
        detector: Optional[StragglerDetector] = None,
        on_restart: Optional[Callable[[list[str]], None]] = None,
    ) -> None:
        self.mgr = mgr
        self.monitor = monitor or HeartbeatMonitor()
        self.detector = detector or StragglerDetector()
        self.on_restart = on_restart
        self.events: list[tuple[float, str, str]] = []

    def tick(self, now: float) -> dict:
        """Run detection; repair trees; return actions taken."""
        dead = [
            h for h in self.monitor.dead_hosts(now)
            if h in self.mgr.vms and self.mgr.vms[h].alive
        ]
        repaired: list[str] = []
        for h in dead:
            repaired += self.mgr.on_vm_failure(h)
            self.events.append((now, "failure", h))
        slow = self.detector.stragglers()
        demoted = []
        for h in slow:
            vm = self.mgr.vms.get(h)
            if vm is None or not vm.alive:
                continue
            for fid in list(vm.functions):
                ft = self.mgr.trees.get(fid)
                if ft is not None and h in ft and ft.children_of(h):
                    self.mgr.delete(fid, h)
                    self.mgr.insert(fid, h, now)  # re-attach at frontier => leaf
                    demoted.append((fid, h))
                    self.events.append((now, "demote", h))
        if dead and self.on_restart is not None:
            self.on_restart(dead)
        return {"dead": dead, "repaired_functions": repaired, "demoted": demoted}
