"""Container/weight provisioning protocol (paper §3.3, Figure 9).

The seven-step scheduler ↔ worker RPC exchange, encoded as an explicit state
machine so both the simulator and the tests can drive it and assert on legal
transitions.  The protocol is payload-agnostic: "container" below can be a
function container image, a code package, or (in the TPU mapping) a
checkpoint shard.

  Step 1  scheduler: insert VM into the function's FT; look up upstream peer
  Step 2  scheduler → VM: function metadata + upstream address
          VM: download .tar manifest from metadata store; persist layer URLs
  Step 3  VM → scheduler: ready-to-create
  Step 4  scheduler → VM: create container RPC
  Step 5  VM → upstream: fetch blocks (streamed; on-demand subset)
  Step 6  upstream → VM: block data (pipelined downstream as received)
  Step 7  VM → scheduler: container created
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional


class ProvisionState(enum.Enum):
    INIT = "init"  # not yet in a tree
    INSERTED = "inserted"  # step 1 done; knows upstream
    MANIFEST_READY = "manifest_ready"  # step 2 done; layer URLs persisted
    READY_TO_CREATE = "ready_to_create"  # step 3 sent
    CREATING = "creating"  # step 4 received; steps 5/6 in flight
    CREATED = "created"  # step 7 sent
    FAILED = "failed"


_LEGAL = {
    ProvisionState.INIT: {ProvisionState.INSERTED, ProvisionState.FAILED},
    ProvisionState.INSERTED: {ProvisionState.MANIFEST_READY, ProvisionState.FAILED},
    ProvisionState.MANIFEST_READY: {
        ProvisionState.READY_TO_CREATE,
        ProvisionState.FAILED,
    },
    ProvisionState.READY_TO_CREATE: {ProvisionState.CREATING, ProvisionState.FAILED},
    ProvisionState.CREATING: {ProvisionState.CREATED, ProvisionState.FAILED},
    ProvisionState.CREATED: set(),
    ProvisionState.FAILED: {ProvisionState.INSERTED},  # retry after tree repair
}


@dataclass
class RPCCosts:
    """Control-plane latency model (seconds). Data-plane time comes from sim."""

    scheduler_rpc: float = 0.001  # one scheduler<->worker round trip
    manifest_fetch: float = 0.010  # metadata-store .tar manifest download
    image_load: float = 0.050  # local `image load` of the manifest
    container_start: float = 0.500  # runc start once enough blocks arrived

    def control_plane_total(self) -> float:
        # steps 1-4 + 7: three scheduler RPCs + manifest fetch + image load
        return 3 * self.scheduler_rpc + self.manifest_fetch + self.image_load


@dataclass
class ProvisionTask:
    """Lifecycle of provisioning one function instance onto one VM."""

    function_id: str
    vm_id: str
    state: ProvisionState = ProvisionState.INIT
    upstream: Optional[str] = None  # None => fetch from registry
    history: list[tuple[ProvisionState, float]] = field(default_factory=list)
    t_started: float = 0.0
    t_created: float = 0.0

    def transition(self, new: ProvisionState, now: float) -> None:
        if new not in _LEGAL[self.state]:
            raise ValueError(
                f"illegal transition {self.state.value} -> {new.value} "
                f"for {self.function_id}@{self.vm_id}"
            )
        self.state = new
        self.history.append((new, now))
        if new is ProvisionState.CREATED:
            self.t_created = now

    # convenience drivers -------------------------------------------------
    def step1_insert(self, upstream: Optional[str], now: float) -> None:
        self.t_started = now
        self.upstream = upstream
        self.transition(ProvisionState.INSERTED, now)

    def step2_manifest(self, now: float) -> None:
        self.transition(ProvisionState.MANIFEST_READY, now)

    def step3_ready(self, now: float) -> None:
        self.transition(ProvisionState.READY_TO_CREATE, now)

    def step4_create(self, now: float) -> None:
        self.transition(ProvisionState.CREATING, now)

    def step7_created(self, now: float) -> None:
        self.transition(ProvisionState.CREATED, now)

    def fail(self, now: float) -> None:
        self.transition(ProvisionState.FAILED, now)

    def retry_with(self, upstream: Optional[str], now: float) -> None:
        """After FT repair: re-enter with a new upstream (step 1 again)."""
        self.upstream = upstream
        self.transition(ProvisionState.INSERTED, now)

    def provisioning_latency(self) -> float:
        assert self.state is ProvisionState.CREATED
        return self.t_created - self.t_started
