"""Discrete-event simulation of FaaSNet provisioning and the paper's baselines."""
from repro_torch.core.reclaim import (
    RECLAIM_POLICIES,
    FixedTTLReclaim,
    HistogramReclaim,
    ReclaimPolicy,
)
from repro_torch.core.registry import RegistrySpec, ShardResolver

from .cluster import (
    BLOCK_SYSTEMS,
    SYSTEMS,
    WaveConfig,
    block_wave,
    provision_wave,
    scalability_table,
    startup_timeline,
)
from .engine import ENGINES, GBPS, FlowSim, NICConfig, SimConfig, make_sim
from .scale import (
    ScaleConfig,
    ScaleResult,
    giga_burst_config,
    mega_burst_config,
    run_scale,
)
from .vector_engine import VectorFlowSim, VectorTorchFlowSim

__all__ = [
    "RECLAIM_POLICIES",
    "ReclaimPolicy",
    "FixedTTLReclaim",
    "HistogramReclaim",
    "RegistrySpec",
    "ShardResolver",
    "SYSTEMS",
    "BLOCK_SYSTEMS",
    "WaveConfig",
    "block_wave",
    "provision_wave",
    "scalability_table",
    "startup_timeline",
    "GBPS",
    "ENGINES",
    "FlowSim",
    "VectorFlowSim",
    "VectorTorchFlowSim",
    "NICConfig",
    "SimConfig",
    "make_sim",
    "ScaleConfig",
    "ScaleResult",
    "giga_burst_config",
    "mega_burst_config",
    "run_scale",
]
