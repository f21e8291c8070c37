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
from .multi_tenant import (
    PLACEMENTS,
    MultiTenantConfig,
    MultiTenantReplay,
    MultiTenantResult,
    ServingConfig,
    TenantConfig,
    TenantResult,
    run_multi_tenant,
)
from .reference import ReferenceFlowSim
from .scale import (
    ScaleConfig,
    ScaleResult,
    giga_burst_config,
    mega_burst_config,
    multi_tenant_config,
    run_scale,
    serving_config,
)
from .vector_engine import VectorFlowSim, VectorTorchFlowSim
from .traces import (
    constant_trace,
    diurnal_trace,
    iot_trace,
    synthetic_gaming_trace,
)
from .workload import ReplayConfig, TickStats, TraceReplay

__all__ = [
    "RECLAIM_POLICIES",
    "ReclaimPolicy",
    "FixedTTLReclaim",
    "HistogramReclaim",
    "RegistrySpec",
    "ShardResolver",
    "SYSTEMS",
    "BLOCK_SYSTEMS",
    "PLACEMENTS",
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
    "MultiTenantConfig",
    "MultiTenantReplay",
    "MultiTenantResult",
    "ServingConfig",
    "TenantConfig",
    "TenantResult",
    "run_multi_tenant",
    "ReferenceFlowSim",
    "ScaleConfig",
    "ScaleResult",
    "giga_burst_config",
    "mega_burst_config",
    "multi_tenant_config",
    "run_scale",
    "serving_config",
    "constant_trace",
    "diurnal_trace",
    "iot_trace",
    "synthetic_gaming_trace",
    "ReplayConfig",
    "TickStats",
    "TraceReplay",
]
