"""FaaSNet core: function trees, FT manager, block store, topologies, protocol."""
from .blockstore import DEFAULT_BLOCK_SIZE, BlockManifest
from .ft_manager import FTManager, VMInfo
from .function_tree import FTNode, FunctionTree
from .image import (
    BlockCache,
    ImageSpec,
    LayerSpec,
    disjoint_images,
    shared_base_images,
)
from .provisioning import ProvisionState, ProvisionTask, RPCCosts
from .reclaim import (
    RECLAIM_POLICIES,
    FixedTTLReclaim,
    HistogramReclaim,
    ReclaimPolicy,
    resolve_reclaim_policy,
)
from .registry import (
    PLACEMENT_POLICIES,
    RegistrySpec,
    ShardResolver,
    is_registry_node,
    shard_index,
)
from .topology import (
    REGISTRY,
    DistributionPlan,
    Flow,
    baseline_block_plan,
    baseline_plan,
    dadi_plan,
    faasnet_block_plan,
    faasnet_plan,
    kraken_plan,
    on_demand_block_plan,
    on_demand_plan,
)

__all__ = [
    "DEFAULT_BLOCK_SIZE",
    "BlockManifest",
    "FTManager",
    "VMInfo",
    "FTNode",
    "FunctionTree",
    "ProvisionState",
    "ProvisionTask",
    "RPCCosts",
    "RECLAIM_POLICIES",
    "ReclaimPolicy",
    "FixedTTLReclaim",
    "HistogramReclaim",
    "resolve_reclaim_policy",
    "REGISTRY",
    "PLACEMENT_POLICIES",
    "RegistrySpec",
    "ShardResolver",
    "is_registry_node",
    "shard_index",
    "DistributionPlan",
    "Flow",
    "baseline_plan",
    "baseline_block_plan",
    "dadi_plan",
    "faasnet_plan",
    "faasnet_block_plan",
    "kraken_plan",
    "on_demand_plan",
    "on_demand_block_plan",
    "BlockCache",
    "ImageSpec",
    "LayerSpec",
    "disjoint_images",
    "shared_base_images",
]
