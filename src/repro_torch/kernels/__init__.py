"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version."""
from .cap_chain import (
    cap_chain_rates,
    cap_chain_rates_torch,
    nic_flow_counts,
    nic_flow_counts_torch,
    reset_launches,
)

__all__ = [
    "cap_chain_rates",
    "cap_chain_rates_torch",
    "nic_flow_counts",
    "nic_flow_counts_torch",
    "reset_launches",
]
