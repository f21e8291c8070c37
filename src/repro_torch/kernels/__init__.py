"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version."""
from . import cap_chain, flash_attention
from .cap_chain import (
    cap_chain_rates,
    cap_chain_rates_torch,
    nic_flow_counts,
    nic_flow_counts_torch,
)
from .flash_attention import flash_attention_bhtd, flash_attention_torch


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    cap_chain.reset_launches()
    flash_attention.reset_launches()


__all__ = [
    "cap_chain_rates",
    "cap_chain_rates_torch",
    "flash_attention_bhtd",
    "flash_attention_torch",
    "nic_flow_counts",
    "nic_flow_counts_torch",
    "reset_launches",
]
