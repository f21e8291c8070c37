"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version."""
from . import cap_chain, decode_attention, flash_attention, moe_route, ssd_scan
from .cap_chain import (
    cap_chain_rates,
    cap_chain_rates_torch,
    nic_flow_counts,
    nic_flow_counts_torch,
)
from .decode_attention import decode_attention_bhsd, decode_attention_torch
from .flash_attention import flash_attention_bhtd, flash_attention_torch
from .moe_route import expert_slots, expert_slots_torch
from .ssd_scan import ssd_scan_bhtpn, ssd_scan_torch


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    cap_chain.reset_launches()
    flash_attention.reset_launches()
    decode_attention.reset_launches()
    moe_route.reset_launches()
    ssd_scan.reset_launches()


__all__ = [
    "cap_chain_rates",
    "cap_chain_rates_torch",
    "decode_attention_bhsd",
    "decode_attention_torch",
    "expert_slots",
    "expert_slots_torch",
    "flash_attention_bhtd",
    "flash_attention_torch",
    "nic_flow_counts",
    "nic_flow_counts_torch",
    "reset_launches",
    "ssd_scan_bhtpn",
    "ssd_scan_torch",
]
