"""PyTorch + CUDA port of the FaaSNet reproduction.

``repro_torch.core`` is the FT control plane, ``repro_torch.sim`` the flow
engines and the provisioning harnesses (``run_scale``, ``provision_wave``),
and ``repro_torch.kernels`` the hand-written CUDA kernels the vector engine
launches on its wide recompute fronts.  Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU.
"""
from . import core, kernels, sim

__all__ = ["core", "kernels", "sim"]
