"""PyTorch + CUDA port of the FaaSNet reproduction.

``repro_torch.core`` is the FT control plane and the block store,
``repro_torch.sim`` the flow engines and the provisioning harnesses
(``run_scale``, ``provision_wave``), ``repro_torch.kernels`` the
hand-written CUDA kernels (the cap chain of the vector engine's recompute
fronts, the flash attention of the models' prefill), ``repro_torch.configs``
and ``repro_torch.models`` the model zoo's attention + MLP families,
``repro_torch.checkpoint`` the block-format checkpoints, and
``repro_torch.serving`` the batching server with its block-checkpoint cold
start.  Entry points run on the card (``device="cuda"``) unless the caller
asks for the CPU.
"""
from . import checkpoint, configs, core, kernels, models, serving, sim

__all__ = ["checkpoint", "configs", "core", "kernels", "models", "serving", "sim"]
