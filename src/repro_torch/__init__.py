"""PyTorch + CUDA port of the FaaSNet reproduction.

``repro_torch.core`` is the FT control plane and the block store,
``repro_torch.sim`` the flow engines and the provisioning harnesses
(``run_scale``, ``provision_wave``), ``repro_torch.kernels`` the
hand-written CUDA kernels (the cap chain of the vector engine's recompute
fronts, the flash attention of the models' prefill), ``repro_torch.configs``
and ``repro_torch.models`` the model zoo's attention + MLP families,
``repro_torch.checkpoint`` the block-format checkpoints, and
``repro_torch.serving`` the batching server with its block-checkpoint cold
start, and ``repro_torch.data``, ``repro_torch.optim`` and
``repro_torch.train`` the training path (synthetic batches, AdamW, the
microbatched train step, the train loop with block-checkpoint restart).
Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU.
"""
from . import checkpoint, configs, core, data, kernels, models, optim, serving, sim, train

__all__ = ["checkpoint", "configs", "core", "data", "kernels", "models", "optim", "serving",
           "sim", "train"]
