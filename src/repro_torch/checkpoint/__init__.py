"""Checkpoints in the FaaSNet block format, interchangeable with the JAX package's."""
from .manager import CheckpointManager, LeafMeta

__all__ = ["CheckpointManager", "LeafMeta"]
