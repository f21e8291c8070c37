"""Batched serving with the block-checkpoint cold start."""
from .engine import FIRST_LEAF_PRED, Request, ServeEngine

__all__ = ["FIRST_LEAF_PRED", "Request", "ServeEngine"]
