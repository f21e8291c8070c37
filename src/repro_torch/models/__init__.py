"""The port's models: decoder-only attention + MLP LMs, params as tensor trees."""
from .lm import Model, model_for
from .params import params_from_numpy, params_to_numpy

__all__ = ["Model", "model_for", "params_from_numpy", "params_to_numpy"]
