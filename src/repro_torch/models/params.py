"""The weights carrier: nested dict/list/tuple trees of tensors.

The port keeps the JAX package's parameter layout: a tree of dicts (keys
sorted when flattened), lists and tuples whose leaves are tensors, with the
stacked (repeat, ...) leaves of a periodic stage.  So a tree of numpy arrays
taken from the JAX package (``jax.tree.map(np.asarray, params)``) becomes
the port's params leaf for leaf, and checkpoints written by either package
restore in the other.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

PyTree = Any


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Apply ``fn`` to the leaves of ``tree`` (and the matching leaves of ``rest``);
    ``None`` is an empty subtree, as in ``jax.tree.map``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, x, *(r[i] for r in rest)) for i, x in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_leaves_with_path(tree: PyTree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs in the JAX flattening order: dict keys sorted,
    sequences in index order; ``None`` is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves_with_path(tree[k], (*prefix, k))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, x in enumerate(tree):
            out += tree_leaves_with_path(x, (*prefix, i))
        return out
    return [(prefix, tree)]


def tree_unflatten(like: PyTree, leaves: list) -> PyTree:
    """A tree shaped like ``like`` whose leaves, in the order of
    :func:`tree_leaves_with_path`, are ``leaves``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            filled = {k: build(node[k]) for k in sorted(node)}
            return {k: filled[k] for k in node}
        if isinstance(node, (list, tuple)):
            seq = [build(x) for x in node]
            return seq if isinstance(node, list) else tuple(seq)
        return next(it)

    return build(like)


class MetaGenerator(torch.Generator):
    """A generator whose ``device`` is ``meta``, so ``model.init(MetaGenerator())``
    gives the params tree as ``device="meta"`` tensors: every shape and
    dtype, no storage and no draws (the JAX package's
    ``jax.eval_shape(model.init, key)``), at any width."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def tensor_from_numpy(arr, device) -> torch.Tensor:
    """One numpy array (bfloat16 as ``ml_dtypes`` gives it, too) as a tensor."""
    arr = np.array(arr, order="C")  # a copy; unlike ascontiguousarray it keeps 0-d leaves 0-d
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy has no bfloat16; ml_dtypes is what JAX hands out

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree: PyTree, device="cuda") -> PyTree:
    """A tree of numpy arrays as the port's tensors on ``device``, leaf for leaf."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def params_to_numpy(tree: PyTree) -> PyTree:
    """The reverse of :func:`params_from_numpy`: tensors to host numpy arrays."""
    return tree_map(tensor_to_numpy, tree)
