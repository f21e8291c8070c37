"""PartitionSpec rules: params, optimizer state, caches, batches.

The JAX package's rules, copied: given a config and a mesh they name, for
every leaf of the params, the ZeRO-1 optimizer state, a batch and the
caches, the mesh axes each dim is split over.

Policy (production mesh, axes ("data","model") or ("pod","data","model")):
  * activations/batch  — batch dim over DATA (pod+data combined), when divisible;
  * attention          — q heads over MODEL; kv heads over MODEL when divisible
                         else replicated (GQA kv < tp);
  * mlp                — d_ff over MODEL (megatron column/row split);
  * MoE                — experts over MODEL (EP); router replicated;
  * mamba              — SSD heads over MODEL when divisible else replicated;
  * embedding/lm head  — vocab over MODEL;
  * KV caches          — batch over DATA; kv-heads over MODEL when divisible,
                         else sequence over MODEL (context-sharded decode);
  * optimizer state / master params (ZeRO-1) — param spec + the first
    still-unsharded dim divisible by |DATA| goes over DATA.

Every rule checks divisibility and degrades to replication, so any config
gets a spec on any mesh.  The tree walks go over the port's trees
(``models/params.py``): a leaf is anything with a ``.shape`` (a tensor, a
``device="meta"`` tensor for a full-width config), and a list or tuple
index is a path key as ``str(i)``, as the reference's ``str(k.idx)``.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.launch.mesh import Mesh, NamedSharding
from repro_torch.launch.mesh import PartitionSpec as P
from repro_torch.models.params import tree_leaves_with_path, tree_unflatten

PyTree = Any


def _keyed(tree: PyTree, one) -> PyTree:
    """``one(keys, leaf)`` at every leaf, with the path's keys as strings."""
    pairs = tree_leaves_with_path(tree)
    return tree_unflatten(tree, [one(tuple(str(k) for k in path), leaf) for path, leaf in pairs])


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis(mesh: Mesh) -> str:
    return "model"


def axis_size(mesh: Mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([mesh.shape[a] for a in axes]))


def _dim(size: int, want: int) -> bool:
    return want > 0 and size % want == 0


class ShardingRules:
    def __init__(self, cfg, mesh: Mesh):
        self.cfg = cfg
        self.mesh = mesh
        self.dp = data_axes(mesh)
        self.tp = axis_size(mesh, "model")
        self.dp_size = axis_size(mesh, self.dp)

    def named(self, spec: P) -> NamedSharding:
        return NamedSharding(self.mesh, spec)

    # ------------------------------------------------------------------
    # Parameter rules, keyed on the leaf's path within the params pytree
    # ------------------------------------------------------------------
    def param_spec(self, path: tuple[str, ...], shape: tuple[int, ...]) -> P:
        cfg, tp = self.cfg, self.tp
        # stage-stacked leaves carry a leading repeat dim; rules address the
        # trailing dims, so compute an offset
        name = path[-1]
        parent = path[-2] if len(path) >= 2 else ""
        gparent = path[-3] if len(path) >= 3 else ""

        def lead(base: P, base_ndim: int) -> P:
            extra = len(shape) - base_ndim
            return P(*([None] * extra + list(base)))

        # embeddings / head
        if parent == "embed" and name == "table":
            return P("model", None) if _dim(shape[0], tp) else P(None, None)
        if parent == "lm_head" and name == "w":
            return P(None, "model") if _dim(shape[1], tp) else P(None, None)
        if parent in ("frontend_proj", "mm_proj"):
            return P(*([None] * len(shape)))
        # attention
        if parent in ("attn", "self_attn", "cross_attn") or gparent in (
            "attn", "self_attn", "cross_attn"
        ):
            if name == "wq":
                ok = _dim(shape[-2], tp)
                return lead(P(None, "model" if ok else None, None), 3)
            if name in ("wk", "wv"):
                ok = _dim(shape[-2], tp)
                return lead(P(None, "model" if ok else None, None), 3)
            if name == "wo":
                ok = _dim(shape[-3], tp)
                return lead(P("model" if ok else None, None, None), 3)
            if name in ("bq", "bk", "bv"):
                ok = _dim(shape[-2], tp)
                return lead(P("model" if ok else None, None), 2)
            return lead(P(None), 1)  # bo, q_norm/k_norm scales
        # dense mlp (incl. MoE shared expert)
        if parent in ("mlp", "shared"):
            if name in ("w_gate", "w_up"):
                return lead(P(None, "model" if _dim(shape[-1], tp) else None), 2)
            if name == "w_out":
                return lead(P("model" if _dim(shape[-2], tp) else None, None), 2)
            if name == "b_up":
                return lead(P("model" if _dim(shape[-1], tp) else None), 1)
            return lead(P(None), 1)
        # MoE experts (EP over model)
        if parent == "moe":
            if name in ("w_gate", "w_up", "w_down"):
                ok = _dim(shape[-3], tp)
                return lead(P("model" if ok else None, None, None), 3)
            if name == "router":
                return lead(P(None, None), 2)
        # mamba
        if parent == "mamba":
            s = cfg.ssm
            heads_ok = s is not None and _dim(s.n_heads, tp)
            if name in ("w_x", "w_z"):
                return lead(P(None, "model" if heads_ok else None), 2)
            if name == "w_dt":
                return lead(P(None, "model" if heads_ok else None), 2)
            if name in ("w_B", "w_C"):
                return lead(P(None, None), 2)
            if name in ("conv_x",):
                return lead(P(None, "model" if heads_ok else None), 2)
            if name in ("conv_B", "conv_C"):
                return lead(P(None, None), 2)
            if name in ("dt_bias", "A_log", "D"):
                return lead(P("model" if heads_ok else None), 1)
            if name == "w_out":
                return lead(P("model" if heads_ok else None, None), 2)
            if parent == "mamba" and name == "scale":  # out_norm
                return lead(P("model" if heads_ok else None), 1)
        if gparent == "mamba" and parent == "out_norm":
            s = cfg.ssm
            heads_ok = s is not None and _dim(s.n_heads, tp)
            return lead(P("model" if heads_ok else None), 1)
        # norms, scalars, everything else: replicated
        return P(*([None] * len(shape)))

    def params_shardings(self, params_shapes: PyTree) -> PyTree:
        return _keyed(params_shapes,
                      lambda keys, leaf: self.named(self.param_spec(keys, tuple(leaf.shape))))

    # ------------------------------------------------------------------
    # Optimizer / master (ZeRO-1): extend with DATA on first free dim
    # ------------------------------------------------------------------
    def zero1_spec(self, pspec: P, shape: tuple[int, ...]) -> P:
        parts = list(pspec) + [None] * (len(shape) - len(pspec))
        for i, (sz, ax) in enumerate(zip(shape, parts)):
            if ax is None and _dim(sz, self.dp_size):
                parts[i] = self.dp
                break
        return P(*parts)

    def opt_shardings(self, params_shapes: PyTree) -> PyTree:
        def one(keys, leaf):
            shape = tuple(leaf.shape)
            return self.named(self.zero1_spec(self.param_spec(keys, shape), shape))

        return _keyed(params_shapes, one)

    # ------------------------------------------------------------------
    # Batches
    # ------------------------------------------------------------------
    def batch_spec(self, name: str, shape: tuple[int, ...]) -> P:
        if name == "pos" or not shape:
            return P()
        b = shape[0]
        lead = self.dp if _dim(b, self.dp_size) else None
        return P(lead, *([None] * (len(shape) - 1)))

    def batch_shardings(self, batch: dict) -> dict:
        return {
            k: self.named(self.batch_spec(k, tuple(v.shape))) for k, v in batch.items()
        }

    # ------------------------------------------------------------------
    # KV / state caches
    # ------------------------------------------------------------------
    def cache_spec(self, path: tuple[str, ...], shape: tuple[int, ...]) -> P:
        cfg, tp = self.cfg, self.tp
        name = path[-1]
        if name in ("k", "v") or (len(shape) >= 4 and name in ("0", "1")):
            # (.., B, Hkv, S, hd): batch→data; heads→model if divisible else seq→model
            base_ndim = 4
            extra = len(shape) - base_ndim
            b, hkv, s, hd = shape[extra:]
            lead = self.dp if _dim(b, self.dp_size) else None
            if _dim(hkv, tp):
                spec = [lead, "model", None, None]
            elif _dim(s, tp):
                spec = [lead, None, "model", None]
            else:
                spec = [lead, None, None, None]
            return P(*([None] * extra + spec))
        if name in ("ks", "vs"):  # (.., B, Hkv, S) quantization scales
            extra = len(shape) - 3
            b, hkv, s = shape[extra:]
            lead = self.dp if _dim(b, self.dp_size) else None
            if _dim(hkv, tp):
                spec = [lead, "model", None]
            elif _dim(s, tp):
                spec = [lead, None, "model"]
            else:
                spec = [lead, None, None]
            return P(*([None] * extra + spec))
        if name == "ssm":  # (.., B, H, P, N)
            extra = len(shape) - 4
            b, h, pdim, n = shape[extra:]
            lead = self.dp if _dim(b, self.dp_size) else None
            spec = [lead, "model" if _dim(h, tp) else None, None, None]
            return P(*([None] * extra + spec))
        if name.startswith("conv_"):  # (.., B, W-1, CH)
            extra = len(shape) - 3
            b, w, ch = shape[extra:]
            lead = self.dp if _dim(b, self.dp_size) else None
            ok = _dim(ch, tp) and name == "conv_x" and self.cfg.ssm is not None and _dim(
                self.cfg.ssm.n_heads, tp
            )
            spec = [lead, None, "model" if ok else None]
            return P(*([None] * extra + spec))
        # fallback: batch-only
        lead = self.dp if shape and _dim(shape[0], self.dp_size) else None
        return P(lead, *([None] * (len(shape) - 1)))

    def cache_shardings(self, cache_shapes: PyTree) -> PyTree:
        return _keyed(cache_shapes,
                      lambda keys, leaf: self.named(self.cache_spec(keys, tuple(leaf.shape))))

    # logical → physical translation for activation constraints
    def logical_mapping(self) -> dict[str, tuple[str, ...]]:
        return {"data": self.dp, "model": ("model",)}
