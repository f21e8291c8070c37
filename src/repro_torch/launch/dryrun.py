"""Multi-pod dry run: trace every (arch × shape × mesh) cell on ``meta``.

The JAX package lowers and compiles each cell's step for the production
mesh and reads memory, FLOPs, bytes and collectives from XLA
(``repro/launch/dryrun.py``).  The port runs the same step, at full width,
on ``device="meta"`` tensors (shapes and dtypes, no storage: the
reference's ``ShapeDtypeStruct`` inputs) inside the mesh's
``sharding_context``, and records per cell:

  * ``memory``      — per device, from the sharding rules alone: each
                      argument leaf's shard bytes under ``params_shardings``
                      / ``opt_shardings`` / ``batch_shardings`` /
                      ``cache_shardings`` (``argument_size_in_bytes``; equal
                      to XLA's ``memory_analysis()``), the prefill's outputs
                      under the reference's ``out_shardings``
                      (``output_size_in_bytes``) and the donated arguments
                      (``alias_size_in_bytes``).  No temp or peak bytes:
                      without a partitioner they are not derivable per
                      device;
  * ``cost``        — the whole program's FLOPs and bytes
                      (``launch/hlo_analysis.py::analyze_callable``) split
                      evenly over the mesh's devices: an ideal split that
                      counts no replicated work, unlike XLA's per-device HLO;
  * ``collectives`` — per device, from two sources (``"collective_model":
                      "zero1+tp"``, split in ``by_source``): the train
                      step's ZeRO-1 traffic over the data axes, derived from
                      the constraints ``distributed/api.py`` records
                      (:func:`zero1_collectives`), and the tensor-parallel
                      traffic over the model axis that XLA's SPMD
                      partitioner inserts, from the layouts
                      ``hlo_analysis.ShardingTracker`` follows through the
                      trace (:func:`tp_collectives`);
  * ``roofline``    — ``hlo_analysis.roofline_terms`` at an H100's rates.

Tracing a full-width step op by op costs host time in proportion to its
layers and microbatches.  So a cell is traced at a few layer counts (2 and
3; 2, 3 and 4 for train) and at one and two microbatches of the same size,
and the counts are extrapolated (:func:`_extrapolate`): a stage repeats
identical layers and a step identical microbatches, so every count is a
polynomial in them (linear, but quadratic in the layers for a train
step's bytes), and the extrapolation is exact
(``tests/test_torch_dryrun_scaling*.py`` hold it equal to unscaled traces).

Run one cell:   python -m repro_torch.launch.dryrun --arch deepseek_7b --shape train_4k --mesh single
Run everything: python -m repro_torch.launch.dryrun --all --mesh both
Results land in results/dryrun_torch/<arch>__<shape>__<mesh>.json.  No card
is needed or touched.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import time
import traceback
from contextlib import contextmanager
from dataclasses import dataclass, replace
from fractions import Fraction
from typing import Any, Callable

import torch

from repro_torch.distributed.sharding import axis_size
from repro_torch.launch.hlo_analysis import (
    DATA,
    HBM_BW,
    MODEL,
    HloStats,
    ShardingTracker,
    analyze_callable,
    roofline_terms,
)
from repro_torch.launch.mesh import NamedSharding

# per-arch microbatch counts for train_4k (global batch 256), the reference's
N_MICRO = {
    "stablelm_12b": 8,
    "deepseek_7b": 8,
    "gemma3_1b": 16,
    "internlm2_20b": 16,
    "jamba_v01_52b": 32,
    "whisper_medium": 8,
    "deepseek_moe_16b": 16,
    "granite_moe_1b": 8,
    "mamba2_130m": 4,
    "llava_next_mistral_7b": 8,
}
DATA_AXES = ("pod", "data")  # distributed/sharding.py::data_axes
_REPEAT_BASE = 2  # a stage of one repeat runs unstacked, so layer counts extrapolate from 2
_MICRO_BASE = 1
MEMORY_NOTE = ("per-device shard bytes under the sharding rules; no temp or peak bytes: "
               "without a partitioner they are not derivable per device")
COST_NOTE = "whole program / n_devices: an ideal split that counts no replicated work"
COLLECTIVE_NOTE = ("operand bytes per device, two sources (by_source). zero1: over the data "
                   "axes, a reduce-scatter (all-reduce where the ZeRO-1 spec adds no data axis) "
                   "of each f32 gradient per microbatch and an all-gather of each param per "
                   "step. tp: over the model axis, what XLA's SPMD partitioner inserts for the "
                   "layouts of params, batch, caches and constraints: an all-reduce after each "
                   "contraction, gather or sum over a model-split dim, a reduce-scatter or "
                   "all-gather where a constraint changes the model split, forward, backward "
                   "and remat recompute, and an all-gather of a result whose model split pads "
                   "its dim. Not modelled: XLA's collective-permutes and "
                   "all-to-alls that reshard remat'd values, its all-reduce combiner (each "
                   "tensor counts once), and data-axis traffic of activations (the loss's "
                   "scalar sums)")


def _cfg_for(arch: str, kind: str = "train", overrides: dict | None = None):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    # the dry run traces the chunked attention path, as the reference lowers
    # it; decode shapes use the int8-quantized KV cache, and grouped GQA decode
    kv = "int8" if kind == "decode" else "bf16"
    cfg = replace(cfg, attn_impl="chunked", kv_cache_dtype=kv, gqa_decode="grouped")
    for key, val in (overrides or {}).items():
        if "." in key:  # nested, e.g. ssm.chunk=128
            sub, leaf = key.split(".", 1)
            cfg = replace(cfg, **{sub: replace(getattr(cfg, sub), **{leaf: val})})
        else:
            cfg = replace(cfg, **{key: val})
    return cfg


def bf16_struct(tree):
    """Floating leaves as bfloat16, others as they are (the reference's)."""
    from repro_torch.models.params import tree_map

    return tree_map(lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t, tree)


# ----------------------------------------------------------------------
# Shard bytes
# ----------------------------------------------------------------------
def shard_bytes(shape, dtype: torch.dtype, named: NamedSharding) -> int:
    """Bytes of one device's shard (a dim that does not split evenly is
    padded, as XLA pads it)."""
    n = 1
    for i, size in enumerate(shape):
        part = named.spec[i] if i < len(named.spec) else None
        n *= -(-size // (1 if part is None else axis_size(named.mesh, part)))
    return n * dtype.itemsize


def tree_shard_bytes(tree, shardings) -> int:
    from repro_torch.models.params import tree_leaves_with_path

    leaves = [x for _, x in tree_leaves_with_path(tree)]
    specs = [s for _, s in tree_leaves_with_path(shardings)]
    return sum(shard_bytes(tuple(x.shape), x.dtype, s) for x, s in zip(leaves, specs))


# ----------------------------------------------------------------------
# The collective model
# ----------------------------------------------------------------------
def _without_data(spec):
    """A ZeRO-1 spec with its data axes taken out: the params spec it
    extends (``ShardingRules.zero1_spec`` only adds data axes)."""
    def keep(part):
        names = tuple(a for a in ((part,) if isinstance(part, str) else part or ())
                      if a not in DATA_AXES)
        return names or None

    return type(spec)(*[keep(part) for part in spec])


def tp_collectives(collectives, rules, stats: HloStats) -> None:
    """Add the tensor-parallel collectives a :class:`ShardingTracker` wrote
    down, priced per device on ``rules``' mesh, to ``stats``.  Each is in
    global terms (whole shape, logical spec), so one trace prices every mesh
    whose layouts it shares."""
    sizes = {DATA: rules.dp_size, MODEL: rules.tp}
    for c in collectives:
        stats.add_collective(c.kind, c.shard_bytes(sizes))


def zero1_collectives(records, rules, stats: HloStats) -> None:
    """Add the train step's ZeRO-1 collectives on ``rules``' mesh, per
    device, to ``stats``: each ``"grad"`` record (one microbatch's f32
    gradient) is a reduce-scatter of its model-sharded gradient over the data
    axes of its ZeRO-1 spec, or an all-reduce where that spec adds no data
    axis; each ``"params"`` record (a new param, back to its params spec) is
    an all-gather of its ZeRO-1 shard where that spec adds one.  Each is
    priced as its operand's bytes in the tensor's own dtype, the reference
    analyser's convention; with one data position nothing moves.  Only a
    record's params spec is read, so records taken on one mesh price the
    collectives of any mesh with the same model axis."""
    if rules.dp_size == 1:
        return
    for r in records:
        if r.site not in ("grad", "params"):
            continue
        pspec = _without_data(r.spec)
        ospec = rules.zero1_spec(pspec, r.shape)
        adds_data = any(a in DATA_AXES for a in ospec.axis_names())
        if r.site == "grad":
            stats.add_collective("reduce-scatter" if adds_data else "all-reduce",
                                 shard_bytes(r.shape, r.dtype, rules.named(pspec)))
        elif adds_data:
            stats.add_collective("all-gather", shard_bytes(r.shape, r.dtype, rules.named(ospec)))


# ----------------------------------------------------------------------
# Lowering: the cell's step, its meta inputs, traced at any layer count
# ----------------------------------------------------------------------
@contextmanager
def _stage_repeats(cfg, repeats: tuple[int, ...] | None):
    """Inside, ``transformer.build_stages(cfg)`` gives the config's stages
    with these repeat counts (params, caches and forward all follow it)."""
    from repro_torch.models import transformer

    if repeats is None:
        yield
        return
    build = transformer.build_stages
    cut = [replace(st, repeat=r) for st, r in zip(build(cfg), repeats)]
    transformer.build_stages = lambda c: cut if c == cfg else build(c)
    try:
        yield
    finally:
        transformer.build_stages = build


@dataclass
class LoweredCell:
    """One cell, ready to trace: the port's counterpart of a ``Lowered``."""

    cfg: Any
    kind: str
    mesh: Any
    rules: Any
    seq_len: int
    global_batch: int
    n_micro: int
    memory: dict
    variables: dict  # name -> (base, full value, degree) of every extrapolated count

    def layer_counts(self) -> dict:
        """Every layer count the trace can cut, at its full value."""
        if self.cfg.family == "audio":
            return {"encoder_layers": self.cfg.encdec.encoder_layers,
                    "n_layers": self.cfg.n_layers}
        from repro_torch.models.transformer import build_stages

        return {f"stage{i}": st.repeat for i, st in enumerate(build_stages(self.cfg))}

    @contextmanager
    def _cut(self, layers: dict):
        cfg = self.cfg
        if cfg.family == "audio":
            yield replace(cfg, n_layers=layers["n_layers"],
                          encdec=replace(cfg.encdec, encoder_layers=layers["encoder_layers"]))
            return
        with _stage_repeats(cfg, tuple(layers[f"stage{i}"] for i in range(len(layers)))):
            yield cfg

    def zero1_splits(self, layers: dict) -> list[bool]:
        """Per param leaf at these layer counts, whether its ZeRO-1 spec
        splits it over the data axes: a stacked leaf's leading dim is a layer
        count, so where nothing else divides, the count decides."""
        from repro_torch.models import model_for
        from repro_torch.models.params import MetaGenerator, tree_leaves_with_path

        with self._cut(layers) as cfg:
            params = model_for(cfg).init(MetaGenerator())
        return [any(a in DATA_AXES for a in s.spec.axis_names())
                for _, s in tree_leaves_with_path(self.rules.opt_shardings(params))]

    def inputs(self, cfg, n_micro: int) -> tuple:
        """The step's arguments on ``meta``, bf16 params first."""
        from repro_torch.data.synthetic import batch_specs
        from repro_torch.models import model_for
        from repro_torch.models.params import MetaGenerator
        from repro_torch.optim.adamw import init_opt_state

        model = model_for(cfg)
        params = bf16_struct(model.init(MetaGenerator()))
        batch = batch_specs(cfg, self.seq_len, self.global_batch // self.n_micro * n_micro,
                            kind=self.kind)
        if self.kind == "train":
            return params, init_opt_state(params), batch
        if self.kind == "prefill":
            return params, batch
        # decode_step reads the position on the host: a CPU scalar, as make_batch sets it
        batch["pos"] = torch.tensor(self.seq_len - 1, dtype=torch.int32)
        return params, batch, model.init_cache(self.global_batch, self.seq_len, device="meta")

    def step(self, cfg, n_micro: int) -> Callable:
        """The cell's step for ``cfg``: the train step, prefill or decode."""
        from repro_torch.models import model_for
        from repro_torch.train.step import make_train_step

        if self.kind == "train":
            return make_train_step(cfg, self.mesh, n_micro=n_micro)[1]
        model = model_for(cfg)
        return model.prefill if self.kind == "prefill" else model.decode_step

    def tracker(self, args: tuple) -> ShardingTracker:
        """A tracker for this cell's mesh with the step's arguments laid out
        by the sharding rules: params, optimizer state, batch, caches."""
        rules = self.rules
        tracker = ShardingTracker({DATA: rules.dp_size, MODEL: rules.tp})
        tracker.seed(args[0], rules.params_shardings(args[0]))
        if self.kind == "train":
            tracker.seed(args[1], rules.opt_shardings(args[1]))
        batch = args[2] if self.kind == "train" else args[1]
        tracker.seed(batch, rules.batch_shardings(batch))
        if self.kind == "decode":
            tracker.seed(args[2], rules.cache_shardings(args[2]))
        return tracker

    def trace(self, layers: dict, n_micro: int) -> tuple[dict, list, Any, list]:
        """One meta trace at these layer and microbatch counts: the
        program's FLOPs and bytes as integers, the constraints it recorded,
        its (meta) result, and the tensor-parallel collectives its tracker
        wrote down."""
        from repro_torch.distributed.api import record_constraints, sharding_context

        with self._cut(layers) as cfg:
            args = self.inputs(cfg, n_micro)
            step = self.step(cfg, n_micro)
            tracker = self.tracker(args)
            with sharding_context(self.mesh, self.rules.logical_mapping()), \
                    record_constraints() as records:
                stats, out = analyze_callable(step, *args, tracker=tracker)
        return ({"flops": int(stats.flops), "bytes": int(stats.bytes_accessed)}, records, out,
                tracker.collectives)

    def trace_key(self, layers: dict, n_micro: int) -> tuple:
        """What a trace depends on: the program, and of the mesh the model
        axis and whether the data axes split the batch (the seeds' layouts:
        records and collectives are kept in global terms and priced per
        mesh); the whole mesh where MoE layers route each data shard apart."""
        batch = self.global_batch // self.n_micro * n_micro
        mesh = (tuple(self.mesh.shape.items()) if self.cfg.moe is not None
                else (self.rules.tp, batch % self.rules.dp_size == 0))
        return (self.cfg, self.kind, self.seq_len, batch, tuple(layers.items()), n_micro, mesh)

    def counts(self, traced: tuple[dict, list, Any, list]) -> dict:
        """A trace's counts on this cell's mesh: its FLOPs and bytes, the
        collectives of each source (``"zero1:bytes:<kind>"``, ``"tp:..."``)
        and both together (``"bytes:<kind>"``, ``"count:<kind>"``), and
        for a prefill the output bytes."""
        counts, records, out, collectives = traced
        counts = dict(counts)
        for source, price, what in (("zero1", zero1_collectives, records),
                                    ("tp", tp_collectives, collectives)):
            stats = HloStats()
            price(what, self.rules, stats)
            for kind, b in stats.bytes_by_kind.items():
                n = int(stats.count_by_kind[kind])
                counts[f"{source}:bytes:{kind}"] = int(b)
                counts[f"{source}:count:{kind}"] = n
                counts[f"bytes:{kind}"] = counts.get(f"bytes:{kind}", 0) + int(b)
                counts[f"count:{kind}"] = counts.get(f"count:{kind}", 0) + n
        if self.kind == "prefill":
            counts["output_bytes"] = self._prefill_output_bytes(*out)
        return counts

    def _prefill_output_bytes(self, logits, cache) -> int:
        """The reference's ``out_shardings``: logits over data (and vocab over
        model where it divides), caches by ``cache_shardings``."""
        from repro_torch.launch.mesh import PartitionSpec as P

        rules = self.rules
        lspec = rules.batch_spec("logits", tuple(logits.shape))
        if logits.shape[-1] % rules.tp == 0:
            lspec = P(*(list(lspec) + [None] * (logits.dim() - len(lspec)))[:-1], "model")
        return (shard_bytes(tuple(logits.shape), logits.dtype, rules.named(lspec))
                + tree_shard_bytes(cache, rules.cache_shardings(cache)))


def _lagrange(t: int, j: int, degree: int) -> int:
    """The Lagrange basis polynomial of node ``j`` of the nodes 0..degree at
    the integer ``t``: an integer (a product of binomial coefficients)."""
    w = Fraction(1)
    for m in range(degree + 1):
        if m != j:
            w *= Fraction(t - m, j - m)
    return int(w)


def _extrapolate(points: dict, variables: dict) -> dict:
    """Polynomial extrapolation from a grid of traces: ``points`` maps each
    grid point (one offset 0..degree per variable, in ``variables``' order)
    to its counts; ``variables`` maps each name to (base, target, degree).
    Exact, in integers, for counts that are polynomials of at most those
    degrees in each variable."""
    out: dict = {}
    for offsets, counts in points.items():
        w = 1
        for off, (base, target, degree) in zip(offsets, variables.values()):
            w *= _lagrange(target - base, off, degree)
        for k, v in counts.items():
            out[k] = out.get(k, 0) + w * v
    return out


def lower_cell(arch: str, shape_name, mesh, *, n_micro: int | None = None,
               overrides: dict | None = None):
    """Returns (lowered, meta, cfg) for one cell.  ``shape_name`` is a key of
    ``SHAPES`` or a ``ShapeConfig``."""
    from repro_torch.configs import SHAPES
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.models import model_for
    from repro_torch.data.synthetic import batch_specs
    from repro_torch.models.params import MetaGenerator
    from repro_torch.optim.adamw import init_opt_state

    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    cfg = _cfg_for(arch, shape.kind, overrides)
    rules = ShardingRules(cfg, mesh)
    model = model_for(cfg)
    meta = {"arch": arch, "shape": shape.name, "kind": shape.kind,
            "seq_len": shape.seq_len, "global_batch": shape.global_batch}
    nm = 1
    if shape.kind == "train":
        nm = n_micro or N_MICRO.get(arch, 8)
        meta["n_micro"] = nm

    # argument (and donated) bytes at full width, from the rules alone
    params = bf16_struct(model.init(MetaGenerator()))
    batch = batch_specs(cfg, shape.seq_len, shape.global_batch, kind=shape.kind)
    params_bytes = tree_shard_bytes(params, rules.params_shardings(params))
    arg = params_bytes + tree_shard_bytes(batch, rules.batch_shardings(batch))
    if shape.kind == "train":  # params and optimizer state donated
        opt = init_opt_state(params)
        opt_bytes = tree_shard_bytes(opt, rules.opt_shardings(opt))
        memory = {"argument_size_in_bytes": arg + opt_bytes,
                  "alias_size_in_bytes": params_bytes + opt_bytes}
    elif shape.kind == "decode":  # the cache donated
        cache = model.init_cache(shape.global_batch, shape.seq_len, device="meta")
        cache_bytes = tree_shard_bytes(cache, rules.cache_shardings(cache))
        memory = {"argument_size_in_bytes": arg + cache_bytes, "alias_size_in_bytes": cache_bytes}
    else:
        memory = {"argument_size_in_bytes": arg}

    lowered = LoweredCell(cfg, shape.kind, mesh, rules, shape.seq_len, shape.global_batch, nm,
                          memory, {})
    # a train step's bytes grow with the square of a stage's repeats: the
    # backward of each repeat's slice of a stacked param (``a[r]``) writes a
    # zero-filled gradient of the whole stack
    degree = 2 if shape.kind == "train" else 1
    variables = {name: (_REPEAT_BASE, full, degree)
                 for name, full in lowered.layer_counts().items()
                 if full > _REPEAT_BASE + degree}
    if nm > _MICRO_BASE + 1:
        variables["n_micro"] = (_MICRO_BASE, nm, 1)
    lowered.variables = variables
    return lowered, meta, cfg


def trace_counts(lowered: LoweredCell, scale: bool = True,
                 traces: dict | None = None) -> tuple[dict, int]:
    """The cell's counts at full size, and the number of traces it took:
    extrapolated from a grid over ``lowered.variables`` (``scale``), or
    one unscaled trace.  ``traces`` keeps traces for cells that share them
    (the same program on another mesh)."""
    traces = {} if traces is None else traces
    taken = 0

    def counts_at(layers, n_micro):
        nonlocal taken
        key = lowered.trace_key(layers, n_micro)
        if key not in traces:
            traces[key] = lowered.trace(layers, n_micro)
            taken += 1
        return lowered.counts(traces[key])

    full = lowered.layer_counts()
    if not scale or not lowered.variables:
        return counts_at(full, lowered.n_micro), taken
    names = list(lowered.variables)
    grid = []
    for offsets in itertools.product(*[range(lowered.variables[n][2] + 1) for n in names]):
        at = {n: lowered.variables[n][0] + off for n, off in zip(names, offsets)}
        grid.append((offsets, {n: at.get(n, v) for n, v in full.items()},
                     at.get("n_micro", lowered.n_micro)))
    if lowered.kind == "train" and lowered.rules.dp_size > 1:
        # the ZeRO-1 collectives extrapolate only while every layer count of
        # the grid splits the same leaves as the full count does
        splits = lowered.zero1_splits(full)
        for _, layers, _ in grid:
            if lowered.zero1_splits(layers) != splits:
                raise ValueError(f"at layer counts {layers} the ZeRO-1 rule splits other "
                                 f"leaves over data than at {full}; trace unscaled")
    points = {offsets: counts_at(layers, n_micro) for offsets, layers, n_micro in grid}
    return _extrapolate(points, lowered.variables), taken


def model_flops_basis(meta: dict, cfg) -> dict:
    """The ideal step's FLOPs as 2 (6 to train) x active params x tokens."""
    tokens = meta["seq_len"] * meta["global_batch"] if meta["kind"] != "decode" \
        else meta["global_batch"]
    mult = 6 if meta["kind"] == "train" else 2
    return {"active_params": cfg.active_param_count(), "tokens": tokens, "multiplier": mult}


def analyze(lowered: LoweredCell, meta: dict, cfg, mesh, *, traces: dict | None = None) -> dict:
    t0 = time.time()
    counts, n_traces = trace_counts(lowered, traces=traces)
    out = dict(meta)
    out["trace_s"] = round(time.time() - t0, 2)
    out["traces"] = n_traces  # traces taken for this cell; others came from ``traces``
    # each extrapolated count: [first node, full value, degree]
    out["extrapolated_from"] = {k: list(v) for k, v in lowered.variables.items()}
    n_dev = int(mesh.devices.size)
    out["n_devices"] = n_dev
    out["memory"] = dict(lowered.memory)
    if "output_bytes" in counts:
        out["memory"]["output_size_in_bytes"] = counts["output_bytes"]
    out["memory"]["note"] = MEMORY_NOTE

    stats = HloStats(flops=counts["flops"] / n_dev, bytes_accessed=counts["bytes"] / n_dev,
                     bytes_raw=counts["bytes"] / n_dev)
    by_source = {src: HloStats() for src in ("zero1", "tp")}
    for key, val in counts.items():
        if key.startswith("bytes:"):
            kind = key.split(":", 1)[1]
            stats.add_collective(kind, val, counts[f"count:{kind}"])
        elif key.split(":")[0] in by_source and key.split(":")[1] == "bytes":
            src, _, kind = key.split(":", 2)
            by_source[src].add_collective(kind, val, counts[f"{src}:count:{kind}"])
    out["program"] = {"flops": counts["flops"], "bytes_accessed": counts["bytes"]}
    out["cost"] = {"flops": stats.flops, "bytes_accessed": stats.bytes_accessed,
                   "note": COST_NOTE}
    out["collectives"] = {**stats.to_dict(), "collective_model": "zero1+tp",
                          "by_source": {src: {k: v for k, v in s.to_dict().items()
                                              if k in ("collective_bytes", "bytes_by_kind",
                                                       "count_by_kind")}
                                        for src, s in by_source.items()},
                          "note": COLLECTIVE_NOTE}

    basis = out["model_flops_basis"] = model_flops_basis(meta, cfg)
    model_flops = basis["multiplier"] * basis["active_params"] * basis["tokens"]
    out["roofline"] = roofline_terms(
        hlo_flops=stats.flops,
        hlo_bytes=stats.bytes_accessed,
        collective_bytes=stats.collective_bytes,
        chips=n_dev,
        model_flops=model_flops,
    )
    if meta["kind"] == "decode":
        # decode is memory-bound by construction: the right denominator is
        # one pass over the per-device resident state (param shard + cache
        # shard) = argument bytes; the memory term is clamped from below by
        # it, so the fraction is <= 1 (the reference's rule)
        r = out["roofline"]
        ideal_s = out["memory"]["argument_size_in_bytes"] / HBM_BW
        r["ideal_memory_s"] = ideal_s
        r["memory_s"] = max(r["memory_s"], ideal_s)
        terms = {k: r[k] for k in ("compute_s", "memory_s", "collective_s")}
        r["dominant"] = max(terms, key=terms.get).replace("_s", "")
        r["bound_s"] = max(terms.values())
        r["roofline_fraction"] = ideal_s / max(r["bound_s"], 1e-30)
    return out


def run_cell(arch: str, shape_name: str, mesh_kind: str, outdir: str,
             *, n_micro: int | None = None, tag: str = "",
             overrides: dict | None = None, traces: dict | None = None) -> dict:
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device="meta")
    lowered, meta, cfg = lower_cell(arch, shape_name, mesh, n_micro=n_micro,
                                    overrides=overrides)
    meta["mesh"] = mesh_kind
    if overrides:
        meta["overrides"] = {k: str(v) for k, v in overrides.items()}
    result = analyze(lowered, meta, cfg, mesh, traces=traces)
    os.makedirs(outdir, exist_ok=True)
    name = f"{arch}__{shape_name}__{mesh_kind}{tag}.json"
    with open(os.path.join(outdir, name), "w") as f:
        json.dump(result, f, indent=1)
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (int/float/str), e.g. ssm.chunk=128")
    args = ap.parse_args()

    from repro_torch.configs import cells

    if args.all:
        todo = [(a, s) for a, s, skip in cells() if skip is None]
    else:
        todo = [(args.arch, args.shape)]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    overrides = {}
    for item in args.override:
        k, v = item.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        overrides[k] = v

    failures = []
    t_all = time.time()
    for arch, shape in todo:
        traces: dict = {}  # shared by the cell's meshes
        for mk in meshes:
            try:
                r = run_cell(arch, shape, mk, args.out,
                             n_micro=args.n_micro, tag=args.tag,
                             overrides=overrides or None, traces=traces)
                roof = r["roofline"]
                print(
                    f"OK  {arch:24s} {shape:12s} {mk:6s} "
                    f"trace={r['trace_s']:7.1f}s "
                    f"dom={roof['dominant']:10s} "
                    f"frac={roof['roofline_fraction']:.3f} "
                    f"args={r['memory']['argument_size_in_bytes'] / 2**30:.2f}GiB",
                    flush=True,
                )
            except Exception as e:  # a failed cell is reported; the sweep goes on
                failures.append((arch, shape, mk, str(e)))
                print(f"FAIL {arch} {shape} {mk}: {e}", flush=True)
                traceback.print_exc()
    print(f"{len(todo) * len(meshes) - len(failures)} cells in {time.time() - t_all:.1f}s",
          flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} cells failed")


if __name__ == "__main__":
    main()
