"""The dry run's tensor-parallel collectives (``hlo_analysis.ShardingTracker``).

* Hand-built graphs on a meta (4, 2) mesh, each with the collective XLA's
  SPMD partitioner inserts for it: a column-then-row parallel MLP (one
  all-reduce of the output shard), a vocab-sharded embedding lookup (one
  all-reduce), an expert-parallel buffer constrained back to replicated
  (one all-gather), a partial sum constrained to a split layout (one
  reduce-scatter), the MLP's backward (its input gradient's all-reduce),
  and a remat block recomputed on another thread, which keeps the tracker.
* The reference runs once, in a subprocess that imports its dry run and
  compiles the smoke configs at 4 sequences of 256 tokens (two microbatches
  to train), as ``test_torch_dryrun.py``'s does; its ``analyze_hlo``
  collectives against the port's: mamba2_130m's prefill, decode and train
  on (4, 2) and (2, 2, 2), deepseek_7b's prefill on (2, 4) (a model axis of
  4), deepseek_7b's prefill and decode and granite_moe_1b's prefill on
  (2, 3) (a model axis that does not divide the 512-token vocab: the
  padded vocab split of the logits is all-gathered on the way out), and
  granite_moe_1b's train step at 8 sequences, whose microbatch of 4 the 4
  data positions divide (``TRAIN_WITHIN``).  deepseek_7b's and
  granite_moe_1b's other cells are in ``test_torch_dryrun.py``.
"""
import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from repro_torch.configs import ShapeConfig
from repro_torch.distributed.api import observe_constraints, sharding_context
from repro_torch.distributed.api import with_sharding_constraint as wsc
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.hlo_analysis import DATA, MODEL, Collective, ShardingTracker
from repro_torch.launch.mesh import NamedSharding
from repro_torch.launch.mesh import PartitionSpec as P
from repro_torch.models import model_for
from repro_torch.models.params import tree_leaves_with_path, tree_unflatten
from test_torch_dryrun import (
    N_MICRO_SMALL,
    ROOT,
    SCRIPT,
    SMALL,
    TRAIN_WITHIN,
    _lower,
    _mesh,
    assert_train_collectives,
    port_collectives,
    reference_collectives,
    smoke,  # noqa: F401
)

BF16 = torch.bfloat16
SIZES = {DATA: 4, MODEL: 2}
B, T, D, F, V = 8, 16, 32, 64, 64
REF_CASES = ([("mamba2_130m", kind, mesh) for kind in ("prefill", "decode", "train")
              for mesh in ((4, 2), (2, 2, 2))] + [("deepseek_7b", "prefill", (2, 4))]
             + [(arch, kind, (2, 3)) for arch, kind in (("deepseek_7b", "prefill"),
                                                        ("deepseek_7b", "decode"),
                                                        ("granite_moe_1b", "prefill"))])
WIDE = ShapeConfig("train", 256, 8, "train")  # a microbatch of 4 sequences on dp 4


def _spec(*parts):
    return NamedSharding(_mesh((4, 2)), P(*parts))


def _meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _traced(fn, *seeds):
    """``fn()``'s collectives under a tracker for the (4, 2) mesh, with each
    (tensor, spec) of ``seeds`` laid out so."""
    tracker = ShardingTracker(SIZES)
    for t, spec in seeds:
        tracker.seed(t, _spec(*spec))
    hlo_analysis.analyze_callable(fn, tracker=tracker)
    assert tracker.fallbacks == {}
    return tracker.collectives


def _all_reduce(shape, op, dtype=BF16):
    return Collective("all-reduce", shape, dtype, ((DATA,), (), ()), op)


# ----------------------------------------------------------------------
# hand-built graphs
# ----------------------------------------------------------------------
def _mlp_seeds():
    x, w1, w2 = _meta(B, T, D), _meta(D, F), _meta(F, D)
    return x, w1, w2, [(x, ("data", None, None)), (w1, (None, "model")), (w2, ("model", None))]


def test_column_then_row_mlp_all_reduces_its_output_once():
    x, w1, w2, seeds = _mlp_seeds()
    got = _traced(lambda: x + torch.nn.functional.gelu(x @ w1) @ w2, *seeds)
    assert got == [_all_reduce((B, T, D), "aten.add")]
    assert got[0].shard_bytes(SIZES) == B // 4 * T * D * 2


def test_vocab_sharded_embedding_all_reduces_at_its_constraint():
    table, tokens = _meta(V, D), torch.empty((B, T), dtype=torch.long, device="meta")
    got = _traced(lambda: wsc(table[tokens], _spec("data", None, None)),
                  (table, ("model", None)), (tokens, ("data", None)))
    assert got == [_all_reduce((B, T, D), "constraint:activation")]


def test_expert_buffer_constrained_back_to_replicated_all_gathers():
    buf = _meta(8, 16, D)

    def fn():
        xe = wsc(buf, _spec("model", "data", None))  # a slice: nothing moves
        return wsc(xe * 2, _spec(None, "data", None))

    got = _traced(fn, (buf, (None, None, None)))
    assert got == [Collective("all-gather", (8, 16, D), BF16, ((MODEL,), (DATA,), ()),
                              "constraint:activation")]
    assert got[0].shard_bytes(SIZES) == 4 * 4 * D * 2


def test_partial_sum_constrained_to_a_split_layout_reduce_scatters():
    x, w1, w2, seeds = _mlp_seeds()
    got = _traced(lambda: wsc((x @ w1) @ w2, _spec("data", None, "model")), *seeds)
    assert got == [Collective("reduce-scatter", (B, T, D), BF16, ((DATA,), (), ()),
                              "constraint:activation")]


def test_mlp_backward_all_reduces_its_input_gradient():
    """Forward, the output's all-reduce; backward, the gradient of ``x``
    through ``w1`` sums over the model-split F and is all-reduced where it
    meets the residual's gradient."""
    x, w1, w2, seeds = _mlp_seeds()

    def fn():
        xg = x.detach().requires_grad_()
        y = xg + torch.nn.functional.gelu(xg @ w1) @ w2
        return torch.autograd.grad(y.float().sum(), xg)

    got = _traced(fn, *seeds)
    assert got == [_all_reduce((B, T, D), "aten.add")] * 2


def test_remat_recompute_on_another_thread_keeps_the_tracker(smoke):
    """granite_moe_1b's smoke loss on (4, 2), remat blocks: the backward on a
    worker thread, outside the sharding context and the observer block, as
    autograd runs it on the card, gives the collectives of a backward inside
    them (the recompute's MoE constraints all-gather), and its constraints
    reach the tracker (``distributed/api.py::bind_context``)."""
    calls = []

    class Counting(ShardingTracker):
        def __call__(self, x, named, site):
            calls.append(site)
            return super().__call__(x, named, site)

    lowered, _, cfg = _lower("granite_moe_1b", "train", (4, 2))
    assert cfg.remat == "block"
    model = model_for(cfg)

    def run(elsewhere: bool) -> list:
        params, _, batch = lowered.inputs(cfg, 1)
        tracker = Counting(SIZES)
        tracker.seed(params, lowered.rules.params_shardings(params))
        tracker.seed(batch, lowered.rules.batch_shardings(batch))
        leaves = [p for _, p in tree_leaves_with_path(params)]
        with tracker, sharding_context(lowered.mesh, lowered.rules.logical_mapping()), \
                observe_constraints(tracker):
            live = [p.detach().requires_grad_() for p in leaves]
            loss, _ = model.loss(tree_unflatten(params, live), batch)
            if not elsewhere:
                torch.autograd.grad(loss, live, allow_unused=True)
                return tracker.collectives
        n_forward, done = len(calls), []

        def backward():
            with tracker:  # autograd carries the dispatch modes to its device thread
                done.append(torch.autograd.grad(loss, live, allow_unused=True))

        worker = threading.Thread(target=backward)
        worker.start()
        worker.join(timeout=120)
        assert done, "the backward on another thread failed"
        assert len(calls) > n_forward  # the recompute's constraints were observed
        return tracker.collectives

    here = run(False)
    n_here = len(calls)
    calls.clear()
    there = run(True)
    assert there == here and len(calls) == n_here
    assert any(c.kind == "all-gather" for c in there)


# ----------------------------------------------------------------------
# against the reference's compiled programs
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref():
    cases = REF_CASES + [("granite_moe_1b", "wide", (4, 2))]
    shapes = {k: [s.seq_len, s.global_batch, s.kind] for k, s in {**SMALL, "wide": WIDE}.items()}
    spec = {"cases": cases, "n_micro": N_MICRO_SMALL, "shapes": shapes}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT / "src"), json.dumps(spec)],
                          capture_output=True, text=True, env=env, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    results = json.loads(proc.stdout.strip().splitlines()[-1])
    return {(a, k, tuple(m)): r["collectives"] for (a, k, m), r in zip(cases, results)}


@pytest.mark.parametrize("arch, kind, mesh", REF_CASES,
                         ids=[f"{a}-{k}-{'x'.join(map(str, m))}" for a, k, m in REF_CASES])
def test_collectives_match_reference(ref, smoke, arch, kind, mesh):
    """mamba2_130m's prefill: the embedding's all-reduce, and in each layer
    one of the gated norm's mean over the model-split heads and one of the
    output projection; deepseek_7b's prefill on (2, 4) all-reduces 131,072 B
    a device 7 times."""
    lowered, _, _ = _lower(arch, kind, mesh)
    traced = lowered.trace(lowered.layer_counts(), lowered.n_micro)
    got = port_collectives(lowered, traced, train=kind == "train")
    if kind == "train":
        assert_train_collectives(arch, got, ref[(arch, kind, mesh)])
    else:
        assert got == reference_collectives(ref[(arch, kind, mesh)])
    if mesh == (2, 4):
        assert got == {"all-reduce": [7, 7 * 2 * 131072]}


def test_moe_train_within_bound_where_the_data_axis_divides_the_microbatch(ref, smoke):
    """granite_moe_1b's train step at 8 sequences: each microbatch of 4
    splits evenly over dp 4, XLA reshards nothing over the data axis, and
    the port's all-reduce + all-gather bytes are within TRAIN_WITHIN of the
    reference's (collective-permutes and all-to-alls not modelled)."""
    lowered, _, _ = dryrun.lower_cell("granite_moe_1b", WIDE, _mesh((4, 2)),
                                      n_micro=N_MICRO_SMALL)
    traced = lowered.trace(lowered.layer_counts(), lowered.n_micro)
    got = port_collectives(lowered, traced, train=True)
    want = reference_collectives(ref[("granite_moe_1b", "wide", (4, 2))],
                                 kinds=("all-reduce", "all-gather"))
    total, ref_total = (sum(b for _, b in d.values()) for d in (got, want))
    assert abs(total / ref_total - 1) <= TRAIN_WITHIN, (got, want)
