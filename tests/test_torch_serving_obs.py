"""``ServeEngine`` with the tracer on and off, at the smoke widths of
``deepseek_7b`` and ``granite_moe_1b`` on the CPU: the same tokens; one
``engine.queue`` span per request from its arrival; per batch one
``engine.prefill`` and ``budget - 1`` ``engine.decode_step`` spans; the
counters equal to the arithmetic of the batches; and, under an op log, no
op of the tracer's when it is off and only its counters' when it is on."""
import dataclasses
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import obs
from repro_torch.configs import get_smoke
from repro_torch.distributed.api import sharding_context
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model_for
from repro_torch.models import moe
from repro_torch.serving.engine import ServeEngine

ARCHS = ("deepseek_7b", "granite_moe_1b")
# (prompt length, new tokens): batches of 2, the 20-token prompt left-padded
REQUESTS = ((32, 3), (20, 2), (32, 4), (16, 3), (32, 1))
# ops that read a device value to the host
SYNC_OPS = ("aten._local_scalar_dense", "aten.item", "aten.equal", "aten.is_nonzero",
            "aten.nonzero")


@pytest.fixture(autouse=True)
def fresh():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = dataclasses.replace(get_smoke(request.param), attn_impl="pallas")
    return cfg, model_for(cfg).init(torch.Generator().manual_seed(0))


class OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func).rsplit(".", 1)[0]] += 1
        return func(*args, **(kwargs or {}))


def _serve(model, traced: bool, log: OpLog | None = None):
    """Serve ``REQUESTS`` (arrived 0.25 s apart, the first 1 s ago); the
    requests, the tracer's export, and the arrival of each rid."""
    cfg, params = model
    obs.reset()
    if traced:
        obs.enable()
    eng = ServeEngine(cfg, max_batch=2, device="cpu")
    eng.set_params(params)
    rng = np.random.default_rng(1)
    now = time.monotonic()
    arrival = {}
    for i, (n, new) in enumerate(REQUESTS):
        t = now - 1.0 + 0.25 * i
        arrival[eng.submit(rng.integers(0, cfg.vocab_size, n), new, arrival=t)] = t
    with log if log is not None else torch.no_grad():
        while eng.queue:
            eng.step_batch()
    obs.disable()
    return eng.done, obs.export(), arrival


def test_tracing_leaves_the_tokens_alone(model):
    off, ex_off, _ = _serve(model, False)
    on, ex_on, _ = _serve(model, True)
    assert [r.out_tokens for r in on] == [r.out_tokens for r in off]
    assert [len(r.out_tokens) for r in on] == [new for _, new in REQUESTS]
    assert ex_off["spans"] == [] and ex_off["counters"] == {}
    assert ex_on["spans"] and ex_on["dropped_spans"] == 0


def test_each_request_waits_in_one_queue_span_from_its_arrival(model):
    done, ex, arrival = _serve(model, True)
    queued = [s for s in ex["spans"] if s["name"] == "engine.queue"]
    assert sorted(s["attrs"]["rid"] for s in queued) == sorted(arrival)
    batches = {s["id"]: s for s in ex["spans"] if s["name"] == "engine.batch"}
    by_rid = {r.rid: r for r in done}
    for s in queued:
        assert s["start_ns"] == round(arrival[s["attrs"]["rid"]] * 1e9)
        batch = batches[s["parent"]]
        assert s["attrs"]["rid"] in batch["attrs"]["rids"]
        assert s["attrs"]["prompt_len"] == len(by_rid[s["attrs"]["rid"]].prompt)
        assert batch["start_ns"] <= s["end_ns"] <= batch["end_ns"]
    assert all(r.t_arrival == arrival[r.rid] for r in done)


def test_each_batch_has_one_prefill_and_its_decode_steps(model):
    cfg, _ = model
    done, ex, _ = _serve(model, True)
    spans = ex["spans"]
    kids = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append(s)
    batches = [s for s in spans if s["name"] == "engine.batch"]
    by_rid = {r.rid: r for r in done}
    assert sum(len(b["attrs"]["rids"]) for b in batches) == len(REQUESTS)
    for b in batches:
        reqs = [by_rid[rid] for rid in b["attrs"]["rids"]]
        budget = max(r.max_new_tokens for r in reqs)
        assert b["attrs"] == {"rids": [r.rid for r in reqs], "rows": len(reqs),
                              "padded_t": max(len(r.prompt) for r in reqs), "budget": budget}
        names = Counter(s["name"] for s in kids[b["id"]])
        assert names == Counter({"engine.queue": len(reqs), "engine.prefill": 1,
                                 "engine.decode_step": budget - 1})
        steps = [s for s in kids[b["id"]] if s["name"] == "engine.decode_step"]
        assert [s["attrs"]["k"] for s in steps] == list(range(1, budget))
        for s in steps:
            (child,) = kids[s["id"]]
            assert child["name"] == "model.decode_step"
            assert s["start_ns"] <= child["start_ns"] <= child["end_ns"] <= s["end_ns"]
        (pre,) = [s for s in kids[b["id"]] if s["name"] == "engine.prefill"]
        assert pre["attrs"] == {"rows": len(reqs), "padded_t": b["attrs"]["padded_t"]}
        attn = [s for s in spans if s["name"] == "kernels.flash_attention"
                and pre["start_ns"] <= s["start_ns"] <= pre["end_ns"]]
        hd = cfg.d_model // cfg.n_heads
        assert [s["attrs"] for s in attn] == [
            {"bh": len(reqs) * cfg.n_heads, "t": b["attrs"]["padded_t"], "hd": hd,
             "itemsize": 2}] * cfg.n_layers


def test_counters_equal_the_arithmetic(model, monkeypatch):
    cfg, _ = model
    kept_by_route = []
    real = moe.route_topk

    def route_topk(logits, k, capacity):  # the kept choices, counted apart
        out = real(logits, k, capacity)
        if capacity < logits.shape[-2]:  # prefill; decode's capacity is every token
            kept_by_route.append(int((out[0] < logits.shape[-1] * capacity).sum()))
        return out

    monkeypatch.setattr(moe, "route_topk", route_topk)
    done, ex, _ = _serve(model, True)
    c = ex["counters"]
    batches = [s["attrs"] for s in ex["spans"] if s["name"] == "engine.batch"]
    by_rid = {r.rid: r for r in done}
    assert c["engine.prompt_tokens"] == sum(len(r.prompt) for r in done)
    assert c["engine.prefill_tokens"] == sum(b["rows"] * b["padded_t"] for b in batches)
    if cfg.moe is None:
        assert not any(k.startswith("moe.") for k in c)
        return
    m = cfg.moe
    routes = [s["attrs"] for s in ex["spans"] if s["name"] == "moe.route"]
    prefill_tokens = [b["rows"] * b["padded_t"] for b in batches]
    assert [r["tokens"] for r in routes if r["tokens"] > 2] == [
        n for n in prefill_tokens for _ in range(cfg.n_layers)]
    choices = sum(prefill_tokens) * m.top_k * cfg.n_layers
    caps = [moe._capacity(n, m, 2) for n in prefill_tokens]
    assert c["moe.prefill_choices"] == choices
    assert c["moe.prefill_slots"] == sum(m.n_experts * cap for cap in caps) * cfg.n_layers
    assert len(kept_by_route) == len(batches) * cfg.n_layers
    assert c["moe.prefill_kept"] == sum(kept_by_route)
    dropped = choices - sum(kept_by_route)
    assert 0 < dropped and c["moe.prefill_kept"] + dropped == choices
    assert all(by_rid[rid].out_tokens for b in batches for rid in b["rids"])


def test_per_shard_routing_counts_every_shard():
    """Under a mesh whose data axes split the tokens, the route span and the
    counters cover every shard's capacity slice."""
    cfg = get_smoke("granite_moe_1b")
    gen = torch.Generator().manual_seed(1)
    p = moe.init_moe(gen, cfg)
    x = torch.randn(4, 16, cfg.d_model, generator=gen)
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    obs.enable()
    with sharding_context(mesh, ShardingRules(cfg, mesh).logical_mapping()):
        y, _ = moe.apply_moe(p, x, cfg)
    ex = obs.export()
    m, dp, n_tok = cfg.moe, 4, 64
    cap = moe._capacity(n_tok // dp, m, 16)
    (route,) = [s for s in ex["spans"] if s["name"] == "moe.route"]
    assert route["attrs"] == {"tokens": n_tok, "capacity": cap, "shards": dp}
    c = ex["counters"]
    assert c["moe.prefill_choices"] == n_tok * m.top_k
    assert c["moe.prefill_slots"] == m.n_experts * dp * cap
    assert 0 < c["moe.prefill_kept"] <= min(c["moe.prefill_choices"], c["moe.prefill_slots"])
    assert torch.isfinite(y).all()


def test_op_log_holds_only_the_counters_when_on(model):
    cfg, _ = model
    off_log, on_log = OpLog(), OpLog()
    with profile(activities=[ProfilerActivity.CPU]):  # a profiler, yet no range when off
        off, _, _ = _serve(model, False, off_log)
    on, ex, _ = _serve(model, True, on_log)
    assert [r.out_tokens for r in on] == [r.out_tokens for r in off]
    assert not any(op.startswith("profiler.") for op in off_log.ops)
    extra, missing = on_log.ops - off_log.ops, off_log.ops - on_log.ops
    assert not missing
    routes = sum(1 for s in ex["spans"] if s["name"] == "moe.route" and s["attrs"]["tokens"] > 2)
    if cfg.moe is None:
        assert extra == Counter()
    else:  # one reduction per prefill routing call, all but the first added in place
        assert routes and extra == {"aten.sum": routes, "aten.add_": routes - 1}
    for op in SYNC_OPS:
        assert on_log.ops[op] == off_log.ops[op], op


def test_op_log_under_a_profiler_adds_the_span_ranges(model):
    """With a profiler recording, each span of the tracer's is one range,
    and the profile has one anchor range besides."""
    on_log = OpLog()
    with profile(activities=[ProfilerActivity.CPU]):
        _, ex, _ = _serve(model, True, on_log)
    ranges = sum(1 for s in ex["spans"] if s["name"] != "engine.queue") + 1
    assert on_log.ops["profiler._record_function_enter_new"] == ranges
    assert on_log.ops["profiler._record_function_exit"] == ranges
