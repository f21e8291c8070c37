"""The plain reference against the port's CPU path at small widths of both
families: prefill logits, logits decoded through the cache, and the engine's
greedy tokens, all in float32."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from perfbench.reference import decoder
from perfbench.tests.smoke import DENSE, MOE

CONFIGS = {"dense": DENSE, "moe": MOE}


def _port(mc: dict):
    from perfbench.drivers.serve import port_config

    return dataclasses.replace(port_config(mc), compute_dtype="float32", attn_impl="full")


def _padded(lens, t, seed, vocab):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), t), np.int64)
    for i, n in enumerate(lens):
        toks[i, t - n:] = rng.integers(1, vocab, n)
    return torch.from_numpy(toks)


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_param_tree_is_the_ports(family):
    from repro_torch.models import model_for

    mc = CONFIGS[family]
    ours = decoder.make_params(mc, 3, "cpu")
    theirs = model_for(_port(mc)).init(torch.Generator().manual_seed(0))

    def shapes(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items() for k, v in shapes(sub, f"{prefix}/{key}").items()}
        if isinstance(tree, (list, tuple)):
            return {k: v for i, sub in enumerate(tree) for k, v in shapes(sub, f"{prefix}/{i}").items()}
        return {prefix: (tuple(tree.shape), tree.dtype)}

    assert shapes(ours) == shapes(theirs)
    assert decoder.param_count(mc) == _port(mc).param_count()


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_prefill_and_decode_through_the_cache(family):
    from repro_torch.models import model_for

    mc = CONFIGS[family]
    params = decoder.make_params(mc, 11, "cpu")
    model = model_for(_port(mc))
    prompts = _padded([256, 128, 384, 256], 384, 1, mc["vocab_size"])
    n_new = 5
    logits, cache = model.prefill(params, {"tokens": prompts}, cache_len=384 + n_new)
    got = [logits[:, -1]]
    last = logits[:, -1].argmax(-1)
    fed = []
    for k in range(1, n_new):
        fed.append(last)
        logits, cache = model.decode_step(
            params, {"tokens": last[:, None].to(torch.int32), "pos": 384 + k - 1}, cache)
        got.append(logits[:, -1])
        last = logits[:, -1].argmax(-1)
    got = torch.stack(got, dim=1)
    want = decoder.served_logits(mc, params, prompts, torch.stack(fed, dim=1))
    assert want.shape == got.shape
    scale = want.abs().max()
    assert (got - want).abs().max() <= 2e-5 * scale


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_engine_greedy_tokens_are_the_references_first_choice(family):
    from repro_torch.serving.engine import ServeEngine

    mc = CONFIGS[family]
    params = decoder.make_params(mc, 5, "cpu")
    eng = ServeEngine(_port(mc), max_batch=4, device="cpu")
    eng.set_params(params)
    lens, news = [128, 256, 384], [3, 6, 2]
    prompts = _padded(lens, 384, 2, mc["vocab_size"])
    for row, n, m in zip(prompts, lens, news):
        eng.submit(row[384 - n:].numpy().astype(np.int32), m)
    reqs = eng.step_batch()
    gen = torch.zeros((3, max(news) - 1), dtype=torch.long)
    for i, r in enumerate(reqs):
        assert len(r.out_tokens) == news[i]
        gen[i, :news[i] - 1] = torch.tensor(r.out_tokens[:-1])
    want = decoder.served_logits(mc, params, prompts, gen)
    for i, r in enumerate(reqs):
        served = want[i, :news[i]].gather(1, torch.tensor(r.out_tokens)[:, None])[:, 0]
        assert (want[i, :news[i]].max(-1).values - served).max() <= 1e-5 * want.abs().max()


def test_moe_capacity_drops_are_exercised(monkeypatch):
    """At the smoke widths the prompt's routing overflows some expert in some
    layer, so the comparisons above cover the capacity drops."""
    drops = []
    real = decoder._route

    def route(*args):
        gate, eid, keep = real(*args)
        drops.append(int((~keep).sum()))
        return gate, eid, keep

    monkeypatch.setattr(decoder, "_route", route)
    mc = MOE
    params = decoder.make_params(mc, 11, "cpu")
    prompts = _padded([256, 128, 384, 256], 384, 1, mc["vocab_size"])
    decoder.served_logits(mc, params, prompts, torch.zeros((4, 2), dtype=torch.long))
    assert len(drops) == mc["n_layers"] and sum(drops) > 0


def test_fp8_control_moves_the_logits():
    mc = DENSE
    params = decoder.make_params(mc, 4, "cpu")
    prompts = _padded([256], 256, 3, mc["vocab_size"])
    gen = torch.zeros((1, 2), dtype=torch.long)
    full = decoder.served_logits(mc, params, prompts, gen)
    low = decoder.served_logits(mc, params, prompts, gen, quant="fp8")
    err = (full - low).abs().max() / full.abs().max()
    assert 1e-3 < err < 0.5
