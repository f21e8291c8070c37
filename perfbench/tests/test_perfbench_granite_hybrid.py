"""granite4_h_small's plain reference (``reference/granite_hybrid.py``), its
configuration file and its work arithmetic (``flops_hybrid.py``) against the
port: on the SMOKE configuration in float32, prefill logits, logits decoded
through the conv, SSM and KV caches after left-padded prompts of unequal
length, and the engine's greedy tokens; the parameter tree and count; the
file against the published ``CONFIG``; the first-token operations against
the reference's matrix products."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import flops_hybrid
from perfbench.reference import granite_hybrid as ref
from perfbench.tests.smoke import REPO

PARAMETERS = 8_360_118_912
# Both sides compute in float32 and differ only in the order of their sums:
# the port's SSD is the chunked algebra (chunk 16, a state handed between
# chunks), the reference's the step-by-step recurrence; attention's online
# softmax against a whole-row softmax.  Over 10 layers that reads ~1e-6 of the
# largest logit; 1e-5 leaves room, and the port in bf16 reads ~0.09 of it.
F32_TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """These models are small: one intra-op thread each, so that a test
    beside other test processes does not wait on idle threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _smoke() -> dict:
    from repro_torch.configs import get_smoke

    mc = dataclasses.asdict(get_smoke("granite4_h_small"))
    mc.update(compute_dtype="float32", attn_impl="pallas")
    return mc


def _port(mc: dict):
    from perfbench.drivers.serve import port_config

    return port_config(mc)


def _file() -> dict:
    return json.loads((REPO / "perfbench/configs/granite4_h_small.json").read_text())


def _padded(lens, t, seed, vocab):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), t), np.int64)
    for i, n in enumerate(lens):
        toks[i, t - n:] = rng.integers(1, vocab, n)
    return torch.from_numpy(toks)


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _shapes(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _shapes(sub, f"{prefix}/{i}").items()}
    return {prefix: (tuple(tree.shape), tree.dtype)}


def test_param_tree_and_count_are_the_ports():
    from repro_torch.models import model_for
    from repro_torch.models.params import MetaGenerator

    mc = _smoke()
    ours = ref.make_params(mc, 3, "cpu")
    theirs = model_for(_port(mc)).init(torch.Generator().manual_seed(0))
    assert _shapes(ours) == _shapes(theirs)
    assert ref.param_count(mc) == _port(mc).param_count()
    # the benchmark's model, on meta tensors: the same tree, the same count
    full = _file()["model"]
    meta = model_for(_port(full)).init(MetaGenerator())
    shapes = {k: s for k, (s, _) in _shapes(meta).items()}
    assert shapes == {"/" + "/".join(map(str, path)): shape
                      for path, shape, _ in ref.leaf_shapes(full)}
    assert ref.param_count(full) == _port(full).param_count() == _file()["parameters"] == PARAMETERS


def test_file_is_the_published_config_but_depth_and_attn_impl():
    from repro_torch.configs import get

    published = get("granite4_h_small").CONFIG
    f = _file()
    ours = _port(f["model"])
    assert ours.n_layers == 10 and ours.attn_impl == "pallas"
    assert dataclasses.replace(ours, n_layers=published.n_layers,
                               attn_impl=published.attn_impl) == published
    # the source's own keys, as the file states them
    assert (f["hidden_size"], f["num_attention_heads"], f["num_key_value_heads"],
            f["num_local_experts"], f["num_experts_per_tok"], f["intermediate_size"],
            f["shared_intermediate_size"], f["vocab_size"], f["num_hidden_layers"]) == (
        ours.d_model, ours.n_heads, ours.n_kv_heads, ours.moe.n_experts, ours.moe.top_k,
        ours.moe.d_expert, ours.moe.d_expert * ours.moe.n_shared, ours.vocab_size, ours.n_layers)
    assert (f["mamba_n_heads"], f["mamba_d_head"], f["mamba_d_state"], f["mamba_n_groups"],
            f["mamba_d_conv"], f["mamba_chunk_size"], f["mamba_conv_bias"]) == (
        ours.ssm.n_heads, ours.ssm.head_dim, ours.ssm.d_state, ours.ssm.n_groups,
        ours.ssm.conv_width, ours.ssm.chunk, ours.ssm.conv_bias)
    assert (f["embedding_multiplier"], f["attention_multiplier"], f["residual_multiplier"],
            f["logits_scaling"]) == (ours.embedding_multiplier, ours.attention_multiplier,
                                     ours.residual_multiplier, ours.logits_scaling)
    assert f["layer_types"] == ["attention" if s.mixer == "attn" else "mamba"
                                for s in ours.layer_specs()]
    assert f["position_embedding_type"] == "nope" and ours.rope_pct == 0


def test_prefill_and_decode_through_the_caches():
    from repro_torch.models import model_for

    mc = _smoke()
    params = ref.make_params(mc, 11, "cpu")
    model = model_for(_port(mc))
    t, n_new = 64, 5
    prompts = _padded([48, 29, 64, 40], t, 1, mc["vocab_size"])
    logits, cache = model.prefill(params, {"tokens": prompts}, cache_len=t + n_new)
    got, fed = [logits[:, -1]], []
    last = logits[:, -1].argmax(-1)
    for k in range(1, n_new):
        fed.append(last)
        logits, cache = model.decode_step(
            params, {"tokens": last[:, None].to(torch.int32), "pos": t + k - 1}, cache)
        got.append(logits[:, -1])
        last = logits[:, -1].argmax(-1)
    got = torch.stack(got, dim=1)
    want = ref.served_logits(mc, params, prompts, torch.stack(fed, dim=1))
    assert want.shape == got.shape
    scale = want.abs().max()
    assert (got - want).abs().max() <= F32_TOL * scale


def test_prefill_logits_at_every_position():
    """The reference routes the tokens after its prompt without a capacity,
    so a capacity that drops nothing lets every prompt position compare."""
    from repro_torch.models import model_for

    mc = _smoke()
    mc["moe"] = dict(mc["moe"], capacity_factor=mc["moe"]["n_experts"] / mc["moe"]["top_k"])
    params = ref.make_params(mc, 13, "cpu")
    prompts = _padded([64, 37], 64, 4, mc["vocab_size"])
    got, _ = model_for(_port(mc)).prefill(params, {"tokens": prompts})
    want = ref.served_logits(mc, params, prompts[:, :1], prompts[:, 1:])
    assert want.shape == got.shape
    assert (got - want).abs().max() <= F32_TOL * want.abs().max()


def test_engine_greedy_tokens_are_the_references_first_choice():
    from repro_torch.serving.engine import ServeEngine

    mc = _smoke()
    params = ref.make_params(mc, 5, "cpu")
    eng = ServeEngine(_port(mc), max_batch=4, device="cpu")
    eng.set_params(params)
    lens, news = [40, 64, 17], [3, 6, 2]
    prompts = _padded(lens, 64, 2, mc["vocab_size"])
    for row, n, m in zip(prompts, lens, news):
        eng.submit(row[64 - n:].numpy().astype(np.int32), m)
    reqs = eng.step_batch()
    gen = torch.zeros((3, max(news) - 1), dtype=torch.long)
    for i, r in enumerate(reqs):
        assert len(r.out_tokens) == news[i]
        gen[i, :news[i] - 1] = torch.tensor(r.out_tokens[:-1])
    want = ref.served_logits(mc, params, prompts, gen)
    for i, r in enumerate(reqs):
        served = want[i, :news[i]].gather(1, torch.tensor(r.out_tokens)[:, None])[:, 0]
        assert (want[i, :news[i]].max(-1).values - served).max() <= F32_TOL * want.abs().max()


def test_the_state_carries_across_chunks():
    """The drawn dt and A keep part of a head's state over a whole chunk, so
    tokens of an earlier chunk move a later chunk's logits."""
    mc = _smoke()
    params = ref.make_params(mc, 7, "cpu")
    a = _padded([64], 64, 3, mc["vocab_size"])
    b = a.clone()
    b[0, :16] = (b[0, :16] + 1) % mc["vocab_size"]  # the first chunk only
    layer = params["stages"][0]
    # no attention: only the Mamba2 layers carry the first chunk forward
    mc_ssm = dict(mc, attn_every=10, attn_offset=11, n_layers=10)
    params_ssm = dict(params, stages=[tuple(
        dict(lyr, mamba=layer[0]["mamba"]) if "attn" in lyr else lyr for lyr in layer)])
    gen = torch.zeros((1, 0), dtype=torch.long)
    la = ref.served_logits(mc_ssm, params_ssm, a, gen)
    lb = ref.served_logits(mc_ssm, params_ssm, b, gen)
    assert (la - lb).abs().max() > 1e-3 * la.abs().max()
    dt = torch.nn.functional.softplus(layer[0]["mamba"]["dt_bias"])
    assert 1e-3 * (1 - 1e-4) <= dt.min() and dt.max() <= 0.1 * (1 + 1e-4)
    assert (layer[0]["mamba"]["A_log"].exp() - 8.5).abs().max() <= 7.5


def test_fp8_control_moves_the_logits():
    mc = _smoke()
    params = ref.make_params(mc, 4, "cpu")
    prompts = _padded([64, 50], 64, 3, mc["vocab_size"])
    gen = torch.zeros((2, 2), dtype=torch.long)
    full = ref.served_logits(mc, params, prompts, gen)
    low = ref.served_logits(mc, params, prompts, gen, quant="fp8")
    err = (full - low).abs().max() / full.abs().max()
    assert 1e-2 < err < 1.0


def test_first_token_flops_against_the_references_matrix_products():
    """With a capacity that drops nothing, the reference's products are the
    benchmark's count but for three parts: it computes attention's full
    causal square where the count takes the half a causal kernel needs, its
    recurrence computes no chunk's lower triangles, and the count leaves the
    depthwise convolutions out (elementwise work; the counter takes each as
    2·W products an output, over the W - 1 padded outputs too)."""
    mc = _smoke()
    mc["moe"] = dict(mc["moe"], capacity_factor=mc["moe"]["n_experts"] / mc["moe"]["top_k"])
    length = 48  # three chunks of 16
    params = ref.make_params(mc, 1, "cpu")
    prompt = torch.randint(1, mc["vocab_size"], (1, length))
    with FlopCounterMode(display=False) as counter:
        ref.served_logits(mc, params, prompt, torch.zeros((1, 0), dtype=torch.long))
    n_attn, n_mamba = flops_hybrid.layer_counts(mc)
    assert (n_attn, n_mamba) == (1, 9)
    half_square = n_attn * 2 * mc["n_heads"] * (mc["d_model"] // mc["n_heads"]) * length ** 2
    s = mc["ssm"]
    triangles = n_mamba * s["n_heads"] * 3 * 16 ** 2 * (s["d_state"] + s["head_dim"])
    conv = n_mamba * 2 * (s["n_heads"] * s["head_dim"] + 2 * s["d_state"]) * (length + 3) * 4
    assert counter.get_total_flops() == \
        flops_hybrid.first_token_flops(mc, length) + half_square - triangles + conv
