"""The frozen work arithmetic against the configurations' published
parameter counts, the port's own counts, and the reference's matrix
products counted by ``FlopCounterMode``."""
from __future__ import annotations

import dataclasses
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import flops
from perfbench.reference import decoder
from perfbench.tests.smoke import DENSE, REPO

PUBLISHED = {"deepseek_7b": 6_910_365_696, "granite_moe_1b": 1_334_628_352}


def _config(name):
    return json.loads((REPO / f"perfbench/configs/{name}.json").read_text())


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_parameter_counts(name):
    mc = _config(name)["model"]
    assert flops.param_count(mc) == decoder.param_count(mc) == PUBLISHED[name]
    assert _config(name)["parameters"] == PUBLISHED[name]


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_configuration_is_the_ports_published_one(name):
    """Every model key of the file equals the port's published config, but
    ``attn_impl``: the deployment's K3 route, not a cut."""
    import importlib

    from perfbench.drivers.serve import port_config

    published = importlib.import_module(f"repro_torch.configs.{name}").CONFIG
    ours = port_config(_config(name)["model"])
    assert ours.attn_impl == "pallas"
    assert dataclasses.replace(ours, attn_impl=published.attn_impl) == published
    assert ours.param_count() == PUBLISHED[name]


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_per_token_work_is_twice_the_active_weights(name):
    mc = _config(name)["model"]
    d, v, layers = mc["d_model"], mc["vocab_size"], mc["n_layers"]
    from perfbench.drivers.serve import port_config

    active = port_config(mc).active_param_count()
    embed_head = v * d * (1 if mc["tie_embeddings"] else 2)
    norms = 2 * d * layers + d
    assert flops.token_linear_flops(mc) == 2 * (active - embed_head - norms)
    assert flops.head_flops(mc) == 2 * d * v


def test_first_token_flops_against_the_references_matrix_products():
    """The reference computes the full causal square; the benchmark counts
    the half a causal kernel needs."""
    mc, length = DENSE, 256
    params = decoder.make_params(mc, 1, "cpu")
    prompt = torch.randint(1, mc["vocab_size"], (1, length))
    with FlopCounterMode(display=False) as counter:
        decoder.served_logits(mc, params, prompt, torch.zeros((1, 0), dtype=torch.long))
    half = mc["n_layers"] * 2 * mc["n_heads"] * (mc["d_model"] // mc["n_heads"]) * length**2
    assert counter.get_total_flops() == flops.first_token_flops(mc, length) + half


def test_decode_and_flash_work():
    mc = _config("deepseek_7b")["model"]
    f, b = flops.decode_step_work(mc, [1000, 2000])
    kv = (1001 + 2001) * 30 * 2 * 32 * 128 * 2
    assert b == PUBLISHED["deepseek_7b"] * 2 + kv
    assert f == 2 * (flops.token_linear_flops(mc) + flops.head_flops(mc)) \
        + 30 * 4 * 32 * 128 * (1001 + 2001)
    assert flops.roofline_s(f, b) == b / flops.HBM_BYTES_PER_S  # a decode step is bytes-bound
    assert flops.flash_work(128, 512, 128, 2) == (2 * 128 * 512**2 * 128, 4 * 128 * 512 * 128 * 2)
