"""granite4_h_small's parts of the port on the CPU: Granite's scalars against
a hand computation, NoPE, the Mamba2 conv biases in prefill and decode, the
router's expert positions at (E 72, k 10), the hybrid's spans and counters,
and the neutral defaults, which add no op to deepseek_7b's and
granite_moe_1b's programs.  The plain reference and
the benchmark's files are held against the port in
``perfbench/tests/test_perfbench_granite_hybrid.py``.  The ``cuda``-marked
test holds the expert-position kernel against its plain version at the
cell's full batch; this file imports nothing of the JAX package."""
import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import obs
from repro_torch.configs import ModelConfig, get, get_smoke
from repro_torch.kernels import moe_route
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, model_for, moe, transformer
from repro_torch.models.layers import rope_freqs
from repro_torch.models.params import tree_leaves_with_path
from repro_torch.serving.engine import ServeEngine

SMOKE = get_smoke("granite4_h_small")
F32_SMOKE = dataclasses.replace(SMOKE, compute_dtype="float32")


class OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func).rsplit(".", 1)[0]] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(autouse=True)
def fresh_tracer():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def test_parameter_counts():
    cfg = get("granite4_h_small").CONFIG
    assert cfg.param_count() == 32_207_337_984
    assert dataclasses.replace(cfg, n_layers=10).param_count() == 8_360_118_912
    assert [s.mixer for s in cfg.layer_specs()].count("attn") == 4
    assert [i for i, s in enumerate(cfg.layer_specs()) if s.mixer == "attn"] == [5, 15, 25, 35]
    assert {s.ffn for s in cfg.layer_specs()} == {"moe"}


def test_moe_and_ssm_mappings_become_their_configs():
    kw = dataclasses.asdict(SMOKE)
    assert isinstance(kw["moe"], dict) and isinstance(kw["ssm"], dict)
    cfg = ModelConfig(**kw)
    assert cfg == SMOKE and hash(cfg) == hash(SMOKE)
    assert transformer.build_stages(cfg) == transformer.build_stages(SMOKE)


# ----------------------------------------------------------------------
# neutral defaults: the programs of the benchmark's other cells unchanged
# ----------------------------------------------------------------------
NEUTRAL_CASES = [(a, d) for a in ("deepseek_7b", "granite_moe_1b") for d in ("float32", "bfloat16")]
SCALAR_OPS = {"embedding_multiplier": (2.0, "aten.mul"), "residual_multiplier": (0.5, "aten.mul"),
              "logits_scaling": (4.0, "aten.div")}


def _prefill_and_two_steps(cfg):
    """The ops recorded over a prefill of 2 x 32 tokens and two decode steps,
    and the three calls' logits."""
    model = model_for(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(1, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(1))
    log, outs = OpLog(), []
    with log:
        logits, cache = model.prefill(params, {"tokens": toks}, cache_len=36)
        outs.append(logits)
        for k in range(2):
            last = logits[:, -1].argmax(-1)
            logits, cache = model.decode_step(
                params, {"tokens": last[:, None].to(torch.int32), "pos": 32 + k}, cache)
            outs.append(logits)
    return log.ops, outs


@pytest.mark.parametrize("arch,dtype", NEUTRAL_CASES)
def test_neutral_defaults_leave_ops_and_logits_as_they_were(arch, dtype):
    """At their defaults Granite's scalars launch nothing: setting one adds
    its own products and no other op (in each of the three calls: one for the
    embedding, one per residual branch, one division of the logits), and the
    attention scale's default is hd^-0.5 to the bit."""
    cfg = dataclasses.replace(get_smoke(arch), attn_impl="pallas", compute_dtype=dtype)
    ops, outs = _prefill_and_two_steps(cfg)
    branches = sum(1 + (s.ffn != "none") for s in cfg.layer_specs())
    per_call = {"embedding_multiplier": 1, "residual_multiplier": branches, "logits_scaling": 1}
    for field, (value, op) in SCALAR_OPS.items():
        got, _ = _prefill_and_two_steps(dataclasses.replace(cfg, **{field: value}))
        assert got - ops == Counter({op: 3 * per_call[field]}) and not ops - got, field
    got, same = _prefill_and_two_steps(dataclasses.replace(cfg, attention_multiplier=cfg.hd ** -0.5))
    assert got == ops
    assert all(torch.equal(a, b) for a, b in zip(outs, same))


# ----------------------------------------------------------------------
# Granite's scalars against a hand computation
# ----------------------------------------------------------------------
ONE_LAYER = ModelConfig(name="one", family="dense", n_layers=1, d_model=32, n_heads=4,
                        n_kv_heads=2, d_ff=48, vocab_size=64, rope_pct=0.0,
                        compute_dtype="float32", attn_impl="full")
MULTIPLIERS = {"embedding_multiplier": 12.0, "attention_multiplier": 1 / 128,
               "residual_multiplier": 0.22, "logits_scaling": 16.0}


def _rms(x, g):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * g


def _by_hand(cfg, params, toks):
    """One dense NoPE layer written out: embed x e, scores x a, branches x r,
    logits / s."""
    em, am = cfg.embedding_multiplier, cfg.attention_multiplier or cfg.hd ** -0.5
    rm, ls = cfg.residual_multiplier, cfg.logits_scaling
    table = params["embed"]["table"]
    (p,) = params["stages"][0]
    b, t = toks.shape
    x = table[toks] * em
    a = _rms(x, p["norm1"]["scale"])
    q = torch.einsum("btd,dhk->bhtk", a, p["attn"]["wq"])
    k = torch.einsum("btd,dhk->bhtk", a, p["attn"]["wk"]).repeat_interleave(2, dim=1)
    v = torch.einsum("btd,dhk->bhtk", a, p["attn"]["wv"]).repeat_interleave(2, dim=1)
    s = (q @ k.transpose(-1, -2)) * am
    s = s.masked_fill(torch.ones(t, t, dtype=torch.bool).triu(1), float("-inf"))
    o = torch.einsum("bhtk,hkd->btd", torch.softmax(s, -1) @ v, p["attn"]["wo"])
    x = x + rm * o
    a = _rms(x, p["norm2"]["scale"])
    m = p["mlp"]
    x = x + rm * ((F.silu(a @ m["w_gate"]) * (a @ m["w_up"])) @ m["w_out"])
    return (_rms(x, params["final_norm"]["scale"]) @ params["lm_head"]["w"]) / ls


@pytest.mark.parametrize("which", [*MULTIPLIERS, "all", "none"])
def test_multiplier_against_a_hand_computation(which):
    kw = MULTIPLIERS if which == "all" else {} if which == "none" else {which: MULTIPLIERS[which]}
    cfg = dataclasses.replace(ONE_LAYER, **kw)
    model = model_for(cfg)
    params = model.init(torch.Generator().manual_seed(3))
    params["stages"][0][0]["norm1"]["scale"].uniform_(0.5, 1.5)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(4))
    got, _ = model.prefill(params, {"tokens": toks})
    want = _by_hand(cfg, params, toks)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6 * want.abs().max().item())
    # the scale reaches the decode path too: one step against the prefill of T + 1
    full, _ = model.prefill(params, {"tokens": toks})
    _, cache = model.prefill(params, {"tokens": toks[:, :-1]}, cache_len=12)
    step, _ = model.decode_step(params, {"tokens": toks[:, -1:].to(torch.int32), "pos": 11}, cache)
    assert torch.allclose(step[:, 0], full[:, -1], rtol=1e-5, atol=1e-6 * full.abs().max().item())


# ----------------------------------------------------------------------
# NoPE
# ----------------------------------------------------------------------
def test_nope_leaves_q_and_k_untouched_and_launches_nothing(monkeypatch):
    """With ``rope_pct`` 0 the forward hands ``qkv_proj`` no frequencies, and
    the projection launches its three products and nothing else."""
    seen = []
    real = attn.qkv_proj

    def spy(p, x, cfg, positions, inv_freq):
        seen.append(inv_freq)
        return real(p, x, cfg, positions, inv_freq)

    monkeypatch.setattr(attn, "qkv_proj", spy)
    model = model_for(ONE_LAYER)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, 64, (2, 8), generator=torch.Generator().manual_seed(1))
    whole = OpLog()
    with whole:
        transformer.forward(params, ONE_LAYER, {"tokens": toks}, mode="prefill")
    assert seen == [None] and not {"aten.cos", "aten.sin"} & set(whole.ops)
    assert len(rope_freqs(ONE_LAYER.hd, ONE_LAYER.rope_theta, ONE_LAYER.rope_pct)) == 0

    p = params["stages"][0][0]["attn"]
    x = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(2))
    pos = torch.arange(8)[None].expand(2, 8)
    proj, plain = OpLog(), OpLog()
    with proj:
        q, k, v = real(p, x, ONE_LAYER, pos, None)
    with plain:
        want = [torch.einsum("btd,dhk->bhtk", x, p[w]) for w in ("wq", "wk", "wv")]
    assert proj.ops == plain.ops
    assert all(torch.equal(a, b) for a, b in zip((q, k, v), want))


# ----------------------------------------------------------------------
# conv biases
# ----------------------------------------------------------------------
def test_causal_conv_and_conv_step_add_the_bias():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 9, 5, generator=gen)
    kern, bias = torch.randn(4, 5, generator=gen), torch.randn(5, generator=gen)
    pad = torch.cat([torch.zeros(2, 3, 5), x], 1)
    want = torch.stack([sum(pad[:, t + i] * kern[i] for i in range(4)) for t in range(9)], 1)
    assert torch.allclose(mamba2.causal_conv(x, kern, bias), want + bias, atol=1e-6)
    assert torch.allclose(mamba2.causal_conv(x, kern), want, atol=1e-6)
    y, state = mamba2.conv_step(x[:, 8], x[:, 5:8], kern, bias)
    assert torch.allclose(y, want[:, 8] + bias, atol=1e-6)
    assert torch.equal(state, x[:, 6:9])  # the raw inputs, not the biased outputs


def test_conv_biases_in_prefill_and_decode():
    """With the biases drawn, decoding the last token through the prefill's
    conv and SSM caches gives the prefill's own last output, and the biases
    change it."""
    # a capacity that drops nothing, so the prefill of T and of T - 1 route alike
    cfg = dataclasses.replace(F32_SMOKE, moe=dataclasses.replace(SMOKE.moe, capacity_factor=4.0))
    model = model_for(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    biased = 0
    for path, leaf in tree_leaves_with_path(params):
        if path[-1].startswith("conv_") and path[-1].endswith("_bias"):
            leaf.normal_(generator=torch.Generator().manual_seed(len(path) + biased))
            biased += 1
    assert biased == 3 * 9
    toks = torch.randint(1, cfg.vocab_size, (2, 37), generator=torch.Generator().manual_seed(2))
    full, _ = model.prefill(params, {"tokens": toks})
    _, cache = model.prefill(params, {"tokens": toks[:, :-1]}, cache_len=40)
    step, _ = model.decode_step(params, {"tokens": toks[:, -1:].to(torch.int32), "pos": 36},
                                cache)
    assert torch.allclose(step[:, 0], full[:, -1], rtol=1e-4, atol=1e-5 * full.abs().max().item())
    for path, leaf in tree_leaves_with_path(params):
        if path[-1].startswith("conv_") and path[-1].endswith("_bias"):
            leaf.zero_()
    plain, _ = model.prefill(params, {"tokens": toks})
    assert not torch.allclose(plain, full, atol=1e-3 * full.abs().max().item())


# ----------------------------------------------------------------------
# the router's expert positions at (E 72, k 10)
# ----------------------------------------------------------------------
def _ids(n: int, e: int, k: int, seed: int, device="cpu") -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((1, n, e), generator=gen, device=device).topk(k, -1).indices.to(torch.int32)


def _counted(ids: torch.Tensor, e: int, capacity: int) -> torch.Tensor:
    """Slots by counting each expert's earlier choices, one choice at a time."""
    seen = [0] * e
    out = []
    for x in ids.reshape(-1).tolist():
        out.append(x * capacity + seen[x] if seen[x] < capacity else e * capacity)
        seen[x] += 1
    return torch.tensor(out, dtype=torch.int32).reshape(ids.shape)


def test_expert_positions_at_72_experts_top_10():
    m = get("granite4_h_small").CONFIG.moe
    ids = _ids(600, m.n_experts, m.top_k, seed=5)
    cap = moe._capacity(600, m, t=2)
    got = moe_route.expert_slots(ids, m.n_experts, cap)
    assert torch.equal(got, _counted(ids, m.n_experts, cap))
    assert torch.equal(got, moe_route.expert_slots_torch(ids, m.n_experts, cap))
    moe_route.check_kernel_operands(ids, m.n_experts, cap)
    skew = torch.arange(m.top_k, dtype=torch.int32).expand(1, 600, m.top_k).contiguous()
    dropped = moe_route.expert_slots(skew, m.n_experts, cap) == m.n_experts * cap
    assert torch.equal(dropped, _counted(skew, m.n_experts, cap) == m.n_experts * cap)
    assert int(dropped.sum()) == 600 * m.top_k - m.top_k * cap


@pytest.mark.cuda
def test_expert_positions_kernel_at_the_cells_full_batch():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    m = get("granite4_h_small").CONFIG.moe
    n = 16_384  # 4 rows x 4,096 tokens
    cap = moe._capacity(n, m, t=2)
    for ids in (_ids(n, m.n_experts, m.top_k, seed=7, device="cuda"),
                torch.arange(m.top_k, dtype=torch.int32, device="cuda").expand(1, n, m.top_k)
                .contiguous()):
        moe_route.reset_launches()
        got = moe_route.expert_slots(ids, m.n_experts, cap)
        torch.cuda.synchronize()
        assert moe_route.expert_slots.launches == 1
        assert torch.equal(got, moe_route.expert_slots_torch(ids, m.n_experts, cap))


# ----------------------------------------------------------------------
# the hybrid's spans and counters
# ----------------------------------------------------------------------
MAMBA_LAYERS = sum(1 for s in SMOKE.layer_specs() if s.mixer == "mamba")


def _serve(traced: bool, lens=(40, 24, 33), new=3, cfg=SMOKE):
    if traced:
        obs.enable()
    eng = ServeEngine(cfg, max_batch=4, device="cpu")
    eng.set_params(model_for(cfg).init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    for n in lens:
        eng.submit(rng.integers(1, cfg.vocab_size, n), new)
    caches = []
    real = eng.model.prefill

    def prefill(params, batch, cache_len=None):
        out = real(params, batch, cache_len=cache_len)
        caches.append(out[1])
        return out

    eng.model = dataclasses.replace(eng.model, prefill=prefill)
    reqs = eng.step_batch()
    obs.disable()
    return reqs, obs.export(), caches[0]


@pytest.mark.parametrize("intra_dtype", ["f32", "bf16"])
def test_prefill_records_the_mamba_spans_with_their_attributes(intra_dtype):
    """With float32 intra-chunk tensors the output's SSD also gives the
    decode state (``keeps="both"``); with bf16 ones a state-only pass under
    ``mamba.prefill_state`` follows it."""
    cfg = dataclasses.replace(SMOKE, ssm=dataclasses.replace(SMOKE.ssm, intra_dtype=intra_dtype))
    _, ex, _ = _serve(True, cfg=cfg)
    spans = [s for s in ex["spans"] if s["name"].startswith("mamba.")]
    ssd = [s for s in spans if s["name"] == "mamba.ssd"]
    base = {"rows": 3, "t": 40, "heads": 16, "head_dim": 16, "d_state": 16, "chunk": 16}
    per_layer = ([dict(base, keeps="both")] if intra_dtype == "f32"
                 else [dict(base, keeps="output"), dict(base, keeps="state")])
    assert [s["attrs"] for s in ssd] == per_layer * MAMBA_LAYERS
    state = {s["id"]: s for s in spans if s["name"] == "mamba.prefill_state"}
    assert len(state) == MAMBA_LAYERS
    assert all((s["parent"] in state) == (s["attrs"]["keeps"] == "state") for s in ssd)
    steps = [s for s in spans if s["name"] == "mamba.step"]
    assert len(steps) == 2 * MAMBA_LAYERS  # budget 3: two decode steps
    prefill = next(s for s in ex["spans"] if s["name"] == "engine.prefill")
    assert all(prefill["start_ns"] <= s["start_ns"] <= s["end_ns"] <= prefill["end_ns"]
               for s in spans if s["name"] != "mamba.step")


def test_counters_equal_the_tokens_and_the_cache_bytes():
    _, ex, cache = _serve(True)
    c = ex["counters"]
    assert c["mamba.prefill_tokens"] == 3 * 40 * MAMBA_LAYERS
    ssm = kv = 0
    for layer in cache[0]:
        for key, t in layer.items():
            if key in ("k", "v"):
                kv += t.numel() * t.element_size()
            else:
                ssm += t.numel() * t.element_size()
    assert (c["cache.ssm_bytes"], c["cache.kv_bytes"]) == (ssm, kv)
    s = SMOKE.ssm
    assert ssm == MAMBA_LAYERS * 3 * (2 * 3 * (s.n_heads * s.head_dim + 2 * s.d_state)
                                      + 4 * s.n_heads * s.head_dim * s.d_state)
    assert kv == 2 * 3 * SMOKE.n_kv_heads * (40 + 3) * SMOKE.hd * 2


def test_tracer_off_records_nothing_and_serves_the_same_tokens():
    off, ex, _ = _serve(False)
    assert ex["spans"] == [] and ex["counters"] == {}
    on, _, _ = _serve(True)
    assert [r.out_tokens for r in on] == [r.out_tokens for r in off]
