"""The Mamba2 prefill's decode cache, built from ``apply_mamba``'s own
tensors (``prefill_cache=True``), held bit for bit against the construction
it replaced, kept here verbatim as the oracle: ``_mamba_prefill_cache``,
which recomputed the projections and ran a second, float32 ``ssd_chunked``
for the final state, over ``_ssd_chunked_before``, the SSD as it was before
its preparation was shared with the state-only pass.

Every cache leaf and every logit is equal for granite4_h_small's smoke
config with float32 and bf16 intra-chunk tensors and for mamba2_130m's and
jamba_v01_52b's smoke configs, on prompts that are not whole chunks, one
step short of a chunk, and left-padded; greedy tokens through
``ServeEngine`` are equal; ``ssd_final_state`` equals ``ssd_chunked``'s
state; the counters say which way each layer's state came."""
import dataclasses
from typing import Optional

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs import get_smoke
from repro_torch.models import mamba2, model_for, transformer
from repro_torch.models.mamba2 import _segsum, causal_conv, ssd_span
from repro_torch.models.params import tree_leaves_with_path
from repro_torch.serving.engine import ServeEngine

_F32 = torch.float32
GRANITE = get_smoke("granite4_h_small")
CONFIGS = {
    "granite4_f32": GRANITE,
    "granite4_bf16": dataclasses.replace(
        GRANITE, ssm=dataclasses.replace(GRANITE.ssm, intra_dtype="bf16")),
    "mamba2_130m": get_smoke("mamba2_130m"),
    "jamba_v01_52b": get_smoke("jamba_v01_52b"),
}


@pytest.fixture(autouse=True)
def fresh_tracer():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


# ----------------------------------------------------------------------
# the oracle: the earlier construction, verbatim but for the SSD's name
# ----------------------------------------------------------------------
def _ssd_chunked_before(
    x: torch.Tensor,  # (B,T,H,P)
    dt: torch.Tensor,  # (B,T,H) — post-softplus
    A: torch.Tensor,  # (H,) negative
    Bm: torch.Tensor,  # (B,T,G,N)
    Cm: torch.Tensor,  # (B,T,G,N)
    *,
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B,H,P,N)
    intra_dtype: str = "f32",
) -> tuple[torch.Tensor, torch.Tensor]:
    b, t, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    nc = -(-t // chunk)
    pad = nc * chunk - t
    if pad:  # padded steps have dt = 0: no decay, no input
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    q = chunk
    # reshape to chunks: (B,nc,Q,...)
    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h).to(_F32)
    Bc = Bm.reshape(b, nc, q, g, n)
    Cc = Cm.reshape(b, nc, q, g, n)
    # broadcast groups to heads
    Bh = torch.repeat_interleave(Bc, rep, dim=3)  # (B,nc,Q,H,N)
    Ch = torch.repeat_interleave(Cc, rep, dim=3)

    a = dtc * A  # (B,nc,Q,H) log-decay per step
    a_cum = torch.cumsum(a, dim=2)  # within-chunk cumulative
    cdt = torch.bfloat16 if intra_dtype == "bf16" else _F32

    # 1) intra-chunk (diagonal blocks): Y = (L ∘ (C Bᵀ)) (dt·x)
    L = torch.exp(_segsum(a.permute(0, 1, 3, 2))).to(cdt)  # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqhn,bcshn->bchqs", Ch, Bh).to(cdt)
    dtx = (xc.to(_F32) * dtc[..., None]).to(cdt)  # (B,nc,Q,H,P)
    y_diag = torch.einsum("bchqs,bcshp->bcqhp", scores * L, dtx).to(_F32)

    # 2-4) inter-chunk pass: per chunk, y_off = C · exp(a_cum) · S_in and
    # S_out = S_c + exp(Σa) · S_in, with S_c built inside the loop
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum).to(cdt)  # (B,nc,Q,H)
    chunk_decay = torch.exp(a_cum[:, :, -1, :])  # (B,nc,H)
    decay_from_start = torch.exp(a_cum).to(cdt)  # (B,nc,Q,H)
    Bhc = Bh.to(cdt)
    Chc = Ch.to(cdt)

    s = (init_state.to(_F32) if init_state is not None
         else torch.zeros((b, h, p, n), dtype=_F32, device=x.device))
    y_off = []
    for ci in range(nc):
        y_off.append(torch.einsum("bqhn,bqh,bhpn->bqhp", Chc[:, ci],
                                  decay_from_start[:, ci], s.to(cdt)))
        s_c = torch.einsum("bqhn,bqh,bqhp->bhpn", Bhc[:, ci], decay_to_end[:, ci],
                           dtx[:, ci]).to(_F32)
        s = s_c + chunk_decay[:, ci][..., None, None] * s
    y_off = torch.stack(y_off, dim=1)  # (B,nc,Q,H,P) in cdt

    y = (y_diag + y_off.to(_F32)).reshape(b, nc * q, h, p)[:, :t]
    return y.to(x.dtype), s


def _mamba_prefill_cache(p, x_normed_in, cfg):
    """Build decode cache from a prefill pass (conv tail + final SSD state)."""
    s = cfg.ssm
    h, pd, g, n = s.n_heads, s.head_dim, s.n_groups, s.d_state
    dt_ = x_normed_in.dtype
    b, t, _ = x_normed_in.shape
    # recompute the projections (cheap relative to carrying them through)
    silu = torch.nn.functional.silu
    xs = silu(causal_conv(x_normed_in @ p["w_x"].to(dt_), p["conv_x"], p.get("conv_x_bias")))
    Bp = silu(causal_conv(x_normed_in @ p["w_B"].to(dt_), p["conv_B"], p.get("conv_B_bias")))
    Cp = silu(causal_conv(x_normed_in @ p["w_C"].to(dt_), p["conv_C"], p.get("conv_C_bias")))
    dt_v = torch.nn.functional.softplus(
        (x_normed_in @ p["w_dt"].to(dt_)).to(_F32) + p["dt_bias"]
    )
    A = -torch.exp(p["A_log"])
    with ssd_span(b, t, s, s.chunk, keeps="state"):
        _, final = _ssd_chunked_before(
            xs.reshape(b, t, h, pd), dt_v, A,
            Bp.reshape(b, t, g, n), Cp.reshape(b, t, g, n), chunk=s.chunk,
        )
    w = s.conv_width

    def tail(arr):  # the raw projections' last w - 1 steps, not the conv output
        return (x_normed_in @ arr.to(dt_))[:, -(w - 1):, :].contiguous()

    return {
        "conv_x": tail(p["w_x"]),
        "conv_B": tail(p["w_B"]),
        "conv_C": tail(p["w_C"]),
        "ssm": final,
    }


@pytest.fixture
def oracle(monkeypatch):
    """A function that puts the earlier construction in place: the model's
    SSD is ``_ssd_chunked_before`` and the prefill's decode cache comes from
    ``_mamba_prefill_cache``."""
    real = mamba2.apply_mamba

    def apply_mamba(p, x, cfg, *, cache=None, chunk=256, prefill_cache=False):
        y, new_cache = real(p, x, cfg, cache=cache, chunk=chunk)
        if prefill_cache:
            new_cache = _mamba_prefill_cache(p, x, cfg)
        return y, new_cache

    def on():
        monkeypatch.setattr(mamba2, "ssd_chunked", _ssd_chunked_before)
        monkeypatch.setattr(transformer, "apply_mamba", apply_mamba)

    return on


# ----------------------------------------------------------------------
# prefill: every cache leaf and every logit
# ----------------------------------------------------------------------
def _tokens(cfg, case: str) -> torch.Tensor:
    q = cfg.ssm.chunk
    rng = np.random.default_rng(7)
    if case == "ragged":  # two whole chunks and five steps
        return torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 2 * q + 5))).int()
    if case == "short":  # one step short of a chunk
        return torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, q - 1))).int()
    toks = rng.integers(1, cfg.vocab_size, (3, q + 3))  # left-padded, as ServeEngine pads
    toks[1, :q // 2] = 0
    toks[2, :q + 1] = 0
    return torch.from_numpy(toks).int()


def _prefill(cfg, tokens):
    model = model_for(cfg)
    params = model.init(torch.Generator().manual_seed(3))
    return model.prefill(params, {"tokens": tokens}, cache_len=tokens.shape[1] + 4)


@pytest.mark.parametrize("case", ["ragged", "short", "left_padded"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_cache_and_logits_equal_the_oracle(name, case, oracle):
    cfg = CONFIGS[name]
    tokens = _tokens(cfg, case)
    logits, cache = _prefill(cfg, tokens)
    oracle()
    want_logits, want_cache = _prefill(cfg, tokens)
    assert logits.dtype == want_logits.dtype and torch.equal(logits, want_logits)
    got, want = tree_leaves_with_path(cache), tree_leaves_with_path(want_cache)
    assert [k for k, _ in got] == [k for k, _ in want]
    ssm_leaves = 0
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(g, w), path
        ssm_leaves += "ssm" in str(path)
    assert ssm_leaves  # the configs' Mamba2 layers are compared


# ----------------------------------------------------------------------
# the SSD: the shared preparation and the state-only pass
# ----------------------------------------------------------------------
def _ssd_inputs(t: int, groups: int, dtype, with_state: bool, b=2, h=4, p=8, n=6):
    gen = torch.Generator().manual_seed(11)
    x = torch.randn((b, t, h, p), generator=gen).to(dtype)
    dt = F.softplus(torch.randn((b, t, h), generator=gen))
    A = -torch.exp(torch.randn((h,), generator=gen))
    Bm = torch.randn((b, t, groups, n), generator=gen).to(dtype)
    Cm = torch.randn((b, t, groups, n), generator=gen).to(dtype)
    s0 = torch.randn((b, h, p, n), generator=gen) if with_state else None
    return x, dt, A, Bm, Cm, s0


@pytest.mark.parametrize("t", [37, 32])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("with_state", [False, True])
def test_state_only_pass_equals_the_ssd_state(t, groups, with_state):
    for dtype in (torch.bfloat16, _F32):
        x, dt, A, Bm, Cm, s0 = _ssd_inputs(t, groups, dtype, with_state)
        got = mamba2.ssd_final_state(x, dt, A, Bm, chunk=16, init_state=s0)
        _, want = mamba2.ssd_chunked(x, dt, A, Bm, Cm, chunk=16, init_state=s0)
        _, before = _ssd_chunked_before(x, dt, A, Bm, Cm, chunk=16, init_state=s0)
        assert got.dtype == _F32 and torch.equal(got, want) and torch.equal(got, before)


@pytest.mark.parametrize("intra_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_equals_its_earlier_form(intra_dtype, groups):
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(37, groups, torch.bfloat16, True)
    for init in (None, s0):
        got = mamba2.ssd_chunked(x, dt, A, Bm, Cm, chunk=16, init_state=init,
                                 intra_dtype=intra_dtype)
        want = _ssd_chunked_before(x, dt, A, Bm, Cm, chunk=16, init_state=init,
                                   intra_dtype=intra_dtype)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


# ----------------------------------------------------------------------
# serving: greedy tokens, and the counters of each path
# ----------------------------------------------------------------------
def _serve(cfg, traced=False):
    if traced:
        obs.enable()
    eng = ServeEngine(cfg, max_batch=4, device="cpu")
    eng.set_params(model_for(cfg).init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    for n in (40, 24, 33, 17, 29):  # two batches: two prefills
        eng.submit(rng.integers(1, cfg.vocab_size, n), 4)
    reqs = eng.step_batch() + eng.step_batch()
    obs.disable()
    return [r.out_tokens for r in reqs], obs.export()["counters"]


@pytest.mark.parametrize("name", ["granite4_f32", "granite4_bf16"])
def test_greedy_tokens_unchanged(name, oracle):
    tokens, _ = _serve(CONFIGS[name])
    oracle()
    want, _ = _serve(CONFIGS[name])
    assert tokens == want and all(len(t) == 4 for t in tokens)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_counters_name_the_path_each_layer_took(name):
    cfg = CONFIGS[name]
    _, counters = _serve(cfg, traced=True)
    layers = sum(1 for s in cfg.layer_specs() if s.mixer == "mamba")
    taken, other = ("mamba.state_from_output", "mamba.state_only_passes")
    if cfg.ssm.intra_dtype == "bf16":
        taken, other = other, taken
    assert counters[taken] == 2 * layers
    assert other not in counters
