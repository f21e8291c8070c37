"""Plain float32 reference of the Granite 4.0-H hybrid (``granitemoehybrid``).

Written from the published layer equations in plain PyTorch, with no kernel,
no cache and no batching trick, importing nothing of the program under test.
Matrix products and convolutions run in float32 with TF32 off.  Each layer is

    x = x + r · mixer(rmsnorm(x))      mixer: Mamba2 or NoPE GQA attention
    x = x + r · (moe(a) + shared(a)),  a = rmsnorm(x)

with ``r`` the residual multiplier; the input is the embedding times the
embedding multiplier, attention scores are scaled by the attention
multiplier, and the logits are divided by ``logits_scaling``.  The Mamba2
mixer:

    xs, z, B, C, dt_raw = a·W_x, a·W_z, a·W_B, a·W_C, a·W_dt
    xs, B, C = silu(causal depthwise conv + bias) of each (width W)
    dt = softplus(dt_raw + dt_bias),  A = -exp(A_log)
    h_t = exp(dt_t·A)·h_{t-1} + dt_t·x_t·B_tᵀ,   y_t = h_t·C_t + D·x_t
    out = rmsnorm(y ⊙ silu(z)) · W_out          (the gated RMSNorm, 1 group)

The SSM runs its recurrence one step at a time from h = 0, never the chunked
algebra.  Routing is the port's: softmax over the
experts, top-k, gates renormalised; the prompt's tokens share one capacity
per expert (1.25 x the even share, filled in token order and then choice
order), each generated token is routed alone without a limit.

:func:`make_params` draws the engine's tree (``embed``, ``final_norm``, one
stage of the ``attn_every``-layer pattern, each leaf with a leading repeat
axis when the pattern repeats).  ``dt_bias`` and ``A_log`` are drawn as
Mamba2 initialises them (dt log-uniform in [0.001, 0.1] through the inverse
softplus, A uniform in [1, 16]), so a head's state carries across chunks;
norm gains, ``D`` and conv biases are drawn away from 1 and 0 so the check
sees them.  The embedding table is drawn at 0.02 / ``embedding_multiplier``,
so that the embeddings enter the residual stream at the 0.02 of the other
configurations: at 0.02 itself, times Granite's 12, each token's own row of
the tied head outweighs every other logit at random weights, every position
serves its input token again whatever the precision, and no check could
tell a precision apart.  :func:`served_logits` is the engine's semantics as one pass over
the prompt and the served tokens after it; ``quant="fp8"`` rounds both
operands of every linear layer to float8 e4m3, the precision control.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

F32 = torch.float32
EPS = 1e-6
FP8_MAX = 448.0
DT_RANGE = (1e-3, 1e-1)  # Mamba2's dt_min, dt_max
A_RANGE = (1.0, 16.0)


def _hd(mc: dict) -> int:
    return mc.get("head_dim") or mc["d_model"] // mc["n_heads"]


def _pattern(mc: dict) -> list[str]:
    """The mixer of each layer of one period: ``attn`` or ``mamba``."""
    every, off = mc["attn_every"], mc["attn_offset"]
    if mc["n_layers"] % every:
        raise ValueError(f"{mc['n_layers']} layers is not a whole number of {every}-layer periods")
    return ["attn" if i == off else "mamba" for i in range(every)]


def leaf_shapes(mc: dict) -> list[tuple[tuple, tuple[int, ...], str]]:
    """(path, shape, init) of every leaf, in draw order.  ``init`` is
    ``normal:<std>``, ``scale`` (1 + 0.1 N(0, 1)), ``dt_bias`` or ``A_log``."""
    d, h, hk, hd = mc["d_model"], mc["n_heads"], mc["n_kv_heads"], _hd(mc)
    s, moe = mc["ssm"], mc["moe"]
    sh, sp, g, n, w = s["n_heads"], s["head_dim"], s.get("n_groups", 1), s["d_state"], \
        s.get("conv_width", 4)
    hp = sh * sp
    e, f, fs = moe["n_experts"], moe["d_expert"], moe["d_expert"] * moe.get("n_shared", 0)
    reps = mc["n_layers"] // mc["attn_every"]
    lead = (reps,) if reps > 1 else ()
    emb = 0.02 / mc.get("embedding_multiplier", 1.0)
    out = [(("embed", "table"), (mc["vocab_size"], d), f"normal:{emb}"),
           (("final_norm", "scale"), (d,), "scale")]
    for j, mixer in enumerate(_pattern(mc)):
        layer = ("stages", 0, j)
        out.append(((*layer, "norm1", "scale"), (*lead, d), "scale"))
        if mixer == "attn":
            out += [((*layer, "attn", "wq"), (*lead, d, h, hd), f"normal:{d ** -0.5}"),
                    ((*layer, "attn", "wk"), (*lead, d, hk, hd), f"normal:{d ** -0.5}"),
                    ((*layer, "attn", "wv"), (*lead, d, hk, hd), f"normal:{d ** -0.5}"),
                    ((*layer, "attn", "wo"), (*lead, h, hd, d), f"normal:{(h * hd) ** -0.5}")]
        else:
            m = (*layer, "mamba")
            out += [((*m, "w_x"), (*lead, d, hp), f"normal:{d ** -0.5}"),
                    ((*m, "w_z"), (*lead, d, hp), f"normal:{d ** -0.5}"),
                    ((*m, "w_B"), (*lead, d, g * n), f"normal:{d ** -0.5}"),
                    ((*m, "w_C"), (*lead, d, g * n), f"normal:{d ** -0.5}"),
                    ((*m, "w_dt"), (*lead, d, sh), f"normal:{d ** -0.5}"),
                    ((*m, "dt_bias"), (*lead, sh), "dt_bias"),
                    ((*m, "A_log"), (*lead, sh), "A_log"),
                    ((*m, "D"), (*lead, sh), "scale"),
                    ((*m, "conv_x"), (*lead, w, hp), "normal:0.2"),
                    ((*m, "conv_B"), (*lead, w, g * n), "normal:0.2"),
                    ((*m, "conv_C"), (*lead, w, g * n), "normal:0.2"),
                    ((*m, "out_norm", "scale"), (*lead, hp), "scale"),
                    ((*m, "w_out"), (*lead, hp, d), f"normal:{hp ** -0.5}")]
            if s.get("conv_bias"):
                out += [((*m, "conv_x_bias"), (*lead, hp), "normal:0.2"),
                        ((*m, "conv_B_bias"), (*lead, g * n), "normal:0.2"),
                        ((*m, "conv_C_bias"), (*lead, g * n), "normal:0.2")]
        out += [((*layer, "norm2", "scale"), (*lead, d), "scale"),
                ((*layer, "moe", "router"), (*lead, d, e), f"normal:{d ** -0.5}"),
                ((*layer, "moe", "w_gate"), (*lead, e, d, f), f"normal:{d ** -0.5}"),
                ((*layer, "moe", "w_up"), (*lead, e, d, f), f"normal:{d ** -0.5}"),
                ((*layer, "moe", "w_down"), (*lead, e, f, d), f"normal:{f ** -0.5}")]
        if fs:
            out += [((*layer, "moe", "shared", "w_out"), (*lead, fs, d), f"normal:{fs ** -0.5}"),
                    ((*layer, "moe", "shared", "w_gate"), (*lead, d, fs), f"normal:{d ** -0.5}"),
                    ((*layer, "moe", "shared", "w_up"), (*lead, d, fs), f"normal:{d ** -0.5}")]
    if not mc.get("tie_embeddings"):
        out.append((("lm_head", "w"), (d, mc["vocab_size"]), f"normal:{d ** -0.5}"))
    return out


def param_count(mc: dict) -> int:
    return sum(math.prod(shape) for _, shape, _ in leaf_shapes(mc))


def _init(leaf: torch.Tensor, init: str) -> None:
    """Turn a leaf of N(0, 1) draws into its initial values, in place."""
    if init == "scale":
        leaf.mul_(0.1).add_(1.0)
    elif init in ("dt_bias", "A_log"):
        u = leaf.mul_(2 ** -0.5).erf_().add_(1.0).mul_(0.5)  # uniform in (0, 1)
        if init == "dt_bias":  # dt log-uniform, then softplus⁻¹(dt) = dt + log(1 - e^-dt)
            lo, hi = math.log(DT_RANGE[0]), math.log(DT_RANGE[1])
            dt = u.mul_(hi - lo).add_(lo).exp_()
            dt.add_(torch.log(-torch.expm1(-dt)))
        else:
            u.mul_(A_RANGE[1] - A_RANGE[0]).add_(A_RANGE[0]).log_()
    else:
        leaf.mul_(float(init.split(":")[1]))


def make_params(mc: dict, seed: int, device) -> dict:
    """Float32 weights drawn from ``seed`` on ``device``: one flat buffer
    filled by a device generator in chunks of 2**30 values, each leaf a view
    of it set up in place."""
    specs = leaf_shapes(mc)
    total = sum(math.prod(s) for _, s, _ in specs)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    flat = torch.empty(total, dtype=F32, device=device)
    for i in range(0, total, 2**30):
        flat[i:i + 2**30].normal_(generator=gen)
    layers = [{} for _ in _pattern(mc)]
    tree: dict = {"stages": [tuple(layers)]}
    off = 0
    for path, shape, init in specs:
        size = math.prod(shape)
        leaf = flat[off:off + size].view(shape)
        off += size
        _init(leaf, init)
        node, keys = (layers[path[2]], path[3:]) if path[0] == "stages" else (tree, path)
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


# ----------------------------------------------------------------------
# arithmetic
# ----------------------------------------------------------------------
def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(F32) * scale


def _linear(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """x (..., in) @ w (in, out) in float32, or with both operands in fp8."""
    w = w.to(F32)
    if quant == "fp8":
        x, w = _fp8(x, -1), _fp8(w, 0)
    elif quant is not None:
        raise ValueError(f"unknown quant {quant!r}")
    return x @ w


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + EPS) * scale.to(F32)


def _swiglu(x, w_gate, w_up, w_down, quant):
    return _linear(F.silu(_linear(x, w_gate, quant)) * _linear(x, w_up, quant), w_down, quant)


def _moe(x: torch.Tensor, p: dict, moe: dict, n_prompt: int, quant) -> torch.Tensor:
    """Top-k routing of the tokens ``x`` (n, d) and each token's kept
    choices' expert outputs, weighted by their gates.  The first ``n_prompt``
    tokens share one capacity per expert; the rest are routed without one."""
    e, k = moe["n_experts"], moe["top_k"]
    probs = torch.softmax(_linear(x, p["router"], quant), dim=-1)
    gate, eid = torch.topk(probs, k, dim=-1, sorted=True)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    keep = torch.ones_like(gate, dtype=torch.bool)
    if n_prompt > 1:
        cap = max(int(n_prompt * k / e * moe.get("capacity_factor", 1.25)), k)
        flat = eid[:n_prompt].reshape(-1)
        onehot = F.one_hot(flat, e)
        before = (torch.cumsum(onehot, dim=0) - onehot).gather(1, flat[:, None])[:, 0]
        keep[:n_prompt] = (before < cap).reshape(n_prompt, k)
    y = torch.zeros_like(x)
    w = gate * keep
    for ex in range(e):
        tok, slot = torch.nonzero((eid == ex) & keep, as_tuple=True)
        if tok.numel():
            h = _swiglu(x[tok], p["w_gate"][ex], p["w_up"][ex], p["w_down"][ex], quant)
            y.index_add_(0, tok, h * w[tok, slot][:, None])
    return y


# ----------------------------------------------------------------------
# mixers
# ----------------------------------------------------------------------
def _attention(a: torch.Tensor, p: dict, mc: dict, quant, block: int = 1024) -> torch.Tensor:
    """NoPE causal GQA attention over the whole sequence, query rows in blocks."""
    b, s, d = a.shape
    h, hk, hd = mc["n_heads"], mc["n_kv_heads"], _hd(mc)
    scale = mc.get("attention_multiplier") or hd ** -0.5
    q = _linear(a, p["wq"].reshape(d, h * hd), quant).view(b, s, h, hd).transpose(1, 2)
    k = _linear(a, p["wk"].reshape(d, hk * hd), quant).view(b, s, hk, hd).transpose(1, 2)
    v = _linear(a, p["wv"].reshape(d, hk * hd), quant).view(b, s, hk, hd).transpose(1, 2)
    k = k.repeat_interleave(h // hk, dim=1)
    v = v.repeat_interleave(h // hk, dim=1)
    o = torch.empty_like(q)
    kpos = torch.arange(s, device=a.device)
    for lo in range(0, s, block):
        hi = min(lo + block, s)
        sc = (q[:, :, lo:hi] @ k.transpose(-1, -2)) * scale
        future = kpos[None, :] > torch.arange(lo, hi, device=a.device)[:, None]
        o[:, :, lo:hi] = torch.softmax(sc.masked_fill(future, float("-inf")), dim=-1) @ v
    return _linear(o.transpose(1, 2).reshape(b, s, h * hd), p["wo"].reshape(h * hd, d), quant)


def _conv(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Causal depthwise conv of x (B, S, Ch) with kernel (W, Ch): output t sees
    inputs t-W+1 .. t, zeros before the first."""
    w, ch = kernel.shape
    y = F.conv1d(x.transpose(1, 2), kernel.T.reshape(ch, 1, w).to(F32),
                 None if bias is None else bias.to(F32), padding=w - 1, groups=ch)
    return y[..., :x.shape[1]].transpose(1, 2)


def _ssm_scan(x, dt, A, Bm, Cm) -> torch.Tensor:
    """The recurrence h_t = exp(dt_t·A)·h_{t-1} + dt_t·x_t·B_tᵀ, y_t = h_t·C_t,
    one step at a time from h = 0.  x (B, S, H, P), dt (B, S, H), A (H,),
    B and C (B, S, G, N) with head i reading group i // (H / G)."""
    b, s, hh, p = x.shape
    n = Bm.shape[-1]
    rep = hh // Bm.shape[2]
    decay = torch.exp(dt * A).permute(1, 0, 2).reshape(s, b * hh, 1, 1)
    u = (dt[..., None] * x).permute(1, 0, 2, 3).reshape(s, b * hh, p, 1)
    bt = Bm.repeat_interleave(rep, dim=2).permute(1, 0, 2, 3).reshape(s, b * hh, 1, n)
    ct = Cm.repeat_interleave(rep, dim=2).permute(1, 0, 2, 3).reshape(s, b * hh, n, 1)
    h = torch.zeros((b * hh, p, n), dtype=F32, device=x.device)
    y = torch.empty((s, b * hh, p, 1), dtype=F32, device=x.device)
    for t in range(s):
        h = torch.baddbmm(h.mul_(decay[t]), u[t], bt[t])
        torch.bmm(h, ct[t], out=y[t])
    return y.reshape(s, b, hh, p).permute(1, 0, 2, 3)


def _mamba(a: torch.Tensor, p: dict, mc: dict, quant) -> torch.Tensor:
    b, s, _ = a.shape
    sc = mc["ssm"]
    hh, hp_dim, n, g = sc["n_heads"], sc["head_dim"], sc["d_state"], sc.get("n_groups", 1)
    xs = _linear(a, p["w_x"], quant)
    z = _linear(a, p["w_z"], quant)
    xs = F.silu(_conv(xs, p["conv_x"], p.get("conv_x_bias")))
    bm = F.silu(_conv(_linear(a, p["w_B"], quant), p["conv_B"], p.get("conv_B_bias")))
    cm = F.silu(_conv(_linear(a, p["w_C"], quant), p["conv_C"], p.get("conv_C_bias")))
    dt = F.softplus(_linear(a, p["w_dt"], quant) + p["dt_bias"].to(F32))
    x4 = xs.view(b, s, hh, hp_dim)
    y = _ssm_scan(x4, dt, -torch.exp(p["A_log"].to(F32)), bm.view(b, s, g, n), cm.view(b, s, g, n))
    y = (y + p["D"].to(F32)[:, None] * x4).reshape(b, s, hh * hp_dim)
    y = _rmsnorm(y * F.silu(z), p["out_norm"]["scale"])
    return _linear(y, p["w_out"], quant)


def _experts(a: torch.Tensor, p: dict, moe: dict, t: int, quant) -> torch.Tensor:
    """The routed experts and the shared one.  Prompt tokens first
    (batch-major, as the engine flattens its prefill), then every generated
    token; the prompt's share one capacity."""
    b, s, d = a.shape
    n = s - t
    flat = torch.cat([a[:, :t].reshape(b * t, d), a[:, t:].reshape(b * n, d)])
    y = _moe(flat, p, moe, b * t if t > 1 else 0, quant)
    if "shared" in p:
        sh = p["shared"]
        y = y + _swiglu(flat, sh["w_gate"], sh["w_up"], sh["w_out"], quant)
    return torch.cat([y[:b * t].view(b, t, d), y[b * t:].view(b, n, d)], dim=1)


def _layer_params(tree: Any, r: int, reps: int) -> Any:
    if isinstance(tree, dict):
        return {key: _layer_params(v, r, reps) for key, v in tree.items()}
    return tree[r] if reps > 1 else tree


@torch.no_grad()
def served_logits(mc: dict, params: dict, prompts: torch.Tensor, gen: torch.Tensor,
                  quant: Optional[str] = None) -> torch.Tensor:
    """Logits (B, N + 1, V) float32 at positions T-1 .. T+N-1.

    ``prompts`` (B, T): the batch as served, left-padded with token 0 to its
    longest prompt (the pads are tokens: no pad mask, the SSM runs through
    them).  ``gen`` (B, N): the tokens fed back after it; the recurrence,
    the convolutions and attention carry on over them.  Row r's logits at
    position T-1+j are those from which its (j+1)-th served token was
    chosen."""
    if mc.get("rope_pct", 1.0) != 0:
        raise ValueError("this reference models NoPE attention (rope_pct 0) only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = prompts.shape[1]
    tokens = torch.cat([prompts, gen], dim=1).long()
    x = params["embed"]["table"][tokens].to(F32) * mc.get("embedding_multiplier", 1.0)
    r_mult = mc.get("residual_multiplier", 1.0)
    pattern = _pattern(mc)
    reps = mc["n_layers"] // len(pattern)
    layers = params["stages"][0]
    for r in range(reps):
        for j, mixer in enumerate(pattern):
            p = _layer_params(layers[j], r, reps)
            a = _rmsnorm(x, p["norm1"]["scale"])
            h = _attention(a, p["attn"], mc, quant) if mixer == "attn" else \
                _mamba(a, p["mamba"], mc, quant)
            x = x + r_mult * h
            a = _rmsnorm(x, p["norm2"]["scale"])
            x = x + r_mult * _experts(a, p["moe"], mc["moe"], t, quant)
    x = _rmsnorm(x[:, t - 1:], params["final_norm"]["scale"])
    head = params["embed"]["table"].T if mc.get("tie_embeddings") else params["lm_head"]["w"]
    return _linear(x, head, quant) / mc.get("logits_scaling", 1.0)
