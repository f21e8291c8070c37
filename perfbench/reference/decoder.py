"""Plain float32 reference of the decoder-only models the serving cells run.

It is written from the published layer equations (RMSNorm, rotary attention
with grouped KV heads, SwiGLU MLP or a top-k mixture of experts with capacity
drops) in plain PyTorch, with no kernel, no cache and no batching trick, and
it imports nothing of the program under test.  Matrix products run in float32
with TF32 off.

Two entry points:

* :func:`make_params` draws the weights on the device from a seed, in the
  tree layout the serving engine takes (``embed``, ``final_norm``, one stage
  whose leaves carry a leading layer axis, ``lm_head`` unless tied).  The same
  tensors are handed to the program and to this reference.
* :func:`served_logits` computes, for a batch of left-padded prompts and the
  tokens served after them, the logits at each position where a served token
  was chosen.  It is the engine's semantics written as one pass: the prompt
  rows (pad token 0, no pad mask) go through every layer together, so that the
  router's capacity counts the whole padded batch as the engine's prefill
  does; each generated position is routed alone, without a capacity limit, as
  a one-token decode step is.  ``quant="fp8"`` rounds both operands of every
  linear layer to float8 e4m3 (per-row and per-column scales), the precision
  control.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

F32 = torch.float32
EPS = 1e-6
FP8_MAX = 448.0


def _hd(mc: dict) -> int:
    return mc.get("head_dim") or mc["d_model"] // mc["n_heads"]


def leaf_shapes(mc: dict) -> list[tuple[tuple[str, ...], tuple[int, ...], str]]:
    """(path, shape, init) of every leaf, in draw order.  ``init`` is
    ``normal:<std>`` or ``scale`` (a norm's gain, drawn near 1)."""
    d, h, hk, hd, L = mc["d_model"], mc["n_heads"], mc["n_kv_heads"], _hd(mc), mc["n_layers"]
    lead = (L,) if L > 1 else ()
    layer = "stages", 0, 0
    out = [(("embed", "table"), (mc["vocab_size"], d), "normal:0.02"),
           (("final_norm", "scale"), (d,), "scale"),
           ((*layer, "norm1", "scale"), (*lead, d), "scale"),
           ((*layer, "attn", "wq"), (*lead, d, h, hd), f"normal:{d ** -0.5}"),
           ((*layer, "attn", "wk"), (*lead, d, hk, hd), f"normal:{d ** -0.5}"),
           ((*layer, "attn", "wv"), (*lead, d, hk, hd), f"normal:{d ** -0.5}"),
           ((*layer, "attn", "wo"), (*lead, h, hd, d), f"normal:{(h * hd) ** -0.5}"),
           ((*layer, "norm2", "scale"), (*lead, d), "scale")]
    moe = mc.get("moe")
    if moe:
        e, f = moe["n_experts"], moe["d_expert"]
        out += [((*layer, "moe", "router"), (*lead, d, e), f"normal:{d ** -0.5}"),
                ((*layer, "moe", "w_gate"), (*lead, e, d, f), f"normal:{d ** -0.5}"),
                ((*layer, "moe", "w_up"), (*lead, e, d, f), f"normal:{d ** -0.5}"),
                ((*layer, "moe", "w_down"), (*lead, e, f, d), f"normal:{f ** -0.5}")]
    else:
        f = mc["d_ff"]
        out += [((*layer, "mlp", "w_out"), (*lead, f, d), f"normal:{f ** -0.5}"),
                ((*layer, "mlp", "w_gate"), (*lead, d, f), f"normal:{d ** -0.5}"),
                ((*layer, "mlp", "w_up"), (*lead, d, f), f"normal:{d ** -0.5}")]
    if not mc.get("tie_embeddings"):
        out.append((("lm_head", "w"), (d, mc["vocab_size"]), f"normal:{d ** -0.5}"))
    return out


def param_count(mc: dict) -> int:
    return sum(math.prod(shape) for _, shape, _ in leaf_shapes(mc))


def make_params(mc: dict, seed: int, device) -> dict:
    """Float32 weights drawn from ``seed`` on ``device``: one flat buffer
    filled by a device generator in chunks of 2**30 values, each leaf a view
    of it scaled in place (norm gains 1 + 0.1 N(0, 1))."""
    specs = leaf_shapes(mc)
    n = sum(math.prod(s) for _, s, _ in specs)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    flat = torch.empty(n, dtype=F32, device=device)
    for i in range(0, n, 2**30):
        flat[i:i + 2**30].normal_(generator=gen)
    tree: dict = {"stages": [({},)]}
    off = 0
    for path, shape, init in specs:
        size = math.prod(shape)
        leaf = flat[off:off + size].view(shape)
        off += size
        if init == "scale":
            leaf.mul_(0.1).add_(1.0)
        else:
            leaf.mul_(float(init.split(":")[1]))
        node = tree["stages"][0][0] if path[0] == "stages" else tree
        keys = path[3:] if path[0] == "stages" else path
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


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on adjacent pairs, positions 0..S-1; x (B, H, S, hd)."""
    s, hd = x.shape[-2], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd))
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang).to(F32), torch.sin(ang).to(F32)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(x.shape)


def _attention(q, k, v, block: int = 1024) -> torch.Tensor:
    """Causal softmax attention, (B, H, S, hd) each, query rows in blocks."""
    s, hd = q.shape[-2], q.shape[-1]
    out = torch.empty_like(q)
    kpos = torch.arange(s, device=q.device)
    for a in range(0, s, block):
        b = min(a + block, s)
        sc = (q[:, :, a:b] @ k.transpose(-1, -2)) * hd ** -0.5
        mask = kpos[None, :] <= torch.arange(a, b, device=q.device)[:, None]
        sc = sc.masked_fill(~mask, float("-inf"))
        out[:, :, a:b] = torch.softmax(sc, dim=-1) @ v
    return out


def _swiglu(x, w_gate, w_up, w_down, quant):
    return _linear(F.silu(_linear(x, w_gate, quant)) * _linear(x, w_up, quant), w_down, quant)


def _route(x: torch.Tensor, p: dict, moe: dict, n_prompt: int, quant):
    """(gate, expert, keep), each (n, k): top-k routing over the flattened
    tokens ``x`` (n, d).  The first ``n_prompt`` tokens share one capacity per
    expert, filled in token order and then choice order; the rest are routed
    without a limit."""
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
    return gate, eid, keep


def _moe(x: torch.Tensor, p: dict, moe: dict, n_prompt: int, quant) -> torch.Tensor:
    """Each token's kept choices' expert outputs, weighted by their gates."""
    gate, eid, keep = _route(x, p, moe, n_prompt, quant)
    y = torch.zeros_like(x)
    w = gate * keep
    for ex in range(moe["n_experts"]):
        tok, slot = torch.nonzero((eid == ex) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        h = _swiglu(x[tok], p["w_gate"][ex], p["w_up"][ex], p["w_down"][ex], quant)
        y.index_add_(0, tok, h * w[tok, slot][:, None])
    return y


def _layer_params(tree: Any, i: int, n_layers: int) -> Any:
    if isinstance(tree, dict):
        return {key: _layer_params(v, i, n_layers) for key, v in tree.items()}
    return tree[i] if n_layers > 1 else tree


@torch.no_grad()
def served_logits(mc: dict, params: dict, prompts: torch.Tensor, gen: torch.Tensor,
                  quant: Optional[str] = None) -> torch.Tensor:
    """Logits (B, N + 1, V) float32 at positions T-1 .. T+N-1.

    ``prompts`` (B, T): the batch as served, left-padded with token 0 to its
    longest prompt.  ``gen`` (B, N): the tokens fed back after it (a row's
    own served tokens, anything after them: later positions never reach
    earlier ones).  Row r's logits at position T-1+j are those from which
    its (j+1)-th served token was chosen."""
    if quant is None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    b, t = prompts.shape
    n = gen.shape[1]
    hd, h, hk = _hd(mc), mc["n_heads"], mc["n_kv_heads"]
    rep = h // hk
    tokens = torch.cat([prompts, gen], dim=1).long()
    s = t + n
    x = params["embed"]["table"][tokens].to(F32)  # (B, S, d)
    layers = params["stages"][0][0]
    moe = mc.get("moe")
    for i in range(mc["n_layers"]):
        p = _layer_params(layers, i, mc["n_layers"])
        a = _rmsnorm(x, p["norm1"]["scale"])
        pa = p["attn"]
        d = a.shape[-1]
        q = _linear(a, pa["wq"].reshape(d, h * hd), quant).view(b, s, h, hd).transpose(1, 2)
        kk = _linear(a, pa["wk"].reshape(d, hk * hd), quant).view(b, s, hk, hd).transpose(1, 2)
        vv = _linear(a, pa["wv"].reshape(d, hk * hd), quant).view(b, s, hk, hd).transpose(1, 2)
        q, kk = _rope(q, mc["rope_theta"]), _rope(kk, mc["rope_theta"])
        kk = kk.repeat_interleave(rep, dim=1)
        vv = vv.repeat_interleave(rep, dim=1)
        o = _attention(q, kk, vv).transpose(1, 2).reshape(b, s, h * hd)
        x = x + _linear(o, pa["wo"].reshape(h * hd, d), quant)
        a = _rmsnorm(x, p["norm2"]["scale"])
        if moe:
            # prompt tokens first (batch-major, as the engine flattens its
            # prefill), then every generated token
            flat = torch.cat([a[:, :t].reshape(b * t, d), a[:, t:].reshape(b * n, d)])
            y = _moe(flat, p["moe"], moe, b * t if t > 1 else 0, quant)
            y = torch.cat([y[:b * t].view(b, t, d), y[b * t:].view(b, n, d)], dim=1)
        else:
            pm = p["mlp"]
            y = _swiglu(a, pm["w_gate"], pm["w_up"], pm["w_out"], quant)
        x = x + y
    x = _rmsnorm(x[:, t - 1:], params["final_norm"]["scale"])
    head = params["embed"]["table"].T if mc.get("tie_embeddings") else params["lm_head"]["w"]
    return _linear(x, head, quant)
