"""The MoE router's expert positions (``kernels/moe_route.py``) and the
dispatch plan around them.

On the CPU: ``expert_slots`` is its plain version (the one-hot cumsum)
and counts no launch; the operand checks the CUDA kernel relies on; and
``apply_moe`` reaching ``moe._dispatch_combine_plan`` through the module
attribute with ``(xf, router, m, t)``, in prefill and in decode, directly
and through a model (the benchmark's router range wraps that attribute).
The ``cuda``-marked tests hold the kernel's slots bit for bit against the
plain version on the card at granite_moe_1b's full batch, deepseek_moe_16b's
(E, k), the mesh's 16 routings, decode, an all-same-expert skew and one
token, and count a launch per MoE layer of a prefill and a decode step.  The JAX
package is compared in ``test_torch_mamba_moe.py``; this file imports none
of it.
"""
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels import moe_route
from repro_torch.models import model_for
from repro_torch.models import moe
from repro_torch.models.params import tree_map


def _ids(l: int, n: int, e: int, k: int, seed: int, device="cpu") -> torch.Tensor:
    """(L, n, k) int32 ids, k distinct experts a token, as top-k gives them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    scores = torch.rand((l, n, e), generator=gen, device=device)
    return scores.topk(k, dim=-1).indices.to(torch.int32)


def test_cpu_route_is_the_plain_version_and_launches_nothing():
    moe_route.reset_launches()
    ids = _ids(2, 50, 8, 2, seed=0)
    obs.reset()
    obs.enable()
    try:
        got = moe_route.expert_slots(ids, 8, 9)
    finally:
        obs.disable()
    (sp,) = obs.export()["spans"]
    obs.reset()
    assert torch.equal(got, moe_route.expert_slots_torch(ids, 8, 9))
    assert got.dtype == torch.int32 and got.shape == ids.shape
    assert moe_route.expert_slots.launches == 0
    assert sp["name"] == "kernels.moe_route"
    assert sp["attrs"] == {"tokens": 100, "k": 2, "e": 8, "capacity": 9}


@pytest.mark.parametrize("arch", ["granite_moe_1b", "deepseek_moe_16b", "jamba_v01_52b"])
def test_kernel_takes_every_config(arch):
    m = get_config(arch).moe
    moe_route.check_kernel_operands(_ids(1, 8, m.n_experts, m.top_k, seed=1), m.n_experts, 8)


BAD_OPERANDS = {
    "int64": (lambda: _ids(1, 8, 8, 2, 0).long(), 8, 4),
    "not_contiguous": (lambda: _ids(1, 8, 8, 2, 0).transpose(1, 2), 8, 4),
    "over_max_experts": (lambda: _ids(1, 8, 8, 2, 0), moe_route.MAX_EXPERTS + 1, 4),
    "no_experts": (lambda: _ids(1, 8, 8, 2, 0), 0, 4),
    "not_3d": (lambda: _ids(1, 8, 8, 2, 0)[0], 8, 4),
    "slot_overflow": (lambda: _ids(1, 8, 8, 2, 0), 8, 2**28),
}


@pytest.mark.parametrize("case", list(BAD_OPERANDS))
def test_kernel_rejects_what_it_does_not_take(case):
    make, e, capacity = BAD_OPERANDS[case]
    with pytest.raises(ValueError):
        moe_route.check_kernel_operands(make(), e, capacity)


def _spy(monkeypatch) -> list:
    calls, real = [], moe._dispatch_combine_plan

    def plan(xf, router, m, t):
        calls.append((xf, router, m, t))
        return real(xf, router, m, t)

    monkeypatch.setattr(moe, "_dispatch_combine_plan", plan)
    return calls


@pytest.mark.parametrize("t", [12, 1], ids=["prefill", "decode"])
def test_apply_moe_calls_the_plan_through_the_module(monkeypatch, t):
    cfg = get_smoke("granite_moe_1b")
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(3, t, cfg.d_model, generator=torch.Generator().manual_seed(1))
    calls = _spy(monkeypatch)
    moe.apply_moe(p, x, cfg)
    ((xf, router, m, tt),) = calls
    assert xf.shape == (3 * t, cfg.d_model) and torch.equal(xf, x.reshape(-1, cfg.d_model))
    assert router is p["router"] and m is cfg.moe and tt == t


def test_model_calls_the_plan_through_the_module(monkeypatch):
    """A prefill and a decode step of the granite smoke model: one plan call
    a MoE layer, with the step's T."""
    cfg = get_smoke("granite_moe_1b")
    model = model_for(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(2))
    calls = _spy(monkeypatch)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": toks}, cache_len=12)
        assert [c[3] for c in calls] == [8] * cfg.n_layers
        assert all(c[0].shape == (16, cfg.d_model) and c[2] is cfg.moe for c in calls)
        calls.clear()
        nxt = logits[:, -1].argmax(-1, keepdim=True)
        model.decode_step(params, {"tokens": nxt, "pos": 8}, cache)
    assert [c[3] for c in calls] == [1] * cfg.n_layers
    assert all(c[0].shape == (2, cfg.d_model) for c in calls)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _full_batch_capacity(arch: str, n: int) -> int:
    return moe._capacity(n, get_config(arch).moe, t=2)


# (L, n, E, k, capacity or the config whose prefill capacity applies, skew)
CARD_CASES = {
    "granite_moe_1b_full_batch": (1, 15_872, 32, 8, "granite_moe_1b", False),
    "deepseek_moe_16b_full_batch": (1, 15_872, 64, 6, "deepseek_moe_16b", False),
    "mesh_16_shards": (16, 992, 32, 8, "granite_moe_1b", False),
    "decode": (1, 4, 32, 8, 4, False),
    "skew": (1, 15_872, 32, 8, "granite_moe_1b", True),
    "one_token": (1, 1, 32, 8, 1, False),
    "max_experts": (2, 3_001, moe_route.MAX_EXPERTS, 8, 100, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_slots_equal_plain_on_card(cuda_device, case):
    l, n, e, k, cap, skew = CARD_CASES[case]
    if isinstance(cap, str):
        cap = _full_batch_capacity(cap, n)
    if skew:
        ids = torch.arange(k, dtype=torch.int32, device=cuda_device).expand(l, n, k).contiguous()
    else:
        ids = _ids(l, n, e, k, seed=n + e, device=cuda_device)
    moe_route.reset_launches()
    got = moe_route.expert_slots(ids, e, cap)
    torch.cuda.synchronize()
    want = moe_route.expert_slots_torch(ids, e, cap)
    assert moe_route.expert_slots.launches == 1
    assert got.dtype == torch.int32 and got.device == ids.device
    assert torch.equal(got, want), f"{int((got != want).sum())} slots differ"


@pytest.mark.cuda
def test_kernel_raises_on_operands_it_does_not_take(cuda_device):
    ids = _ids(1, 64, 8, 2, seed=0, device=cuda_device)
    with pytest.raises(ValueError):
        moe_route.expert_slots(ids.long(), 8, 16)
    with pytest.raises(ValueError):
        moe_route.expert_slots(ids.transpose(1, 2), 8, 16)
    with pytest.raises(ValueError):
        moe_route.expert_slots(ids, moe_route.MAX_EXPERTS + 1, 16)


@pytest.mark.cuda
def test_prefill_and_decode_launch_once_a_moe_layer(cuda_device):
    cfg = get_smoke("granite_moe_1b")
    model = model_for(cfg)
    params = tree_map(lambda x: x.to(cuda_device), model.init(torch.Generator().manual_seed(0)))
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda_device,
                         generator=torch.Generator(device=cuda_device).manual_seed(3))
    moe_route.reset_launches()
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": toks}, cache_len=72)
        torch.cuda.synchronize()
        assert moe_route.expert_slots.launches == cfg.n_layers
        model.decode_step(params, {"tokens": logits[:, -1].argmax(-1, keepdim=True), "pos": 64},
                          cache)
        torch.cuda.synchronize()
    assert moe_route.expert_slots.launches == 2 * cfg.n_layers
