"""K1's packed route (``CapChainStaging``) against the JAX package, on the CPU.

The engine gathers a front into one packed host buffer and rates it in one
call; on the CPU the plain ``cap_chain_front_torch`` reads the same packed
segments.  Its rates must be bit-identical to the JAX package's numpy oracle
``cap_chain_rates_np`` (int64 views, NaN lanes equal as NaN) at every width,
with the inf and NaN lanes and all three ``blk`` modes.  The buffer grows
across rising widths without one segment spilling into another, and the
rates handed back belong to the caller: a later front must not overwrite an
earlier front's result, neither in the staging object nor in the engine.
The ``cuda``-marked test holds the CUDA route to the same oracle.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
import repro_torch.sim as tsim
from repro.kernels import cap_chain as jcc
from repro_torch.kernels import cap_chain as tcc
from repro_torch.sim.vector_engine import VectorTorchFlowSim

from test_torch_cap_chain import CAPS, _assert_bit_identical, _operands

WIDTHS = [0, 1, 255, 257, 4099, 100_000]


def _stage(staging, ops):
    for view, a in zip(staging.segments(ops[0].size), ops):
        view[...] = a
    return staging


@pytest.mark.parametrize("blk_mode", ["mixed", "none", "all"])
@pytest.mark.parametrize("n", WIDTHS)
def test_packed_plain_matches_numpy(n, blk_mode):
    ops = _operands(n, seed=n + 1, blk_mode=blk_mode)
    want = jcc.cap_chain_rates_np(*ops, **CAPS)
    got = _stage(tcc.CapChainStaging("cpu"), ops).rates(**CAPS)
    _assert_bit_identical(got, want)
    # the layout written by hand: five 8-byte segments of n values, then blk
    packed = np.zeros(tcc.packed_front_bytes(n), dtype=np.uint8)
    assert packed.size % 8 == 0 and packed.size >= 41 * n
    for k, (a, dt) in enumerate(zip(ops[:5], [np.int64] * 2 + [np.float64] * 3)):
        packed[8 * n * k:8 * n * (k + 1)] = np.asarray(a, dtype=dt).view(np.uint8)
    packed[40 * n:41 * n] = ops[5].view(np.uint8)
    _assert_bit_identical(tcc.cap_chain_front_torch(torch.from_numpy(packed), n, **CAPS).numpy(), want)


def test_staging_grows_without_corrupting_segments():
    """Rising widths through one staging object: the capacity is the next
    power of two (at least 256) and only grows; every segment reads back
    what was written into it, and every front's rates are exact."""
    staging = tcc.CapChainStaging("cpu")
    caps_seen = []
    for n in (1, 255, 257, 4099, 100_000, 300):
        ops = _operands(n, seed=7 * n, blk_mode="mixed")
        views = staging.segments(n)
        # fill in reverse order: a segment that overlapped the next would
        # overwrite what was written into it
        for view, a in reversed(list(zip(views, ops))):
            view[...] = a
        for view, a in zip(views, ops):
            np.testing.assert_array_equal(view, a)
        _assert_bit_identical(staging.rates(**CAPS), jcc.cap_chain_rates_np(*ops, **CAPS))
        caps_seen.append(staging.capacity)
    assert caps_seen == [256, 256, 512, 8192, 131072, 131072]


def test_earlier_rates_survive_a_later_front():
    staging = tcc.CapChainStaging("cpu")
    first_ops = _operands(257, seed=1)
    first = _stage(staging, first_ops).rates(**CAPS)
    kept = first.copy()
    second = _stage(staging, _operands(257, seed=2)).rates(**CAPS)
    assert not np.shares_memory(first, second)
    _assert_bit_identical(first, kept)
    _assert_bit_identical(first, jcc.cap_chain_rates_np(*first_ops, **CAPS))


def test_engine_front_rates_belong_to_the_caller():
    """Every front's rates from the engine's ``_front_rates``, kept until the
    run ends, still hold what they held when returned, and the operands it
    gathered are the numpy path's."""
    ft = tcore.FunctionTree("f")
    for i in range(40):
        ft.insert(f"vm{i}")
    plan = tcore.faasnet_plan(ft, image_bytes=int(100e6), startup_fraction=0.2)
    cfg = tsim.SimConfig(per_stream_cap=30e6, hop_latency=0.2, registry_qps=1100.0,
                         vector_scalar_cutoff=0, device="cpu")
    sim = VectorTorchFlowSim(cfg)
    seen = []
    rate = sim._front_rates

    def recording(fids, src, dst):
        got = rate(fids, src, dst)
        ops = tuple(a.copy() for a in sim._front_operands(fids, src, dst))
        np.testing.assert_array_equal(ops[0], sim._nout_cnt[src])
        np.testing.assert_array_equal(ops[5], sim._fblk[fids])
        seen.append((got, got.copy(), ops))
        return got

    sim._front_rates = recording
    sim.add_plan(plan)
    sim.run()
    assert len(seen) > 3 and sim.dispatch_stats["fronts_torch"] == len(seen)
    for got, kept, ops in seen:
        _assert_bit_identical(got, kept)
        _assert_bit_identical(kept, jcc.cap_chain_rates_np(*ops, **CAPS | {
            "per_stream_cap": cfg.per_stream_cap, "in_cap": cfg.vm_nic.in_cap,
            "decompress_rate": cfg.decompress_rate, "block_size": cfg.block_size}))


def test_cpu_route_counts_no_launch():
    tcc.reset_launches()
    _stage(tcc.CapChainStaging("cpu"), _operands(300, seed=3)).rates(**CAPS)
    assert tcc.cap_chain_rates.launches == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.cuda
def test_packed_route_matches_numpy_on_card(cuda_device):
    staging = tcc.CapChainStaging(cuda_device)
    tcc.reset_launches()
    launched = 0
    for n in WIDTHS:
        for blk_mode in ("mixed", "none", "all"):
            ops = _operands(n, seed=n + 1, blk_mode=blk_mode)
            got = _stage(staging, ops).rates(**CAPS)
            launched += n > 0
            _assert_bit_identical(got, jcc.cap_chain_rates_np(*ops, **CAPS))
    assert tcc.cap_chain_rates.launches == launched


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(cuda_device):
    ft = tcore.FunctionTree("f")
    for i in range(40):
        ft.insert(f"vm{i}")
    plan = tcore.faasnet_plan(ft, image_bytes=int(100e6), startup_fraction=0.2)
    base = tsim.SimConfig(per_stream_cap=30e6, hop_latency=0.2, vector_scalar_cutoff=0,
                          record_trace=True, device="cpu")
    runs = []
    for cfg in (base, dataclasses.replace(base, device="cuda")):
        sim = VectorTorchFlowSim(cfg)
        sim.add_plan(plan)
        sim.run()
        runs.append(sim)
    assert runs[0].trace == runs[1].trace and runs[0].now == runs[1].now
