"""Port kernels K1 (cap chain) and K2 (per-NIC flow count) against the JAX package.

The JAX package's oracle on a CPU host is its numpy path
(``cap_chain_rates_np`` / ``nic_flow_counts_np``, and ``cap_chain_rates`` /
``nic_flow_counts``, which take that path where the Pallas kernel cannot
run).  The port's plain PyTorch versions must match it exactly: float64 IEEE
operations in the same operand order give the same bits, so every
comparison here is of the int64 views, with NaN lanes equal as NaN.  The
CUDA kernels are held against the plain versions by the ``cuda``-marked
test, which runs only where a card is present.
"""
import numpy as np
import pytest
import torch

from repro.kernels import cap_chain as jcc
from repro_torch.kernels import cap_chain as tcc

CAPS = dict(
    per_stream_cap=30e6,
    in_cap=1.25e8,
    decompress_rate=2e9,
    block_size=float(512 * 1024),
)


def _operands(n: int, seed: int, count_dtype=np.int64, *, blk_mode="mixed"):
    """Seeded front operands with the edge lanes the engine produces."""
    rng = np.random.default_rng(seed)
    n_out = rng.integers(1, 50, n).astype(count_dtype)
    n_in = rng.integers(1, 50, n).astype(count_dtype)
    out_cap = rng.uniform(1e6, 2e9, n)
    qps = rng.uniform(100.0, 5000.0, n)
    par = rng.uniform(1e6, 2e8, n)
    # VM sources have qps=inf; roots have no parent (par=+inf); uncapped
    # registry shards have out_cap=inf.
    out_cap[rng.random(n) < 0.1] = np.inf
    qps[rng.random(n) < 0.3] = np.inf
    par[rng.random(n) < 0.3] = np.inf
    if n > 3:
        out_cap[n // 3] = np.nan  # NaN must propagate like np.minimum
        par[n // 2] = np.nan
    blk = {
        "mixed": rng.random(n) < 0.5,
        "none": np.zeros(n, dtype=bool),
        "all": np.ones(n, dtype=bool),
    }[blk_mode]
    return n_out, n_in, out_cap, qps, par, blk


def _bits(a) -> np.ndarray:
    a = np.asarray(a, dtype=np.float64)
    return np.where(np.isnan(a), np.nan, a).view(np.int64)


def _assert_bit_identical(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _torch_args(ops):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in ops]


@pytest.mark.parametrize("n", [1, 255, 256, 257, 4099])
@pytest.mark.parametrize("count_dtype", [np.int64, np.int32, np.int16, np.uint8])
@pytest.mark.parametrize("blk_mode", ["mixed", "none", "all"])
def test_cap_chain_plain_matches_numpy(n, count_dtype, blk_mode):
    ops = _operands(n, seed=n, count_dtype=count_dtype, blk_mode=blk_mode)
    want = jcc.cap_chain_rates_np(*ops, **CAPS)
    _assert_bit_identical(jcc.cap_chain_rates(*ops, **CAPS), want)
    got = tcc.cap_chain_rates_torch(*_torch_args(ops), **CAPS)
    _assert_bit_identical(got.numpy(), want)
    # the public wrapper takes the plain version for CPU tensors
    _assert_bit_identical(tcc.cap_chain_rates(*_torch_args(ops), **CAPS).numpy(), want)


def test_cap_chain_plain_divides_like_ieee_on_100k_lanes():
    """A Python float divided by a tensor is reciprocal-then-multiply in torch.

    The plain version must divide a float64 tensor by a tensor instead; on
    100,000 seeded lanes that is the difference between thousands of
    last-bit mismatches and none.
    """
    ops = _operands(100_000, seed=11)
    want = jcc.cap_chain_rates_np(*ops, **CAPS)
    got = tcc.cap_chain_rates_torch(*_torch_args(ops), **CAPS)
    _assert_bit_identical(got.numpy(), want)


@pytest.mark.parametrize("n_nodes", [1, 7, 300])
@pytest.mark.parametrize("n", [0, 1, 257, 4099])
def test_nic_flow_counts_plain_matches_numpy(n, n_nodes):
    nodes = np.random.default_rng(n + n_nodes).integers(0, n_nodes, n)
    want = jcc.nic_flow_counts_np(nodes, n_nodes)
    np.testing.assert_array_equal(jcc.nic_flow_counts(nodes, n_nodes), want)
    for fn in (tcc.nic_flow_counts_torch, tcc.nic_flow_counts):
        got = fn(torch.from_numpy(nodes), n_nodes)
        assert got.dtype == torch.int64 and got.shape == (n_nodes,)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", [-1, 5])
def test_nic_flow_counts_rejects_out_of_range(bad):
    nodes = torch.tensor([0, 1, bad, 2])
    with pytest.raises(IndexError):
        tcc.nic_flow_counts(nodes, 5)


def test_launch_counters_stay_zero_on_cpu():
    tcc.reset_launches()
    ops = _torch_args(_operands(300, seed=1))
    tcc.cap_chain_rates(*ops, **CAPS)
    tcc.nic_flow_counts(torch.arange(10) % 3, 3)
    assert tcc.cap_chain_rates.launches == 0
    assert tcc.nic_flow_counts.launches == 0


def test_cap_chain_rejects_mismatched_operands():
    ops = _torch_args(_operands(16, seed=2))
    with pytest.raises((TypeError, ValueError)):
        tcc._check_cap_chain_operands(*ops[:5], ops[5][:8])
    with pytest.raises(TypeError):
        tcc._check_cap_chain_operands(ops[0].double(), *ops[1:])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 257, 901, 100_000])
def test_kernels_match_plain_on_card(cuda_device, n):
    ops = _operands(n, seed=n)
    dev_ops = [t.to(cuda_device) for t in _torch_args(ops)]
    tcc.reset_launches()
    got = tcc.cap_chain_rates(*dev_ops, **CAPS)
    torch.cuda.synchronize()
    assert tcc.cap_chain_rates.launches == 1
    _assert_bit_identical(got.cpu().numpy(), tcc.cap_chain_rates_torch(*dev_ops, **CAPS).cpu().numpy())
    _assert_bit_identical(got.cpu().numpy(), jcc.cap_chain_rates_np(*ops, **CAPS))
    nodes = torch.from_numpy(np.random.default_rng(n).integers(0, 97, n)).to(cuda_device)
    counts = tcc.nic_flow_counts(nodes, 97)
    assert tcc.nic_flow_counts.launches == 1
    assert torch.equal(counts, tcc.nic_flow_counts_torch(nodes, 97))
