"""The arithmetic of K5's three passes, on the CPU.

``ref.ssd_scan_tiled_ref`` repeats what the CUDA kernel computes (chunk
states, state passing, 64-row tiles of the chunk scan, bf16 hi + lo terms
of every float32 operand); it is held against the JAX package's Pallas
``ssd_scan_bhtpn`` in interpret mode and its oracle, with inputs drawn by
numpy as ``test_torch_ssd_scan.py`` draws them, at that file's tolerances:
absolute 1e-3 in float32 and 3e-2 in bf16, relative 3e-2.  In float32, where
no operand is rounded, the three-pass decomposition is held against the
per-step recurrence ``ref.ssd_scan_ref`` at 1e-5 (absolute and relative).
The ``cuda``-marked test holds the kernel itself to the tiled version at
``1e-3 + 1e-2 |want|``.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan_bhtpn as jssd
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tss

from test_torch_ssd_scan import DTYPES, _atol, _f32, _flat_jax, _flat_torch, _operands

# (T, H, P, G, N, chunk) at B 2: every P and N class the kernel takes, chunks
# under, at and above the 64-row tile, and one that is not a multiple of it
CASES = [(64, 2, 16, 1, 8, 32), (128, 2, 32, 1, 16, 64), (256, 4, 64, 1, 64, 128),
         (128, 4, 16, 2, 64, 128), (256, 2, 32, 1, 8, 64), (192, 3, 64, 1, 16, 32),
         (200, 2, 32, 1, 16, 100)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("t,h,p,g,n,chunk", CASES)
def test_tiled_ref_matches_jax(t, h, p, g, n, chunk, dtype):
    jin, tin = _operands(2, t, h, p, g, n, dtype, seed=t + h + n)
    flat = _flat_torch(*tin)
    got = tref.ssd_scan_tiled_ref(*flat, q=chunk)
    assert got.dtype == flat[0].dtype and got.shape == flat[0].shape
    assert torch.isfinite(got).all()
    jflat = _flat_jax(*jin)
    pallas = jssd(*jflat, q=chunk, interpret=True)
    oracle = jref.ssd_scan_ref(*jflat)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=_atol(dtype), rtol=3e-2)


@pytest.mark.parametrize("t,h,p,g,n,chunk", CASES + [(512, 2, 64, 1, 128, 256)])
def test_three_pass_decomposition_is_the_recurrence(t, h, p, g, n, chunk):
    _, tin = _operands(1, t, h, p, g, n, "float32", seed=t * n)
    flat = _flat_torch(*tin)
    torch.testing.assert_close(tref.ssd_scan_tiled_ref(*flat, q=chunk), tref.ssd_scan_ref(*flat),
                               atol=1e-5, rtol=1e-5)


def test_bf16_error_is_the_output_rounding():
    """hi + lo keeps each float32 operand to ~2^-16, so against the same
    passes on unrounded operands the bf16 instance differs by about the
    rounding of y to bf16 alone."""
    _, tin = _operands(1, 256, 2, 64, 1, 64, "bfloat16", seed=3)
    flat = _flat_torch(*tin)
    exact = tref.ssd_scan_tiled_ref(*(v.float() for v in flat), q=128)
    got = tref.ssd_scan_tiled_ref(*flat, q=128).float()
    # the output's own rounding to bf16 is the only error left
    ulp = exact.abs().clamp_min(1e-30) * 2.0**-8
    assert ((got - exact).abs() <= ulp).float().mean() > 0.99


@pytest.mark.parametrize("bh,t,p,n,q", [(96, 512, 64, 128, 256), (2, 200, 32, 16, 100),
                                        (4, 64, 16, 8, 1024)])
def test_workspace_holds_the_states_and_cumsums(bh, t, p, n, q):
    """One float32 workspace: a (P, N) state per chunk of every row, then the
    per-step cumulative decay; 6.3 MB of states at the serving shape."""
    chunk = min(q, t)
    assert tss.workspace_floats(bh, t, p, n, q) == bh * (t // chunk) * p * n + bh * t
    if (bh, t) == (96, 512):
        assert bh * (t // chunk) * p * n * 4 == 6_291_456


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("p", tss.SUPPORTED_P)
@pytest.mark.parametrize("n", tss.SUPPORTED_N)
def test_kernel_matches_tiled_ref_on_card(cuda_device, p, n, dtype):
    for t, h, chunk in ((512, 4, 256), (96, 2, 48), (200, 2, 100)):
        _, tin = _operands(1, t, h, p, 1, n, dtype, seed=p + n + t)
        flat = [v.to(cuda_device) for v in _flat_torch(*tin)]
        got = tss.ssd_scan_bhtpn(*flat, q=chunk)
        torch.cuda.synchronize()
        tiled = tref.ssd_scan_tiled_ref(*flat, q=chunk).float()
        assert (got.float() - tiled).abs().le(1e-3 + 1e-2 * tiled.abs()).all(), (t, chunk)
