"""Port kernel K5 (Mamba2 SSD scan) against the JAX package.

On the CPU the port's ``ops.ssd_scan`` runs the kernel's plain version (the
per-step recurrence); it is held against the JAX package's Pallas kernel in
interpret mode and its ``ref.ssd_scan_ref`` on the sweep of
``tests/test_kernels.py``, with inputs drawn by numpy, at that file's
tolerances: absolute 1e-3 in float32 and 3e-2 in bf16, relative 3e-2.  The
port's ``mamba2.ssd_chunked`` is held against the Pallas kernel at 1e-3, as
there.  The CUDA kernel is held against the plain version by the
``cuda``-marked tests, which run only where a card is present.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tss
from repro_torch.models.mamba2 import ssd_chunked

SWEEP = [(256, 4, 64, 1, 32, 64), (128, 2, 32, 2, 16, 32), (512, 4, 64, 1, 64, 128)]
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}


def _atol(dtype: str) -> float:
    return 3e-2 if dtype == "bfloat16" else 1e-3


def _operands(b, t, h, p, g, n, dtype: str, seed: int):
    """x, dt, a, B, C drawn with numpy as tests/test_kernels.py draws them with
    jax.random; x, B and C rounded once to ``dtype``, dt and a float32."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    x = torch.from_numpy(rng.standard_normal((b, t, h, p), dtype=np.float32)).to(tdt)
    dt = torch.from_numpy((np.logaddexp(rng.standard_normal((b, t, h)), 0.0) * 0.1).astype(np.float32))
    a = torch.from_numpy(-np.exp(rng.standard_normal(h)).astype(np.float32))
    bm = torch.from_numpy(rng.standard_normal((b, t, g, n), dtype=np.float32)).to(tdt)
    cm = torch.from_numpy(rng.standard_normal((b, t, g, n), dtype=np.float32)).to(tdt)
    jax_in = (jnp.asarray(x.float().numpy()).astype(jdt), jnp.asarray(dt.numpy()),
              jnp.asarray(a.numpy()), jnp.asarray(bm.float().numpy()).astype(jdt),
              jnp.asarray(cm.float().numpy()).astype(jdt))
    return jax_in, (x, dt, a, bm, cm)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _flat_torch(x, dt, a, bm, cm):
    """The (B*H, ...) operands the port's ``ops.ssd_scan`` hands the wrapper."""
    b, t, h, p = x.shape
    rep = h // bm.shape[2]

    def heads(m):
        return torch.repeat_interleave(m, rep, dim=2).permute(0, 2, 1, 3).reshape(b * h, t, -1)

    return (x.permute(0, 2, 1, 3).reshape(b * h, t, p), dt.permute(0, 2, 1).reshape(b * h, t, 1),
            a[None].expand(b, h).reshape(b * h, 1), heads(bm), heads(cm))


def _flat_jax(x, dt, a, bm, cm):
    b, t, h, p = x.shape
    n = bm.shape[3]
    rep = h // bm.shape[2]
    return (x.transpose(0, 2, 1, 3).reshape(b * h, t, p), dt.transpose(0, 2, 1).reshape(b * h, t, 1),
            jnp.broadcast_to(a[None], (b, h)).reshape(b * h, 1),
            jnp.repeat(bm, rep, axis=2).transpose(0, 2, 1, 3).reshape(b * h, t, n),
            jnp.repeat(cm, rep, axis=2).transpose(0, 2, 1, 3).reshape(b * h, t, n))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("t,h,p,g,n,chunk", SWEEP)
def test_ssd_scan_matches_jax(t, h, p, g, n, chunk, dtype):
    b = 2
    jin, tin = _operands(b, t, h, p, g, n, dtype, seed=t + h)
    got = tops.ssd_scan(*tin, chunk=chunk)
    assert got.dtype == tin[0].dtype and got.shape == (b, t, h, p)
    pallas = jops.ssd_scan(*jin, chunk=chunk, interpret=True)
    oracle = jref.ssd_scan_ref(*_flat_jax(*jin)).reshape(b, h, t, p).transpose(0, 2, 1, 3)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=_atol(dtype), rtol=3e-2)


def test_model_chunked_path_matches_the_jax_kernel():
    """The port's ``ssd_chunked`` (its model's SSD) against the Pallas kernel,
    as tests/test_kernels.py holds the JAX package's ``ssd_chunked`` to it."""
    jin, tin = _operands(1, 128, 2, 32, 1, 16, "float32", seed=0)
    y_model, _ = ssd_chunked(*tin, chunk=32)
    y_kernel = jops.ssd_scan(*jin, chunk=32, interpret=True)
    np.testing.assert_allclose(_f32(y_model), _f32(y_kernel), atol=1e-3, rtol=1e-3)


def test_plain_version_is_the_oracle_and_launches_stay_zero():
    tss.reset_launches()
    _, tin = _operands(1, 64, 3, 16, 1, 8, "float32", seed=5)
    flat = _flat_torch(*tin)
    got = tss.ssd_scan_bhtpn(*flat, q=16)
    assert torch.equal(got, tref.ssd_scan_ref(*flat))
    assert tss.ssd_scan_bhtpn.launches == 0


@pytest.mark.parametrize(
    "t,q,dt_shape,a_shape,bc_t",
    [(100, 64, None, None, None), (64, 0, None, None, None), (64, 32, (6, 64), None, None),
     (64, 32, None, (6,), None), (64, 32, None, None, 63)],
    ids=["T_not_multiple_of_q", "q_0", "dt_not_bh_t_1", "a_not_bh_1", "bc_length"],
)
def test_wrapper_rejects_what_the_pallas_wrapper_rejects(t, q, dt_shape, a_shape, bc_t):
    x = torch.zeros((6, t, 16))
    dt = torch.zeros(dt_shape or (6, t, 1))
    a = torch.zeros(a_shape or (6, 1))
    bc = torch.zeros((6, bc_t or t, 8))
    with pytest.raises(ValueError):
        tss.ssd_scan_bhtpn(x, dt, a, bc, bc, q=q)


@pytest.mark.parametrize(
    "p,n,dtype,q", [(24, 16, torch.float32, 64), (64, 256, torch.float32, 64),
                    (64, 128, torch.float16, 64), (32, 16, torch.float32, 2048)],
    ids=["P_24", "N_256", "float16", "chunk_2048"],
)
def test_kernel_rejects_unsupported_operands(p, n, dtype, q):
    t = 4096
    x = torch.zeros((2, t, p), dtype=dtype)
    bc = torch.zeros((2, t, n), dtype=dtype)
    with pytest.raises(ValueError):
        tss.check_kernel_operands(x, torch.zeros((2, t, 1)), torch.zeros((2, 1)), bc, bc, q)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,t,h,p,g,n,chunk", [(2, *c) for c in SWEEP] + [
    (4, 512, 24, 64, 1, 128, 256),  # mamba2_130m at full width
    (1, 96, 4, 16, 1, 8, 256),      # a chunk longer than T, as the smoke prompts
    (1, 200, 2, 32, 1, 16, 100),    # a chunk that is not a multiple of the 64-row tile
])
def test_kernel_matches_plain_on_card(cuda_device, b, t, h, p, g, n, chunk, dtype):
    _, tin = _operands(b, t, h, p, g, n, dtype, seed=t + n)
    tin = [v.to(cuda_device) for v in tin]
    tss.reset_launches()
    got = tops.ssd_scan(*tin, chunk=chunk)
    torch.cuda.synchronize()
    assert tss.ssd_scan_bhtpn.launches == 1
    want = tss.ssd_scan_torch(*_flat_torch(*tin)).reshape(b, h, t, p).permute(0, 2, 1, 3)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=_atol(dtype), rtol=3e-2)


@pytest.mark.cuda
def test_kernel_matches_model_chunked_path_on_card(cuda_device):
    _, tin = _operands(1, 128, 2, 32, 1, 16, "float32", seed=0)
    tin = [v.to(cuda_device) for v in tin]
    y_model, _ = ssd_chunked(*tin, chunk=32)
    torch.testing.assert_close(tops.ssd_scan(*tin, chunk=32), y_model, atol=1e-3, rtol=1e-3)
