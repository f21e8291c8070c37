"""The port's synthetic batches against the JAX package's, bit for bit.

``make_batch`` draws from ``np.random.default_rng(seed)`` in the reference's
order, so tokens, labels, ``patch_embeds`` and ``frames`` must be equal to
the bit (bf16 compared as its 16-bit words), for every arch and every kind.
``batch_specs`` must give the reference's shapes and dtypes, and those of
``make_batch``'s arrays.
"""
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_smoke as jget_smoke
from repro.data import synthetic as jsyn
from repro_torch.configs import get_smoke
from repro_torch.data import synthetic as tsyn
from repro_torch.models.params import tensor_to_numpy

KINDS = ["train", "prefill", "decode"]


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_batch_equals_jax_bit_for_bit(arch, kind):
    for seed, (seq_len, batch) in enumerate([(48, 3), (40, 1)]):
        want = jsyn.make_batch(jget_smoke(arch), seq_len, batch, kind=kind, seed=seed)
        got = tsyn.make_batch(get_smoke(arch), seq_len, batch, kind=kind, seed=seed, device="cpu")
        assert sorted(got) == sorted(want)
        for key in want:
            w, g = np.asarray(want[key]), tensor_to_numpy(got[key])
            assert (g.dtype, g.shape) == (w.dtype, w.shape), key
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=key)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_match_jax_and_make_batch(arch, kind):
    want = jsyn.batch_specs(jget_smoke(arch), 48, 2, kind=kind)
    specs = tsyn.batch_specs(get_smoke(arch), 48, 2, kind=kind)
    batch = tsyn.make_batch(get_smoke(arch), 48, 2, kind=kind, device="cpu")
    assert sorted(specs) == sorted(want) == sorted(batch)
    for key, s in specs.items():
        assert s.device.type == "meta"
        assert tuple(s.shape) == want[key].shape == tuple(batch[key].shape), key
        assert tensor_to_numpy(torch.empty(0, dtype=s.dtype)).dtype == want[key].dtype, key
        assert s.dtype == batch[key].dtype, key


def test_token_stream_steps_the_seed():
    cfg = get_smoke("deepseek_7b")
    stream = tsyn.token_stream(cfg, 16, 2, seed=5, device="cpu")
    jstream = jsyn.token_stream(jget_smoke("deepseek_7b"), 16, 2, seed=5)
    for _ in range(3):
        got, want = next(stream), next(jstream)
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
