"""One bf16 train step of the port per smoke config against the JAX package's.

The float32 step, its gradients and its limits are in ``test_torch_train.py``;
this file holds the same step in bf16, on its own so that the two sets of
reference compiles can run in parallel.  Limits: loss 2e-3 relative, the
updated params 2e-2 absolute.  Single gradient leaves differ by bf16
rounding, up to half their largest |g| (XLA keeps some bf16 chains in
float32 where PyTorch rounds after each op), so bf16 is not gated on
gradients.
"""
import numpy as np
import pytest

from test_torch_train import ARCHS, step_both


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax_bf16(arch):
    out = step_both(arch, "bfloat16")
    want, got = out["loss"]
    assert got == pytest.approx(want, rel=2e-3)
    assert out["grad_norm"][1] == pytest.approx(out["grad_norm"][0], rel=2e-2)
    want, got = out["params"]
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.shape == g.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-2)
