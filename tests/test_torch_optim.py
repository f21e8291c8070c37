"""The port's optimizer and gradient compression against the JAX package.

* int8 compression: payloads and scales equal exactly (both packages round
  half to even), ties included; error feedback recovers the cumulative
  gradient, the property of ``tests/test_train.py``;
* ``lr_at`` at the warmup and cosine points within 1e-6;
* ``adamw_update`` from the same numpy grads and state, three steps:
  ``m``, ``v`` and ``master`` within 1e-6 of each leaf's largest magnitude,
  the grad norm within 1e-6 relative, ``step`` and ``lr`` equal.  Not
  bit-equal: the global norm's per-leaf sums run in another order (the
  clip scale may differ in its last bit), and XLA may contract a moment's
  multiply-add that PyTorch rounds twice; where ``0.9·m + 0.1·g`` cancels,
  one rounding step is a large share of a small element.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch.models.params import params_from_numpy, tree_leaves_with_path
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress as tcompress


def _draws(seed):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal(1024).astype(np.float32),
        (rng.standard_normal((7, 33)) * 40).astype(np.float32),
        (rng.standard_normal((3, 5, 129)) * 1e-3).astype(np.float32),
        # exact ties at the rounding point: absmax 127 gives scale 1
        (np.arange(-254, 255) / 2.0).astype(np.float32).reshape(1, -1),
        np.zeros((2, 8), np.float32),
    ]


@pytest.mark.parametrize("i", range(5))
def test_quantize_int8_equals_jax(i):
    x = _draws(0)[i]
    qj, sj = jcompress.quantize_int8(jnp.asarray(x))
    qt, st = tcompress.quantize_int8(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        tcompress.dequantize_int8(qt, st).numpy(), np.asarray(jcompress.dequantize_int8(qj, sj))
    )


def test_compress_error_feedback_equals_jax_and_recovers_the_sum():
    g = np.random.default_rng(1).standard_normal(1024).astype(np.float32)
    gj, gt = jnp.asarray(g), torch.from_numpy(g)
    rj, rt = jnp.zeros_like(gj), torch.zeros_like(gt)
    total = torch.zeros_like(gt)
    for _ in range(20):
        sj, rj = jcompress.compress_error_feedback(gj, rj)
        st, rt = tcompress.compress_error_feedback(gt, rt)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
        total = total + st
    rel = float(torch.linalg.norm(total - 20 * gt) / torch.linalg.norm(20 * gt))
    assert rel < 0.02


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 55, 99, 100, 150])
def test_lr_at_matches_jax(step):
    kw = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    want = float(jadamw.lr_at(jadamw.AdamWConfig(**kw), jnp.asarray(step)))
    got = float(tadamw.lr_at(tadamw.AdamWConfig(**kw), torch.tensor(step)))
    assert got == pytest.approx(want, abs=1e-6)


def test_lr_schedule_shape():
    cfg = tadamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    assert float(tadamw.lr_at(cfg, torch.tensor(0))) == pytest.approx(0.0)
    assert float(tadamw.lr_at(cfg, torch.tensor(10))) == pytest.approx(1.0, abs=1e-2)
    assert float(tadamw.lr_at(cfg, torch.tensor(100))) == pytest.approx(0.1, abs=1e-2)


def _tree(rng):
    return {
        "embed": {"table": rng.standard_normal((16, 8)).astype(np.float32)},
        "stages": [({"w": rng.standard_normal((3, 8, 8)).astype(np.float32)},)],
        "final_norm": {"scale": rng.standard_normal(8).astype(np.float32)},
    }


def test_adamw_update_matches_jax():
    rng = np.random.default_rng(2)
    params = _tree(rng)
    opt = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jstate = jadamw.init_opt_state(jax.tree.map(jnp.asarray, params))
    tstate = tadamw.init_opt_state(params_from_numpy(params, "cpu"))
    assert tstate["step"].dtype == torch.int32 and tstate["step"].shape == ()
    for _ in range(3):
        grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 3).astype(np.float32), params)
        _, jstate, jm = jadamw.adamw_update(jadamw.AdamWConfig(**opt),
                                            jax.tree.map(jnp.asarray, grads), jstate)
        master, tstate, tm = tadamw.adamw_update(tadamw.AdamWConfig(**opt),
                                                 params_from_numpy(grads, "cpu"), tstate)
        assert master is tstate["master"]
        for key in ("m", "v", "master"):
            want = jax.tree.leaves(jstate[key])
            got = [x for _, x in tree_leaves_with_path(tstate[key])]
            assert len(want) == len(got)
            for w, g in zip(want, got):
                w = np.asarray(w)
                np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max())
        assert int(tstate["step"]) == int(jstate["step"])
        assert float(tm["lr"]) == float(jm["lr"])
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
