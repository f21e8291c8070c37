"""The port's training path against the JAX package.

One train step (two microbatches of 2 x 32 tokens, AdamW with no warmup)
per smoke config, from the same numpy params, optimizer state and batch,
against the JAX package's ``make_train_step`` under ``jax.jit``.  The first
step's ``m`` is ``(1 - b1) · clip scale · grad``, so it holds the gradient.
The float32 step runs also
through ``attn_impl="chunked"``, the full configs' attention.  Limits:

* float32: loss 1e-6 relative, every gradient leaf (``m``) within 2e-4 of
  its largest |g| (a CPU probe's worst was 8.8e-5, jamba's), the updated
  params within ``2·lr + 1e-6`` (step 1 of Adam is ``lr·sign(g)``, and a
  near-zero gradient may flip sign);
* bf16 (``test_torch_train_bf16.py``): loss 2e-3 relative and params
  2e-2 absolute.

The reference runs with ``remat="none"``: ``jax.checkpoint`` changes what
XLA keeps, not a value, and compiles slower.  The port runs each config's
own ``remat="block"``, and its gradients are held bit for bit against
``remat="none"``.  Then the copies of ``tests/test_train.py`` (loss goes
down, ``n_micro`` 1 against 4, restart after a failure resumes exactly) on
``device="cpu"``; a checkpoint written by the JAX package's ``run_train``
resumed by the port's; ``attn_impl="pallas"`` refused under autograd by
both packages; and the launcher.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.configs import ModelConfig as JModelConfig
from repro.configs import get_smoke as jget_smoke
from repro.data.synthetic import make_batch as jmake_batch
from repro.models import model_for as jmodel_for
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train.step import init_train_state as jinit_train_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.checkpoint import manager as tckpt
from repro_torch.configs import ModelConfig, get_smoke
from repro_torch.data.synthetic import make_batch
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import model_for, params_from_numpy
from repro_torch.models.params import tree_leaves_with_path, tree_unflatten
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import SimulatedFailure, run_train
from repro_torch.train.step import init_train_state, make_train_step

ARCHS = ["deepseek_7b", "granite_moe_1b", "mamba2_130m", "jamba_v01_52b", "gemma3_1b",
         "llava_next_mistral_7b", "whisper_medium"]
SEQ, BATCH, N_MICRO, LR = 32, 4, 2, 1e-3
OPT = dict(lr=LR, warmup_steps=0, total_steps=10)

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab_size=128, attn_impl="full", remat="none")
JTINY, TTINY = JModelConfig(**TINY), ModelConfig(**TINY)


def _jleaves(tree) -> list[np.ndarray]:
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _tleaves(tree) -> list[np.ndarray]:
    return [x.float().numpy() for _, x in tree_leaves_with_path(tree)]


def step_both(arch: str, dtype: str, **over) -> dict:
    jcfg = dataclasses.replace(jget_smoke(arch), compute_dtype=dtype, remat="none", **over)
    tcfg = dataclasses.replace(get_smoke(arch), compute_dtype=dtype, **over)
    assert tcfg.remat == "block"
    params, opt_state = jinit_train_state(jcfg, jax.random.key(0))
    np_params, np_opt = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt_state)
    _, jstep = jmake_train_step(jcfg, None, opt=JAdamWConfig(**OPT), n_micro=N_MICRO)
    jp, jo, jm = jax.jit(jstep)(params, opt_state,
                                jmake_batch(jcfg, SEQ, BATCH, kind="train", seed=1))
    _, tstep = make_train_step(tcfg, None, opt=AdamWConfig(**OPT), n_micro=N_MICRO)
    tp, to, tm = tstep(params_from_numpy(np_params, "cpu"), params_from_numpy(np_opt, "cpu"),
                       make_batch(tcfg, SEQ, BATCH, kind="train", seed=1, device="cpu"))
    assert all(p.dtype == getattr(torch, dtype) for _, p in tree_leaves_with_path(tp))
    assert int(to["step"]) == int(jo["step"]) == 1
    return {"loss": (float(jm["loss"]), float(tm["loss"])),
            "grad_norm": (float(jm["grad_norm"]), float(tm["grad_norm"])),
            "lr": (float(jm["lr"]), float(tm["lr"])),
            "grads": (_jleaves(jo["m"]), _tleaves(to["m"])),
            "paths": [p for p, _ in tree_leaves_with_path(to["m"])],
            "params": (_jleaves(jp), _tleaves(tp))}


# Leaves the loss never reads: whisper's cross-attention q/k/v biases (the
# reference adds none of them).  Their gradient is zero in both packages.
UNUSED = {("dec_layers", "cross_attn", b) for b in ("bq", "bk", "bv")}
# A key bias adds the same amount to every logit of a query, which the
# softmax cancels: its gradient is zero but for rounding (~1e-11 in whisper's
# smoke config), so it is held against the step's largest gradient instead
# of its own largest element.
KEY_BIAS = {("enc_layers", "attn", "bk"), ("dec_layers", "self_attn", "bk")}

# the full configs train through "chunked" attention (the smoke configs set
# "full"): 8-token tiles over 32 tokens, gemma3's sliding window included
CHUNKED = [(arch, {"attn_impl": "chunked", "attn_chunk": 8})
           for arch in ("granite_moe_1b", "gemma3_1b")]


@pytest.mark.parametrize("arch, over", [(a, {}) for a in ARCHS] + CHUNKED,
                         ids=ARCHS + [f"{a}-chunked" for a, _ in CHUNKED])
def test_train_step_matches_jax_float32(arch, over):
    out = step_both(arch, "float32", **over)
    want, got = out["loss"]
    assert got == pytest.approx(want, rel=1e-6)
    assert out["lr"][1] == out["lr"][0]
    assert out["grad_norm"][1] == pytest.approx(out["grad_norm"][0], rel=1e-5)
    want, got = out["grads"]
    assert len(want) == len(got) == len(out["paths"])
    top = max(float(np.abs(w).max()) for w in want)
    for path, w, g in zip(out["paths"], want, got):
        assert w.shape == g.shape
        if path in KEY_BIAS:
            assert max(np.abs(w).max(), np.abs(g).max()) <= 1e-6 * top, path
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4 * np.abs(w).max())
    want, got = out["params"]
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * LR + 1e-6)


def _grads(cfg, params, batch) -> list[torch.Tensor]:
    live = [p.detach().requires_grad_() for _, p in tree_leaves_with_path(params)]
    loss, _ = model_for(cfg).loss(tree_unflatten(params, live), batch)
    return list(torch.autograd.grad(loss, live, allow_unused=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_block_grads_equal_none(arch, dtype):
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype=dtype)
    params, _ = init_train_state(cfg, torch.Generator().manual_seed(0))
    batch = make_batch(cfg, SEQ, 2, kind="train", seed=3, device="cpu")
    with_remat = _grads(dataclasses.replace(cfg, remat="block"), params, batch)
    without = _grads(dataclasses.replace(cfg, remat="none"), params, batch)
    paths = [p for p, _ in tree_leaves_with_path(params)]
    assert len(with_remat) == len(without) == len(paths)
    for path, a, b in zip(paths, with_remat, without):
        if path in UNUSED:
            assert a is None and b is None
        else:
            assert a is not None and torch.equal(a, b), path


def test_remat_block_keeps_only_block_inputs():
    """Under remat the backward recomputes each block: the forward saves fewer tensors."""
    cfg = dataclasses.replace(get_smoke("deepseek_7b"), compute_dtype="float32")
    params, _ = init_train_state(cfg, torch.Generator().manual_seed(0))
    batch = make_batch(cfg, SEQ, 2, kind="train", seed=3, device="cpu")
    saved = {}
    for remat in ("block", "none"):
        count = [0]

        def pack(x, count=count):
            count[0] += 1
            return x

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            live = [p.detach().requires_grad_() for _, p in tree_leaves_with_path(params)]
            model_for(dataclasses.replace(cfg, remat=remat)).loss(tree_unflatten(params, live), batch)
        saved[remat] = count[0]
    assert saved["block"] < saved["none"] / 2, saved


def test_microbatch_equivalence():
    """n_micro=1 vs n_micro=4 produce (nearly) the same update."""
    batch = make_batch(TTINY, 64, 8, kind="train", device="cpu")
    out = []
    for n in (1, 4):
        _, step = make_train_step(TTINY, None, n_micro=n)
        params, opt = init_train_state(TTINY, torch.Generator().manual_seed(0))
        out.append(step(params, opt, batch)[0])
    for (_, a), (_, b) in zip(tree_leaves_with_path(out[0]), tree_leaves_with_path(out[1])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=2e-2)


def test_mesh_is_not_ported():
    """The mesh branch is ported now; the test keeps its name.  On a dense
    config the mesh step's values are the ``mesh=None`` step's bit for bit,
    outside and inside the sharding context (``tests/test_torch_moe_mesh.py``
    holds the MoE case against the JAX package)."""
    from repro_torch.distributed.api import sharding_context
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    batch = make_batch(TTINY, 16, 4, kind="train", seed=3, device="cpu")
    runs = []
    for m, ctx in ((None, False), (mesh, False), (mesh, True)):
        params, opt_state = init_train_state(TTINY, torch.Generator().manual_seed(0))
        _, step = make_train_step(TTINY, m, opt=AdamWConfig(**OPT), n_micro=2)
        if ctx:
            with sharding_context(mesh, ShardingRules(TTINY, mesh).logical_mapping()):
                runs.append(step(params, opt_state, batch))
        else:
            runs.append(step(params, opt_state, batch))
    (p0, o0, m0) = runs[0]
    for p1, o1, m1 in runs[1:]:
        assert torch.equal(m0["loss"], m1["loss"])
        for tree0, tree1 in ((p0, p1), (o0, o1)):
            for (_, a), (_, b) in zip(tree_leaves_with_path(tree0), tree_leaves_with_path(tree1)):
                assert torch.equal(a, b)


def test_loss_decreases():
    res = run_train(TTINY, steps=30, seq_len=64, batch=4, log_every=1, device="cpu",
                    opt=AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=30))
    assert res.losses[30] < res.losses[1] - 0.5, (res.losses[1], res.losses[30])


def test_checkpoint_restart_resumes_exactly(tmp_path):
    """Restart after an injected failure reproduces the uninterrupted run."""
    opt = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=20)
    kw = dict(steps=20, seq_len=32, batch=4, ckpt_every=10, log_every=1, opt=opt, device="cpu")
    ref = run_train(TTINY, ckpt_dir=str(tmp_path / "ref"), **kw)
    with pytest.raises(SimulatedFailure):
        run_train(TTINY, ckpt_dir=str(tmp_path / "ft"), fail_at_step=13, async_save=True, **kw)
    res = run_train(TTINY, ckpt_dir=str(tmp_path / "ft"), **kw)
    assert res.resumed_from == 10 and res.steps_run == 10
    assert res.losses[20] == pytest.approx(ref.losses[20], abs=1e-4)
    assert [res.losses[s] for s in range(11, 21)] == [ref.losses[s] for s in range(11, 21)]


def _jax_run(cfg, opt, steps: int, seq_len: int, batch: int, ckpt_dir=None, ckpt_every=10,
             seed: int = 0) -> dict[int, float]:
    """The JAX package's ``run_train`` loop, step for step, with a jit that
    donates nothing: its own jit donates params and optimizer state, which
    share buffers when the compute dtype is float32 (``init_train_state``'s
    cast is then a no-op), and XLA refuses to donate a buffer twice."""
    _, step_fn = jmake_train_step(cfg, None, opt=opt)
    step_fn = jax.jit(step_fn)
    params, opt_state = jinit_train_state(cfg, jax.random.key(seed))
    mgr = jckpt.CheckpointManager(ckpt_dir) if ckpt_dir else None
    losses = {}
    for step in range(steps):
        b = jmake_batch(cfg, seq_len, batch, kind="train", seed=seed * 100_003 + step)
        params, opt_state, metrics = step_fn(params, opt_state, b)
        losses[step + 1] = float(metrics["loss"])
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt_state})
    return losses


def test_port_resumes_a_jax_training_checkpoint(tmp_path):
    """A float32 run of the JAX package checkpoints at step 10 and 20; the
    port's run_train resumes from the step-10 checkpoint alone and follows
    the JAX run's losses to step 20."""
    cfg = dict(TINY, compute_dtype="float32")
    jcfg, tcfg = JModelConfig(**cfg), ModelConfig(**cfg)
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=20)
    ref = _jax_run(jcfg, JAdamWConfig(**opt), 20, 32, 4, ckpt_dir=str(tmp_path))
    mgr = tckpt.CheckpointManager(str(tmp_path))
    for suffix in ("blocks", "json"):  # keep only the step-10 checkpoint
        (tmp_path / f"ckpt_{20:08d}.{suffix}").unlink()
    assert mgr.latest_step() == 10
    res = run_train(tcfg, steps=20, seq_len=32, batch=4, ckpt_dir=str(tmp_path),
                    ckpt_every=10, log_every=1, opt=AdamWConfig(**opt), device="cpu")
    assert res.resumed_from == 10 and sorted(res.losses) == list(range(11, 21))
    for s in range(11, 21):
        assert res.losses[s] == pytest.approx(ref[s], rel=1e-3), s


def test_pallas_refused_under_autograd_in_both_packages():
    jcfg = dataclasses.replace(jget_smoke("deepseek_7b"), attn_impl="pallas",
                               compute_dtype="float32", remat="none")
    tcfg = dataclasses.replace(get_smoke("deepseek_7b"), attn_impl="pallas",
                               compute_dtype="float32")
    jm = jmodel_for(jcfg)
    jparams = jm.init(jax.random.key(0))
    jbatch = jmake_batch(jcfg, SEQ, 2, kind="train")
    # the JAX package's Pallas kernel has no backward; the error is JAX's own
    with pytest.raises(Exception):
        jax.grad(lambda p: jm.loss(p, jbatch)[0])(jparams)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    batch = make_batch(tcfg, SEQ, 2, kind="train", device="cpu")
    with pytest.raises(NotImplementedError, match="no backward"):
        _grads(tcfg, params, batch)
    with pytest.raises(NotImplementedError, match="no backward"):
        make_train_step(tcfg)[1](params, init_train_state(tcfg, torch.Generator())[1], batch)
    # without autograd the kernel's plain version serves, as before
    with torch.no_grad():
        loss, _ = model_for(tcfg).loss(params, batch)
    want, _ = jax.jit(jm.loss)(jparams, jbatch)
    assert float(loss) == pytest.approx(float(want), rel=1e-5)


def test_kernel_wrappers_refuse_operands_that_require_grad():
    rng = np.random.default_rng(0)

    def draw(*shape, grad=False):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).requires_grad_(grad)

    q, k, v = draw(1, 2, 16, 32, grad=True), draw(1, 2, 16, 32), draw(1, 2, 16, 32)
    calls = {
        "flash_attention_bhtd": lambda: ops.flash_attention(q, k, v, scale=0.2),
        "decode_attention_bhsd": lambda: ops.decode_attention(
            q[:, :, :1], k, v, torch.ones(16, dtype=torch.int32), scale=0.2),
        "ssd_scan_bhtpn": lambda: ops.ssd_scan(
            draw(1, 16, 2, 8, grad=True), draw(1, 16, 2).abs(), -draw(2).abs(),
            draw(1, 16, 1, 4), draw(1, 16, 1, 4), chunk=8),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match=name):
            call()
        with torch.no_grad():
            assert torch.isfinite(call()).all()


def test_run_train_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: run_train(device='cuda') runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_train(TTINY, steps=1)


def test_launcher_trains_whisper_on_cpu(capsys):
    """The encoder-decoder family through the launcher: its batches carry frames."""
    launch_train.main(["--arch", "whisper_medium", "--steps", "2", "--seq-len", "32",
                       "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "training whisper_medium_smoke" in out and "on cpu" in out
    losses = [float(line.split()[-1]) for line in out.splitlines() if line.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_launcher_trains_and_resumes_on_cpu(tmp_path, capsys):
    args = ["--arch", "deepseek_7b", "--steps", "4", "--seq-len", "32", "--batch", "2",
            "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    with pytest.raises(SimulatedFailure):
        launch_train.main(args + ["--fail-at", "3"])
    launch_train.main(args)
    out = capsys.readouterr().out
    assert "training deepseek_7b_smoke" in out and "on cpu" in out
    assert "step      4  loss" in out and "(resumed from checkpoint step 2)" in out
