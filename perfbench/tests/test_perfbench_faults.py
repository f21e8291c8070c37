"""The harness's correctness check, driven end to end on the CPU at small
widths with the chip's look skipped: a sound run comes out correct, and each
fault a serving cell can have, planted under the timed path, comes out not
correct.  The precision control (the reference with fp8 linear layers in the
program's place) reads above the limit that sound runs keep under."""
from __future__ import annotations

import json
import time

import pytest
import torch

from perfbench.tests.smoke import DENSE, MOE, SMOKE_LIMIT, make_root, queue_mix

SEEDS = (2**31 + 101, 7)


# a limit on the mean gap alone, as a cell whose widest gap does not separate
# has: the dense smoke model reads 0-0.0006 on five seeds, its fp8 control
# 0.0022-0.034 (0.015-0.016 on ``SEEDS``)
SMOKE_MEAN_LIMIT = 0.005


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("faults"),
                     {"dense.queue": (DENSE, queue_mix()), "moe.queue": (MOE, queue_mix()),
                      "dense.mean_only": (DENSE, queue_mix())})
    (root / "perfbench/limits/dense.mean_only.json").write_text(
        json.dumps({"served_logit_gap_mean": {"limit": SMOKE_MEAN_LIMIT}}))
    return root


def _run(root, workload, seed):
    from perfbench.run import run_cell

    return run_cell(root, workload, seed, 1.0, False, device="cpu", t0=time.monotonic())


def _broken(kind):
    """``model_for`` with a fault planted in the model the engine drives."""
    import dataclasses

    from repro_torch.serving import engine

    real = engine.model_for

    def model_for(cfg):
        m = real(cfg)
        if kind == "stale_step":  # a decode step hands back its old state
            seen = {}

            def prefill(params, batch, cache_len=None):
                logits, cache = m.prefill(params, batch, cache_len=cache_len)
                seen["logits"] = logits[:, -1:]
                return logits, cache

            return dataclasses.replace(m, prefill=prefill,
                                       decode_step=lambda params, batch, cache:
                                       (seen["logits"], cache))
        if kind == "half_batch":  # the second half of the rows left out
            def prefill(params, batch, cache_len=None):
                toks = batch["tokens"]
                rows = torch.arange(toks.shape[0]) % max(toks.shape[0] // 2, 1)
                return m.prefill(params, {"tokens": toks[rows]}, cache_len=cache_len)

            return dataclasses.replace(m, prefill=prefill)
        if kind == "altered_token":  # one served token changed where it is chosen
            def prefill(params, batch, cache_len=None):
                logits, cache = m.prefill(params, batch, cache_len=cache_len)
                logits = logits.clone()
                last = logits[-1, -1]
                last[last.argmin()] = last.max() + 1
                return logits, cache

            return dataclasses.replace(m, prefill=prefill)
        raise ValueError(kind)

    return model_for


@pytest.mark.parametrize("workload", ["dense.queue", "moe.queue"])
@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_is_correct(root, workload, seed):
    res, _ = _run(root, workload, seed)
    assert res["correct"], res["checks"]
    assert res["checks"]["served_logit_gap"]["value"] <= SMOKE_LIMIT / 2
    assert res["checks"]["compared_tokens"]["value"] >= 20


@pytest.mark.parametrize("kind", ["stale_step", "half_batch", "altered_token"])
def test_planted_fault_is_not_correct(root, monkeypatch, kind):
    from repro_torch.serving import engine

    monkeypatch.setattr(engine, "model_for", _broken(kind))
    res, _ = _run(root, "dense.queue", SEEDS[0])
    assert not res["correct"]
    assert res["checks"]["served_logit_gap"]["value"] > SMOKE_LIMIT


def test_request_that_never_finishes_is_a_failure(root, monkeypatch):
    from repro_torch.serving.engine import ServeEngine

    real = ServeEngine.step_batch

    def drop_one(self):
        done = real(self)
        done[-1].out_tokens.pop()
        return done

    monkeypatch.setattr(ServeEngine, "step_batch", drop_one)
    res, _ = _run(root, "dense.queue", SEEDS[1])
    assert not res["correct"] and res["failed"] >= 1


def _control(root, workload, seed):
    from perfbench.harness import load_cell

    cell = load_cell(root, workload)
    return cell.driver().drive(cell, seed, 1.0, False, "cpu", time.monotonic(), control=True)


def test_precision_control_fails_the_limit(root):
    """On seeds where the program keeps far under the limit, the fp8 control,
    judged as the program is, reads over it and comes out not correct."""
    for seed in SEEDS:
        out = _control(root, "dense.queue", seed)
        assert out["correct"]
        assert out["checks"]["served_logit_gap"]["value"] <= SMOKE_LIMIT / 2
        assert out["control_readings"]["served_logit_gap"] > SMOKE_LIMIT
        assert out["control_correct"] is False


@pytest.mark.parametrize("seed", SEEDS)
def test_precision_control_fails_a_mean_only_limit(root, seed):
    out = _control(root, "dense.mean_only", seed)
    assert out["correct"] and set(out["checks"]) == {
        "served_logit_gap_mean", "failed_requests", "compared_tokens"}
    assert out["control_readings"]["served_logit_gap_mean"] > SMOKE_MEAN_LIMIT
    assert out["control_correct"] is False
