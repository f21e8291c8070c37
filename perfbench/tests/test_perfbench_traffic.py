"""The traffic generator: deterministic per seed, keeping to its parameters,
and giving every seed the same set of sizes and arrivals."""
from __future__ import annotations

import json
from collections import Counter

import numpy as np
import pytest

from perfbench import traffic
from perfbench.harness import find
from perfbench.tests.smoke import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
SECONDS = BENCH["run_seconds"]
# every mix kept, those of held-back cells too
MIXES = sorted(p.stem for p in (REPO / "perfbench" / "traffic").glob("*.json"))


def _mix(name):
    return json.loads(find(REPO, "traffic", name, ".json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_deterministic_per_seed_and_same_sizes_across_seeds(name):
    mix = _mix(name)
    a = traffic.generate(mix, SECONDS, 2**31 + 11, 1000)
    b = traffic.generate(mix, SECONDS, 2**31 + 11, 1000)
    c = traffic.generate(mix, SECONDS, 5, 1000)
    assert [(x.due_s, x.prompt_len, x.max_new) for x in a] == \
        [(x.due_s, x.prompt_len, x.max_new) for x in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    assert [x.due_s for x in a] == [x.due_s for x in c]
    assert Counter((x.prompt_len, x.max_new) for x in a) == \
        Counter((x.prompt_len, x.max_new) for x in c)
    same_order = [(x.prompt_len, x.max_new) for x in a] == [(x.prompt_len, x.max_new) for x in c]
    assert same_order == (mix["shuffle_block"] == 1)
    assert not all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))
    block = mix["shuffle_block"]
    for i in range(0, len(a), block):
        assert sorted(x.prompt_len for x in a[i:i + block]) == \
            sorted(x.prompt_len for x in c[i:i + block])


@pytest.mark.parametrize("name", MIXES)
def test_sizes_within_range(name):
    mix = _mix(name)
    reqs = traffic.generate(mix, SECONDS, 3, 1000)
    spec = mix["prompt_tokens"]
    lens = np.array([r.prompt_len for r in reqs])
    # the port's flash-attention tile: a padded length is a multiple of 128
    assert (lens % 128 == 0).all() and lens.min() >= spec["min"] and lens.max() <= spec["max"]
    assert all(len(r.prompt) == r.prompt_len and r.prompt.min() >= 1 and r.prompt.max() < 1000
               for r in reqs)
    assert len(set(lens.tolist())) > 3  # spread over the range, not one length
    news = [r.max_new for r in reqs]
    ns = mix["new_tokens"]
    if ns["dist"] == "fixed":
        assert set(news) == {ns["value"]}
    else:
        assert min(news) >= ns["min"] and max(news) <= ns["max"]


@pytest.mark.parametrize("name", [m for m in MIXES if _mix(m)["arrival"] == "poisson_bursts"])
def test_open_loop_rate_and_burst_share(name):
    mix = _mix(name)
    rng = np.random.default_rng(0)
    horizon = 4000.0
    due = traffic.arrival_times(mix, horizon, rng)
    assert np.all(np.diff(due) >= 0) and due.min() >= 0 and due.max() < horizon
    assert abs(len(due) / horizon / mix["rate_per_s"] - 1) < 0.05
    # requests with half a smallest burst or more within a burst's spread
    spread = mix["burst_spread_s"]
    near = np.searchsorted(due, due + spread) - np.searchsorted(due, due - spread) - 1
    in_bursts = (near >= mix["burst_size"][0] // 2).mean()
    assert abs(in_bursts - mix["burst_share"]) < 0.1
    # every run window holds enough requests for its 90th percentile: a
    # dozen or more lie beyond it
    assert len(traffic.generate(mix, SECONDS, 1, 1000)) >= 128


@pytest.mark.parametrize("name", [m for m in MIXES if _mix(m)["arrival"] == "backlog"])
def test_backlog_outlasts_the_window(name):
    mix = _mix(name)
    reqs = traffic.generate(mix, SECONDS, 1, 1000)
    assert all(r.due_s == 0 for r in reqs) and mix["close"] == "cut"
    # batches of 4 decode to their longest budget; at a 5 ms step, under a
    # third of today's, the queue takes longer than the window to serve
    steps = sum(max(r.max_new for r in reqs[i:i + 4]) for i in range(0, len(reqs), 4))
    assert steps * 0.005 > SECONDS
