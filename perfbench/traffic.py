"""The one traffic generator: a traffic mix's parameter file in, requests out.

A mix is a JSON file ``perfbench/traffic/<name>.json``.  Its keys:

* ``driver``: the file under ``perfbench/drivers/`` that serves it.
* ``arrival``: ``poisson_bursts`` (open loop: a Poisson background plus
  bursts) or ``backlog`` (every request due at t = 0).
  - ``poisson_bursts``: ``rate_per_s`` (mean rate of all requests),
    ``burst_share`` (the share of requests that come in bursts),
    ``burst_size`` ([lo, hi], uniform), ``burst_spread_s`` (a burst's
    requests fall uniformly over this span).  Requests are due in
    [0, seconds).
  - ``backlog``: ``requests``, the number queued at t = 0.
* ``prompt_tokens`` and ``new_tokens``: ``{"dist": "log_uniform", "min",
  "max", "multiple"}`` or ``{"dist": "fixed", "value"}``.  Log-uniform draws
  are rounded to the nearest ``multiple`` inside [min, max].
* ``schedule_seed``: arrival times and the sizes, in arrival order, come
  from this seed alone, so every run seed gets the same set of sizes and
  arrivals.
* ``shuffle_block``: the run seed permutes the sizes within each run of this
  many consecutive requests, and draws the token ids (uniform over
  [1, vocab)).
* Anything else (``close``, ``trace_seconds``, ``check_requests``) is read by the mix's driver.
* ``sources`` says where each parameter comes from; no code reads it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class Arrival:
    due_s: float
    prompt_len: int
    max_new: int
    prompt: np.ndarray  # (prompt_len,) int32


def _sizes(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    if spec["dist"] == "fixed":
        return np.full(n, int(spec["value"]), np.int64)
    if spec["dist"] != "log_uniform":
        raise ValueError(f"unknown size distribution {spec['dist']!r}")
    lo, hi, m = spec["min"], spec["max"], spec.get("multiple", 1)
    raw = np.exp(rng.uniform(math.log(lo), math.log(hi), n))
    return np.clip(np.round(raw / m).astype(np.int64) * m, lo, hi)


def arrival_times(mix: dict, seconds: float, rng: np.random.Generator) -> np.ndarray:
    """Sorted due times in [0, seconds) (all 0 for a backlog)."""
    if mix["arrival"] == "backlog":
        return np.zeros(int(mix["requests"]))
    if mix["arrival"] != "poisson_bursts":
        raise ValueError(f"unknown arrival {mix['arrival']!r}")
    rate, share = mix["rate_per_s"], mix["burst_share"]
    lo, hi = mix["burst_size"]
    times = []
    bg_rate = rate * (1.0 - share)
    t = rng.exponential(1.0 / bg_rate) if bg_rate > 0 else seconds
    while t < seconds:
        times.append(t)
        t += rng.exponential(1.0 / bg_rate)
    burst_rate = rate * share / ((lo + hi) / 2.0)
    t = rng.exponential(1.0 / burst_rate) if burst_rate > 0 else seconds
    while t < seconds:
        size = int(rng.integers(lo, hi + 1))
        times += list(t + rng.uniform(0.0, mix["burst_spread_s"], size))
        t += rng.exponential(1.0 / burst_rate)
    return np.sort(np.array([x for x in times if x < seconds]))


def generate(mix: dict, seconds: float, seed: int, vocab: int) -> list[Arrival]:
    """The requests of one run, in due order."""
    sched = np.random.default_rng(int(mix["schedule_seed"]))
    due = arrival_times(mix, seconds, sched)
    n = len(due)
    lens = _sizes(mix["prompt_tokens"], n, sched)
    news = _sizes(mix["new_tokens"], n, sched)
    rng = np.random.default_rng(int(seed))
    block = int(mix.get("shuffle_block", 1))
    order = np.arange(n)
    for a in range(0, n, block):
        order[a:a + block] = a + rng.permutation(min(block, n - a))
    lens, news = lens[order], news[order]
    return [Arrival(float(due[i]), int(lens[i]), int(news[i]),
                    rng.integers(1, vocab, int(lens[i]), dtype=np.int64).astype(np.int32))
            for i in range(n)]
