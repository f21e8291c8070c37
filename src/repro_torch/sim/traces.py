"""Workload traces (paper §2.2 / §4.2), scaled as the paper scales them.

The paper scales the production traces to ~1/3 of original peak throughput
and shortens 2 h to <1 h.  We generate the two evaluation traces from their
published descriptions:

  * **IoT** (§4.2): burst 1 at t=9 min, 10 → 300-400 RPS, lasting ~18 min,
    back to 10 RPS at t=28 min; burst 2 at t=40 min to 100 RPS, then within
    ~2 min jumping to ~400 RPS.  55-minute timeline.
  * **Synthetic gaming** (§4.2): two sharp bursts — 1 → 100 RPS at t=11 min
    (tree grows to height 7, 82 VMs), decay to 1 RPS afterwards with VM
    reclaim shrinking the pool to ~30 before burst 2 at t=21 min
    (+62 VMs → 102 VMs, height 7).

Each trace is a list of per-second request rates (RPS).  A deterministic
LCG jitters arrivals so runs are reproducible.  Two synthetic tenants —
``constant_trace`` and ``diurnal_trace`` — round out the multi-tenant mix
(`repro_torch.sim.multi_tenant`): a steady background and a staggered day/night
cycle that overlap the IoT/gaming bursts.

All four generators and the arrival jitter equal the JAX package's, list
for list, in ``tests/test_torch_traces.py`` — their shapes cannot silently
drift.
"""
from __future__ import annotations

import math


def _ramp(values: list[float], start: float, end: float, t0: int, t1: int) -> None:
    for t in range(min(t0, len(values)), min(t1, len(values))):
        frac = (t - t0) / max(1, (t1 - t0))
        values[t] = start + (end - start) * frac


def iot_trace(*, duration_s: int = 55 * 60, scale: float = 1.0) -> list[float]:
    rps = [10.0] * duration_s
    m = 60
    _ramp(rps, 10, 350, 9 * m, 10 * m)  # burst 1 rises fast
    for t in range(10 * m, 28 * m):
        rps[t] = 300.0 + 100.0 * 0.5 * (1 + math.sin(t / 47.0))  # 300-400 plateau
    _ramp(rps, 350, 10, 28 * m, 29 * m)
    _ramp(rps, 10, 100, 40 * m, 41 * m)  # burst 2: step to 100 ...
    _ramp(rps, 100, 400, 41 * m, 43 * m)  # ... then jump to ~400 in 2 min
    for t in range(43 * m, duration_s):
        rps[t] = 400.0
    return [r * scale for r in rps]


def synthetic_gaming_trace(*, duration_s: int = 30 * 60, scale: float = 1.0) -> list[float]:
    rps = [1.0] * duration_s
    m = 60
    for t in range(11 * m, min(13 * m, duration_s)):
        rps[t] = 100.0  # sharp burst 1
    _ramp(rps, 100, 1, 13 * m, 14 * m)
    for t in range(21 * m, min(24 * m, duration_s)):
        rps[t] = 125.0  # burst 2, slightly larger (tree 30 → 102 VMs)
    _ramp(rps, 125, 1, 24 * m, 25 * m)
    return [r * scale for r in rps]


def constant_trace(*, duration_s: int = 10 * 60, rps: float = 20.0, scale: float = 1.0) -> list[float]:
    """Steady background tenant: a flat RPS floor for the whole timeline.

    The multi-tenant replay uses it as the always-on tenant the bursty IoT
    and gaming tenants contend with for registry egress and the VM pool.
    """
    return [rps * scale] * duration_s


def diurnal_trace(
    *,
    duration_s: int = 30 * 60,
    base_rps: float = 4.0,
    peak_rps: float = 64.0,
    period_s: int = 20 * 60,
    phase_s: int = 0,
    scale: float = 1.0,
) -> list[float]:
    """Day/night tenant compressed to minutes: half-sinusoid days, flat nights.

    ``rps(t) = base + (peak - base) * max(0, sin(2pi (t + phase) / period))``
    — the positive sine half-cycle is the "day" ramp, the clipped negative
    half is the quiet "night" at ``base_rps``.  ``phase_s`` staggers tenants
    so their peaks overlap partially, the contention pattern the paper's
    trace-driven evaluation (§4.2) exercises.
    """
    out = []
    for t in range(duration_s):
        x = math.sin(2 * math.pi * ((t + phase_s) / period_s))
        out.append((base_rps + (peak_rps - base_rps) * max(0.0, x)) * scale)
    return out


def arrivals_for_second(rps: float, t: int, seed: int = 0) -> int:
    """Deterministic integer arrivals ~ rps (LCG-jittered rounding)."""
    x = (1103515245 * (t * 2654435761 + seed) + 12345) & 0x7FFFFFFF
    frac = (x / 0x7FFFFFFF)
    base = int(rps)
    return base + (1 if frac < (rps - base) else 0)


def arrival_offsets(n: int, t: int, seed: int = 0) -> list[float]:
    """``n`` sorted sub-second arrival offsets in [0, 1) for second ``t``.

    Same LCG family as :func:`arrivals_for_second`, decorrelated per request
    index.  The request-serving layer (``repro_torch.sim.multi_tenant`` with a
    :class:`~repro_torch.sim.multi_tenant.ServingConfig`) stamps each arrival at
    ``t + offset`` so dispatch — and hence the response-latency
    distribution — is not quantized to the 1 s tick boundary.  Sorted
    ascending, so appending a tick's offsets keeps the per-function FIFO
    queue globally ordered by arrival time.  Deterministic: equal to the JAX
    package's in ``tests/test_torch_traces.py``.
    """
    out = []
    for i in range(n):
        x = (1103515245 * (t * 2654435761 + seed + 40503 * (i + 1)) + 12345) & 0x7FFFFFFF
        out.append(x / 0x80000000)
    out.sort()
    return out
