"""The port's workload traces held against the JAX package's, list for list.

Every downstream replay golden rests on these generators and on the LCG
arrival jitter, so each is called in both packages with the parameters
``tests/test_traces.py`` uses (plus the ones ``multi_tenant_config`` and the
replay goldens pass) and the lists must be equal — exact float equality,
not a rounded checksum.
"""
import pytest

import repro.sim.traces as jtr
import repro_torch.sim.traces as ttr

TRACE_CASES = [
    ("iot_trace", {}),
    ("iot_trace", {"scale": 2.0}),
    ("iot_trace", {"scale": 1 / 3}),
    ("iot_trace", {"scale": 0.25}),
    ("iot_trace", {"scale": 0.5}),
    ("synthetic_gaming_trace", {}),
    ("synthetic_gaming_trace", {"scale": 2.0}),
    ("synthetic_gaming_trace", {"scale": 1.0}),
    ("constant_trace", {}),
    ("constant_trace", {"scale": 2.0}),
    ("constant_trace", {"duration_s": 240}),
    ("constant_trace", {"duration_s": 8 * 60, "scale": 2.0, "rps": 7.5}),
    ("diurnal_trace", {}),
    ("diurnal_trace", {"scale": 2.0}),
    ("diurnal_trace", {"duration_s": 240, "phase_s": 300}),
    ("diurnal_trace", {"duration_s": 25 * 60, "phase_s": 150 * 6, "scale": 1.0}),
]


@pytest.mark.parametrize("name,kw", TRACE_CASES, ids=lambda c: repr(c))
def test_trace_equals_reference(name, kw):
    want = getattr(jtr, name)(**kw)
    got = getattr(ttr, name)(**kw)
    assert len(want) > 0
    assert got == want


@pytest.mark.parametrize(
    "rps,seed", [(33.7, 5), (10 / 3, 0), (0.3, 1), (7.5, 1), (33.7, 1), (5.0, 0), (2.5, 0), (2.5, 1)]
)
def test_arrivals_for_second_equals_reference(rps, seed):
    want = [jtr.arrivals_for_second(rps, t, seed=seed) for t in range(5000)]
    assert [ttr.arrivals_for_second(rps, t, seed=seed) for t in range(5000)] == want


def test_arrival_offsets_equal_reference():
    assert ttr.arrival_offsets(5, 7, seed=3) == jtr.arrival_offsets(5, 7, seed=3)
    for t in range(40):
        for n in (0, 1, 3, 8):
            assert ttr.arrival_offsets(n, t, seed=t % 5) == jtr.arrival_offsets(n, t, seed=t % 5)
    for t in (0, 13, 999):
        for n in (0, 1, 7, 100):
            assert ttr.arrival_offsets(n, t, seed=t) == jtr.arrival_offsets(n, t, seed=t)
