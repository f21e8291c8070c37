"""The port's three replay benches against the reference's scripts.

``bench_trace_replay.py``, ``bench_placement.py`` and ``bench_serving.py``
run at their ``--quick`` sizes in both packages (the port on ``--device
cpu``, its engine the port's default ``vector_torch``) and every field of
the port's artifact outside its timing keys must equal the reference's,
with ``compare.deterministic_diff``; each in-bench assertion holds in both.
"""
import pytest

from test_torch_bench_small import check_device_block, compare, run_pair

RUNS = {
    "trace": ("bench_trace_replay", ("faasnet", "baseline", "uninterrupted", "rerun")),
    "placement": ("bench_placement",
                  ("exclusive", "shared", "shared_binpack", "shared_histogram")),
    "serving": ("bench_serving", ("mix.faasnet", "mix.baseline", "cold_burst.herd",
                                  "cold_burst.naive")),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_replay_bench_quick_matches_reference(name, tmp_path, monkeypatch):
    script, runs = RUNS[name]
    port, ref = run_pair(script, tmp_path, monkeypatch, "--quick")
    assert compare.artifact_diff(name, port, ref) == []
    check_device_block(port, runs)
