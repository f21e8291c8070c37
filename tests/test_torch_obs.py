"""The port's tracer (``repro_torch/obs.py``) on its own: free when off;
spans, parents, per-thread stacks, recorded spans, counters and overflow when
on; and its clock against a ``torch.profiler`` trace on the CPU."""
import ctypes
import ctypes.util
import os
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.kernels import _build


@pytest.fixture(autouse=True)
def fresh():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _by_name(ex):
    return {s["name"]: s for s in ex["spans"]}


def test_off_records_nothing_and_shares_one_object():
    a, b = obs.span("x", k=1), obs.span("y")
    assert a is b
    with a as inner:
        inner.set(k=2)
        obs.record("q", 0, 10, rid=1)
        obs.count("c", 3)
        obs.count_device("d", torch.ones(4, dtype=torch.bool))
    ex = obs.export()
    assert ex["spans"] == [] and ex["counters"] == {} and ex["dropped_spans"] == 0
    assert ex["clock"]["anchor"] is None and ex["clock"]["offset_ns"] is None


def test_on_nests_spans_and_records_their_attributes():
    obs.enable()
    t0 = time.monotonic_ns()
    with obs.span("outer", rows=2) as outer:
        with obs.span("inner", k=1):
            obs.record("wait", t0 - 5, t0, rid=7)
        outer.set(budget=4)
        with obs.span("sibling"):
            pass
    with obs.span("after"):
        pass
    s = _by_name(obs.export())
    assert s["outer"]["parent"] is None and s["after"]["parent"] is None
    assert s["inner"]["parent"] == s["sibling"]["parent"] == s["outer"]["id"]
    assert s["wait"]["parent"] == s["inner"]["id"]
    assert (s["wait"]["start_ns"], s["wait"]["end_ns"]) == (t0 - 5, t0)
    assert s["outer"]["attrs"] == {"rows": 2, "budget": 4}
    assert s["inner"]["attrs"] == {"k": 1} and s["wait"]["attrs"] == {"rid": 7}
    assert s["outer"]["start_ns"] <= s["inner"]["start_ns"] <= s["inner"]["end_ns"] \
        <= s["sibling"]["start_ns"] <= s["sibling"]["end_ns"] <= s["outer"]["end_ns"]
    assert len({x["id"] for x in s.values()}) == 5


def test_each_thread_has_its_own_stack():
    obs.enable()
    opened, release = threading.Event(), threading.Event()

    def other():
        with obs.span("thread.outer"):
            opened.set()
            release.wait(5)
            with obs.span("thread.inner"):
                pass

    th = threading.Thread(target=other)
    with obs.span("main.outer"):
        th.start()
        opened.wait(5)
        with obs.span("main.inner"):
            release.set()
            th.join(5)
    s = _by_name(obs.export())
    assert s["thread.outer"]["parent"] is None
    assert s["thread.inner"]["parent"] == s["thread.outer"]["id"]
    assert s["main.inner"]["parent"] == s["main.outer"]["id"]


def test_counters_on_the_host_and_on_the_device():
    obs.enable()
    obs.count("tokens", 3)
    obs.count("tokens", 4)
    keep = torch.tensor([[True, False], [True, True]])
    obs.count_device("kept", keep)
    obs.count_device("kept", keep[:1])
    ex = obs.export()
    assert ex["counters"] == {"tokens": 7, "kept": 4}
    assert obs.export()["counters"] == ex["counters"]  # reading does not consume
    obs.reset()
    assert obs.export()["counters"] == {}


def test_threads_lose_no_span_and_no_count():
    """More threads than cores, switching often: every span and every add is
    kept."""
    obs.enable()
    threads, rounds = 4 * (os.cpu_count() or 1), 200
    keep = torch.ones(3, dtype=torch.bool)

    def work():
        for _ in range(rounds):
            with obs.span("outer"):
                with obs.span("inner"):
                    obs.count("n", 1)
                    obs.count_device("kept", keep)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in pool)
    ex = obs.export()
    assert ex["counters"] == {"n": threads * rounds, "kept": 3 * threads * rounds}
    spans = ex["spans"]
    assert len(spans) == 2 * threads * rounds and len({s["id"] for s in spans}) == len(spans)
    outer = {s["id"] for s in spans if s["name"] == "outer"}
    assert all(s["parent"] in outer for s in spans if s["name"] == "inner")
    assert all(s["parent"] is None for s in spans if s["name"] == "outer")


def test_overflow_is_counted(monkeypatch):
    monkeypatch.setattr(obs, "CAPACITY", 3)
    obs.enable()
    for i in range(5):
        with obs.span("s", i=i):
            pass
    obs.record("r", 0, 1)
    ex = obs.export()
    assert [s["attrs"].get("i") for s in ex["spans"]] == [0, 1, 2]
    assert ex["dropped_spans"] == 3


def test_spans_are_profiler_ranges_on_the_exported_clock():
    obs.enable()
    with obs.span("before"):  # no profiler: no range
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("a", n=1):
            torch.ones(64).sum()
            with obs.span("b"):
                time.sleep(0.002)
        obs.record("queued", time.monotonic_ns() - 1_000_000, time.monotonic_ns())
        with obs.span("a"):
            pass
    ex = obs.export(prof.events())
    offset = ex["clock"]["offset_ns"]
    assert ex["clock"]["anchor"].startswith("obs.anchor#") and offset is not None
    ranges = {e.name: e for e in prof.events()
              if "#" in e.name and e.device_type == torch.autograd.DeviceType.CPU}
    spans = {f"{s['name']}#{s['id']}": s for s in ex["spans"]}
    in_profile = {k for k, s in spans.items() if s["name"] not in ("before", "queued")}
    assert len(in_profile) == 3 and in_profile <= set(ranges)
    assert not any(k in ranges for k, s in spans.items() if s["name"] in ("before", "queued"))
    for key in in_profile:
        want_us = ranges[key].time_range.start
        got_us = (spans[key]["start_ns"] + offset) / 1e3
        assert abs(got_us - want_us) < 500, key
    # a span that is not a range lands inside the profile's time too
    q = next(s for s in ex["spans"] if s["name"] == "queued")
    assert 0 < (q["end_ns"] + offset) / 1e3 <= max(e.time_range.end for e in ranges.values()) + 500


def test_kernel_library_load_is_a_span(monkeypatch, tmp_path):
    """``kernels.load`` around a library's first load, ``built`` telling
    whether nvcc had to run (the C library stands in for a kernel's)."""
    libc = ctypes.util.find_library("c")
    monkeypatch.setitem(_build.LIBRARIES, "stand_in",
                        ("cap_chain.cu", (), {"strlen": [ctypes.c_char_p]}))
    built = tmp_path / "stand_in.so"
    monkeypatch.setattr(_build, "library_path", lambda name: built)
    monkeypatch.setattr(_build, "build", lambda name: libc)
    load = _build.library.__wrapped__  # past the per-process cache
    obs.enable()
    load("stand_in")
    built.write_bytes(b"")
    assert load("stand_in").strlen(b"abc") == 3
    spans = obs.export()["spans"]
    assert [s["name"] for s in spans] == ["kernels.load"] * 2
    assert [s["attrs"] for s in spans] == [{"library": "stand_in", "built": True},
                                          {"library": "stand_in", "built": False}]
