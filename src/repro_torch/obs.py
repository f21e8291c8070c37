"""The port's run-time tracer: spans and counters of the serving path.

Off by default, and then free: :func:`span` checks one module-level flag and
returns one shared no-op object (no allocation, no clock read, no device
op), and :func:`count` / :func:`count_device` return at once.  Call sites
that would compute a counter's argument guard it with ``if obs.on:``.

On (:func:`enable`), a span records its name, an id, its parent's id (the
innermost span open on the same thread), its start and end on
``time.monotonic_ns()`` (the clock of ``ServeEngine``'s request times) and
its attributes.  Spans of one request carry its ``rid``.  :func:`record`
keeps a span that began earlier, such as a wait in a queue.  Spans are kept
in memory up to ``CAPACITY``; the rest are counted in ``dropped_spans``.
Counters are host integers (:func:`count`) or device tensors accumulated in
place without a synchronise (:func:`count_device`), read once, in
:func:`export`.  Nothing is written to disk: :func:`export` is the only way
out.

While a ``torch.profiler`` records, and only then, each span also opens a
profiler range named ``<name>#<id>``, so the span sits on the profiler's
host timeline beside the kernels it launched.  The first span of a profile
opens a zero-length anchor range too, whose ``monotonic_ns`` the tracer
keeps: ``export(events)`` with that profile's events gives the offset that
maps the tracer's times onto the profiler's, so a span that is not a range
(a queue wait) can be placed on the device timeline as well.
"""
from __future__ import annotations

import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

on = False
CAPACITY = 1 << 16

_spans: list[tuple] = []  # (name, id, parent id, start ns, end ns, attrs)
_dropped = 0
_counters: dict[str, int] = {}
_device: dict[str, torch.Tensor] = {}
_ids = itertools.count(1)
_lock = threading.Lock()
_local = threading.local()
_anchor: tuple[str, int] | None = None  # (range name, monotonic ns) of the last profile
_anchor_live = False  # the anchor belongs to the profile now recording


def enable() -> None:
    global on
    on = True


def disable() -> None:
    global on
    on = False


def reset() -> None:
    """Forget every span, counter and anchor (ids keep counting)."""
    global _dropped, _anchor, _anchor_live
    with _lock:
        _spans.clear()
        _dropped = 0
        _counters.clear()
        _device.clear()
    _anchor, _anchor_live = None, False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _NoSpan()


def _stack() -> list[int]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _keep(entry: tuple) -> None:
    global _dropped
    with _lock:
        if len(_spans) < CAPACITY:
            _spans.append(entry)
        else:
            _dropped += 1


def _profiling() -> bool:
    """Whether a profiler records now; opens this profile's anchor first."""
    global _anchor, _anchor_live
    if not _profiler._is_profiler_enabled:
        _anchor_live = False
        return False
    if not _anchor_live:
        name = f"obs.anchor#{next(_ids)}"
        t = time.monotonic_ns()
        with torch.profiler.record_function(name):
            pass
        _anchor, _anchor_live = (name, t), True
    return True


class _Span:
    __slots__ = ("name", "id", "parent", "start", "attrs", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs, self._range = name, attrs, None

    def __enter__(self):
        self.id = next(_ids)
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        if _profiling():
            self._range = torch.profiler.record_function(f"{self.name}#{self.id}")
            self._range.__enter__()
        self.start = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.monotonic_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _stack().pop()
        _keep((self.name, self.id, self.parent, self.start, end, self.attrs))
        return False

    def set(self, **attrs) -> None:
        """Attributes known only once the span is open."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager that records the time inside it as span ``name``."""
    if not on:
        return _NOOP
    return _Span(name, attrs)


def record(name: str, t0_ns: int, t1_ns: int, **attrs) -> None:
    """Keep a span from ``t0_ns`` to ``t1_ns`` (``time.monotonic_ns()``),
    a child of the span open on this thread."""
    if not on:
        return
    stack = _stack()
    _keep((name, next(_ids), stack[-1] if stack else None, int(t0_ns), int(t1_ns), attrs))


def count(name: str, n: int) -> None:
    """Add ``n`` to host counter ``name``."""
    if on:
        with _lock:
            _counters[name] = _counters.get(name, 0) + int(n)


def count_device(name: str, tensor: torch.Tensor) -> None:
    """Add the sum of ``tensor`` to device counter ``name``, in place on the
    tensor's device, with no synchronise."""
    if not on:
        return
    total = tensor.sum(dtype=torch.int64)
    with _lock:
        acc = _device.get(name)
        if acc is None:
            _device[name] = total
        else:
            acc.add_(total)


def export(events=None) -> dict:
    """Everything recorded since the last :func:`reset`.

    ``clock`` names the anchor range of the last profile and its
    ``monotonic_ns``; given that profile's events (``prof.events()``) it also
    holds ``offset_ns``, which added to a span's time gives the profiler's
    time of it, in ns (the profiler's event times are in us)."""
    with _lock:
        spans = [{"name": n, "id": i, "parent": p, "start_ns": a, "end_ns": b,
                  "attrs": dict(attrs)} for n, i, p, a, b, attrs in _spans]
        dropped = _dropped
        counters = dict(_counters)
        device = dict(_device)
    counters.update({k: int(v.item()) for k, v in device.items()})
    name, t = _anchor if _anchor else (None, None)
    clock = {"clock": "time.monotonic_ns", "anchor": name, "anchor_ns": t, "offset_ns": None}
    if name is not None and events is not None:
        for e in events:
            if e.name == name and e.device_type == torch.autograd.DeviceType.CPU:
                clock["offset_ns"] = round(e.time_range.start * 1000) - t
                break
    return {"spans": spans, "counters": counters, "clock": clock, "dropped_spans": dropped}
