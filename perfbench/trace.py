"""Reading a ``torch.profiler`` trace of the traced window.

The harness marks its own calls into the program with ranges named
``bench.<what>`` (``bench.<what>|<arg>|...`` where a reader needs the call's
shapes).  :func:`summarize` turns a finished profile into plain numbers:

* ``busy_s``: the union of the device's operation intervals;
* ``ranges``: for every ``bench.*`` range on the host, its name and the
  device time of the operations whose runtime launch call lies inside it;
* ``device_ops``: device seconds by operation name;
* ``idle_by_host``: the device's idle gaps, each charged to the innermost
  ``bench.*`` range open on the host when it began (``host`` if none).
"""
from __future__ import annotations

import bisect

from dataclasses import dataclass, field


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    ranges: list[tuple[str, float]] = field(default_factory=list)
    device_ops: dict[str, float] = field(default_factory=dict)
    idle_by_host: dict[str, float] = field(default_factory=dict)

    def range_device_s(self, prefix: str) -> list[tuple[list[str], float]]:
        """(the range's ``|``-separated arguments, device s) of each range
        whose name is ``prefix`` or starts with ``prefix|``."""
        out = []
        for name, dev in self.ranges:
            head, *args = name.split("|")
            if head == prefix:
                out.append((args, dev))
        return out


def _union(intervals: list[tuple[float, float]]) -> tuple[float, list[tuple[float, float]]]:
    """Total covered length and the merged intervals, sorted."""
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), [(a, b) for a, b in merged]


def summarize(prof, window_s: float) -> TraceSummary:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host_ranges, launched_at = [], [], {}
    kernels = []  # (correlation id, start, end)
    ops: dict[str, float] = {}
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end  # microseconds
        if e.device_type == cuda:
            if e.name.startswith("bench."):  # the device side of a host range
                continue
            device.append((start, end))
            kernels.append((e.id, start, end))
            ops[e.name] = ops.get(e.name, 0.0) + (end - start) / 1e6
        elif e.name.startswith("bench."):
            host_ranges.append((start, end, e.name))
        elif e.name.startswith("cu"):  # a runtime call: launch, copy, memset
            launched_at[e.id] = start
    # each device operation belongs to the host ranges open when it was
    # launched (the runtime call with its correlation id); this also counts
    # kernels launched from C code that no aten op encloses
    launches = sorted((launched_at.get(cid, a), b - a) for cid, a, b in kernels)
    times = [t for t, _ in launches]
    cum = [0.0]
    for _, d in launches:
        cum.append(cum[-1] + d)
    ranges = []
    for a, b, name in host_ranges:
        i, j = bisect.bisect_left(times, a), bisect.bisect_right(times, b)
        ranges.append((name, (cum[j] - cum[i]) / 1e6))
    host_ranges = [(a, b, name.split("|")[0][len("bench."):]) for a, b, name in host_ranges]
    busy_us, merged = _union(device)
    idle: dict[str, float] = {}
    # a sweep over the gaps in time order with the stack of host ranges open
    # at each gap's start: ranges on one thread nest, so the top is innermost
    host_ranges.sort()
    stack: list[tuple[float, float, str]] = []
    j = 0
    for (_, a), (b, _) in zip(merged, merged[1:]):
        while j < len(host_ranges) and host_ranges[j][0] <= a:
            while stack and stack[-1][1] < host_ranges[j][0]:
                stack.pop()
            stack.append(host_ranges[j])
            j += 1
        while stack and stack[-1][1] < a:
            stack.pop()
        label = stack[-1][2] if stack else "host"
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    return TraceSummary(window_s=window_s, busy_s=busy_us / 1e6, ranges=ranges,
                        device_ops=ops, idle_by_host=idle)


def breakdown(summary: TraceSummary, top: int = 10) -> dict:
    """The ``breakdown`` of a traced result line: the device operations that
    took most time and the idle seconds by what the host was doing."""
    def ranked(d):
        return [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(summary.device_ops),
            "idle_gaps": ranked(summary.idle_by_host)}
