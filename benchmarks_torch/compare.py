"""Hold a port benchmark's artifact field for field against the reference's.

The simulator is float64 and bit-identical to the reference, so every
deterministic field of a ``BENCH_torch_*.json`` must equal its twin written
by the unchanged reference script, with ``==`` and no tolerance.  What is
left out is named, artifact by artifact, in :data:`ARTIFACTS`: the timing
keys (walls, rates, latencies and the speedups that are ratios of walls),
the keys whose values differ by design (engine names, the port's ``device``
block, ``vector_torch``'s own dispatch counts), and whole subtrees that a
run does not redo.  No key is left out by a pattern.
"""
from __future__ import annotations

import math

#: artifact -> (timing keys, keys that differ by design).  Each entry is an
#: exact key name, matched at any depth.
ARTIFACTS = {
    "scale": (
        ("wall_s", "total_wall_s", "events_per_s", "control_plane_build_s",
         "churn_wall_s", "churn_op_latency_s", "ft_build_s", "control_plane_micro",
         "queue_micro", "speedup_vs_incremental", "speedup_vs_mega_incremental",
         "incremental_wall_s", "reference_wall_s", "speedup"),
        ("engine", "device", "fronts_torch", "flows_torch"),
    ),
    "registry": (("wall_s",), ("device",)),
    "blocks": (("wall_s",), ("device",)),
    "trace": (("wall_s", "baseline_wall_s"), ("device",)),
    "placement": (("wall_s",), ("device",)),
    "serving": (("wall_s",), ("device",)),
}


def _same(a, b) -> bool:
    if type(a) is not type(b):
        return False
    if isinstance(a, float) and math.isnan(a) and math.isnan(b):
        return True
    return a == b


def deterministic_diff(port, ref, timing_keys, by_design=(), skip=()) -> list[str]:
    """Every key path where ``port`` and ``ref`` differ.

    ``timing_keys``: keys that must be present on both sides but whose values
    (whole subtrees, where a value is a dict) are not compared.
    ``by_design``: keys whose values differ, or that only one side writes, by
    design; neither compared nor required.  ``skip``: dotted paths from the
    root of subtrees left out.  Everything else must be present on both
    sides, of one JSON type, and equal (NaN equals NaN).
    """
    timing, design, skipped = set(timing_keys), set(by_design), set(skip)
    diffs: list[str] = []

    def walk(p, r, path: str) -> None:
        if isinstance(r, dict) and isinstance(p, dict):
            for key in sorted(set(r) | set(p), key=str):
                sub = f"{path}.{key}" if path else str(key)
                if sub in skipped or key in design:
                    continue
                if key not in p:
                    diffs.append(f"{sub}: missing from the port")
                elif key not in r:
                    diffs.append(f"{sub}: only in the port")
                elif key not in timing:
                    walk(p[key], r[key], sub)
        elif isinstance(r, list) and isinstance(p, list):
            if len(p) != len(r):
                diffs.append(f"{path}: length {len(p)} != {len(r)}")
            for i, (a, b) in enumerate(zip(p, r)):
                walk(a, b, f"{path}[{i}]")
        elif not _same(p, r):
            diffs.append(f"{path}: {p!r} != {r!r}")

    walk(port, ref, "")
    return diffs


def artifact_diff(name: str, port: dict, ref: dict, skip=()) -> list[str]:
    """:func:`deterministic_diff` with ``name``'s lists from :data:`ARTIFACTS`."""
    timing, design = ARTIFACTS[name]
    return deterministic_diff(port, ref, timing, design, skip)
