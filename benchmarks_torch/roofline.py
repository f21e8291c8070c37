"""Aggregate the port's dry-run JSONs into the §Roofline table (+ CSV rows).

The port's counterpart of ``benchmarks/roofline.py``.  It reads
``results/dryrun_torch/<arch>__<shape>__<mesh>.json``, the files that
``python -m repro_torch.launch.dryrun`` writes
(:func:`repro_torch.launch.dryrun.run_cell`).  Two of the reference's fields
are not in them, and the table reads the port's own instead:

  * the reference's ``memory.peak_per_device_bytes`` (XLA's compiled peak)
    -> ``memory.argument_size_in_bytes`` (the per-device argument bytes),
    column ``arg_gib``;
  * the reference's ``compile_s`` -> ``trace_s`` (the port traces on
    ``meta`` and compiles nothing), column ``trace_s``.

Every other column is the reference's, read from the same keys.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.configs import cells

DEFAULT_DIR = "results/dryrun_torch"


def load_results(outdir: str = DEFAULT_DIR) -> dict[tuple, dict]:
    out = {}
    for path in glob.glob(os.path.join(outdir, "*.json")):
        base = os.path.basename(path)[: -len(".json")]
        parts = base.split("__")
        if len(parts) < 3:
            continue
        arch, shape, mesh = parts[0], parts[1], parts[2]
        with open(path) as f:
            out[(arch, shape, mesh)] = json.load(f)
    return out


def table_rows(outdir: str = DEFAULT_DIR, mesh: str = "single"):
    res = load_results(outdir)
    rows = []
    for arch, shape, skip in cells(include_skipped=True):
        key = (arch, shape, mesh)
        if skip is not None:
            rows.append({"arch": arch, "shape": shape, "skip": skip})
            continue
        d = res.get(key)
        if d is None:
            rows.append({"arch": arch, "shape": shape, "skip": "MISSING"})
            continue
        r = d.get("roofline", {})
        rows.append({
            "arch": arch,
            "shape": shape,
            "mesh": mesh,
            "compute_s": r.get("compute_s"),
            "memory_s": r.get("memory_s"),
            "collective_s": r.get("collective_s"),
            "dominant": r.get("dominant"),
            "fraction": r.get("roofline_fraction"),
            "useful_flops_ratio": r.get("useful_flops_ratio"),
            "arg_gib": d.get("memory", {}).get("argument_size_in_bytes", 0) / 2**30,
            "trace_s": d.get("trace_s"),
            "n_devices": d.get("n_devices"),
        })
    return rows


def markdown_table(outdir: str = DEFAULT_DIR, mesh: str = "single") -> str:
    rows = table_rows(outdir, mesh)
    lines = [
        "| arch | shape | compute_s | memory_s | collective_s | dominant | "
        "MODEL/HLO flops | roofline frac | args GiB/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if "skip" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | SKIP | — | — | — |"
                         f" <!-- {r['skip']} -->")
            continue
        lines.append(
            "| {arch} | {shape} | {compute_s:.3f} | {memory_s:.3f} | "
            "{collective_s:.3f} | {dominant} | {useful_flops_ratio:.3f} | "
            "{fraction:.4f} | {arg_gib:.2f} |".format(**r)
        )
    return "\n".join(lines)


def csv_rows(outdir: str = DEFAULT_DIR) -> list[tuple[str, float, str]]:
    out = []
    for mesh in ("single", "multi"):
        for r in table_rows(outdir, mesh):
            if "skip" in r:
                continue
            name = f"roofline/{r['arch']}/{r['shape']}/{mesh}"
            out.append((f"{name}/fraction", r["fraction"] or 0.0,
                        f"dom={r['dominant']}"))
    return out
