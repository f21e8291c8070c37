"""Print the roofline table of the port's dry runs, one row per arch.

Reads the JSON files ``python -m repro_torch.launch.dryrun --all --mesh both``
writes and prints a markdown table, one row per arch and one column per
shape: for the single-pod (16, 16) mesh (S) and the multi-pod (2, 16, 16)
mesh (M), the per-device compute / memory / collective terms in ms at an
H100's rates, the dominant term, the roofline fraction and the per-device
argument GiB; then the host seconds the cell's traces took on both.

    PYTHONPATH=src python scripts/torch_dryrun_table.py [results/dryrun_torch]
"""
from __future__ import annotations

import json
import sys
from pathlib import Path


SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def terms(r: dict) -> str:
    roof = r["roofline"]
    ms = "/".join(f"{roof[k] * 1e3:.4g}" for k in ("compute_s", "memory_s", "collective_s"))
    return (f"{ms}, {roof['dominant'][:3]}, {roof['roofline_fraction']:.3g}, "
            f"{r['memory']['argument_size_in_bytes'] / 2**30:.3g}")


def main() -> None:
    outdir = Path(sys.argv[1] if len(sys.argv) > 1 else "results/dryrun_torch")
    cells: dict = {}
    for path in sorted(outdir.glob("*.json")):
        r = json.loads(path.read_text())
        cells.setdefault(r["arch"], {}).setdefault(r["shape"], {})[r["mesh"]] = r
    print("| arch | " + " | ".join(SHAPES) + " |")
    print("|---|" + "---|" * len(SHAPES))
    for arch, by_shape in cells.items():
        out = []
        for shape in SHAPES:
            if shape not in by_shape:
                out.append("skipped")
                continue
            single, multi = by_shape[shape]["single"], by_shape[shape]["multi"]
            host = single["trace_s"] + multi["trace_s"]
            out.append(f"S {terms(single)}; M {terms(multi)}; {host:.3g} s")
        print(f"| {arch} | " + " | ".join(out) + " |")
    n = sum(len(m) for v in cells.values() for m in v.values())
    host = sum(r["trace_s"] for v in cells.values() for m in v.values() for r in m.values())
    print(f"{n} cells; {host:.1f} s of traces")


if __name__ == "__main__":
    main()
