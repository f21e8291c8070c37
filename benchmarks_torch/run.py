"""Benchmark runner on the port: one benchmark per paper table/figure + roofline.

The port's counterpart of ``benchmarks/run.py``.  Prints ``name,value,derived``
CSV.  ``--quick`` shrinks the expensive simulations; ``--only fig14`` runs a
single figure; ``--device`` (``cuda`` by default, ``cpu`` for the kernels'
plain versions) is threaded into every figure.  The roofline section reads
``results/dryrun_torch/*.json``, produced by
``python -m repro_torch.launch.dryrun``.

Usage::

    PYTHONPATH=src:. python -m benchmarks_torch.run                  # on the card
    PYTHONPATH=src:. python -m benchmarks_torch.run --quick --device cpu
"""
from __future__ import annotations

import argparse
import time


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None)
    ap.add_argument("--dryrun-dir", default="results/dryrun_torch")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from benchmarks_torch import paper_figures
    from benchmarks_torch.roofline import csv_rows
    from repro_torch.launch.device import require

    require(args.device)
    print("name,value,derived")
    for fn in paper_figures.ALL:
        if args.only and args.only not in fn.__name__:
            continue
        t0 = time.monotonic()
        # no ERROR row here, unlike the reference: a failed launch on the
        # card must end the run
        rows = fn(quick=args.quick, device=args.device)
        for name, value, derived in rows:
            print(f"{name},{value:.4f},{derived}", flush=True)
        print(f"_timing/{fn.__name__}_s,{time.monotonic() - t0:.2f},", flush=True)

    if args.only is None or "roofline" in args.only:
        try:
            for name, value, derived in csv_rows(args.dryrun_dir):
                print(f"{name},{value:.5f},{derived}", flush=True)
        except Exception as e:  # pragma: no cover
            print(f"roofline,ERROR,{e}", flush=True)


if __name__ == "__main__":
    main()
