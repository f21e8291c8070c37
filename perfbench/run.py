"""Run one benchmark cell and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It runs on the card it is started on and exits
non-zero, printing no result, without CUDA or with fewer cards than the cell
asks for.  With ``--trace 0`` the result carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics and the trace's
``breakdown``.  Standard error ends with each number the correctness check
compared, beside its limit; the result line carries them last, under
``checks``.
"""
from __future__ import annotations

import time

T0 = time.monotonic()  # process start, as near as Python gets

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def _cache_dirs(root: Path) -> None:
    """Every compile cache at a fixed path inside the checkout (the kernel
    libraries already build under ``build/repro_torch_kernels``)."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def run_cell(root: Path, workload: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t0: float = T0) -> tuple[dict, dict]:
    """Drive one run of a cell; returns (result line, driver output)."""
    import torch

    from perfbench.harness import load_cell, read_metrics
    from perfbench.trace import breakdown

    cell = load_cell(root, workload)
    out = cell.driver().drive(cell, seed, seconds, traced, device, t0)
    run = out["record"]
    section = "per_layer" if traced else "end_to_end"
    dev = torch.device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    result = {
        "correct": out["correct"],
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": read_metrics(cell, run, section),
        "device": {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]},
    }
    if traced and run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = breakdown(run.trace)
    result["notes"] = {"check_s": out["check_s"], "sampled_requests": out["sampled_requests"],
                       "readings": {k: _json_number(v) for k, v in out["readings"].items()},
                       "batches": len(run.batches),
                       "decode_step_s_median": _json_number(_median_step(run)),
                       "window_s": run.window_end - run.window_open}
    if run.trace is not None:
        by_range: dict = {}
        for name, dev_s in run.trace.ranges:
            key = name.split("|")[0]
            by_range[key] = by_range.get(key, 0.0) + dev_s
        result["notes"]["range_device_s"] = by_range
    result["checks"] = {k: {"value": _json_number(c["value"]), "limit": c["limit"]}
                        for k, c in out["checks"].items()}
    return result, out


def _median_step(run) -> float:
    """Median host time between successive decode calls of a batch."""
    gaps = sorted(b - a for bt in run.batches for a, b in zip(bt.step_calls, bt.step_calls[1:]))
    return gaps[len(gaps) // 2] if gaps else math.nan


def _json_number(x):
    """A reading for JSON; ``None`` where it is not finite (nothing compared)."""
    return x if isinstance(x, int) or math.isfinite(x) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs(ROOT)

    import torch

    from perfbench.harness import forbidden_loaded, load_cell

    chips = load_cell(ROOT, args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, _ = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_loaded()
    if bad:
        print(f"perfbench: the run loaded {bad}; the benchmark measures the "
              "PyTorch port alone", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"check correct {result['correct']}", file=sys.stderr)
    print(json.dumps(result, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
