"""Readings a cell's limits and rates are set from, on the card, in one process.

    python3 perfbench/calibrate.py gaps --workload W --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds S
    python3 perfbench/calibrate.py knee --workload W --rates 3,4,5 --seconds S
    python3 perfbench/calibrate.py window --workload W --seeds N --seconds S

``gaps`` runs the cell's own driver for a short window at the cell's load on
each seed and prints the program's served-logit gaps against the float32
reference and its verdict; on the control seeds also the gaps of the tokens
that the reference computed with fp8 linear layers puts first (the precision
control), and the control's verdict under the cell's limits
(``control_correct``, which has to come out false).
``knee`` serves the cell's mix at each offered rate and prints what was
served, what was still waiting at the close and how long the drain took.
``window`` serves one run's window on the first seed, as ``run.py`` does,
skips the check and prints the end-to-end metrics: a run of its own process
for each reading, to take the spread between processes at less chip time.
Each line is one JSON object; ``--out`` also appends them to a file.
"""
from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def _emit(row: dict, out) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def _stats(g: list) -> dict:
    """Widest, 90th-percentile and mean gap, and the share of tokens at 0
    (the reference's own first choice)."""
    if not g:
        return {}
    s = sorted(g)
    return {"max": s[-1], "p90": s[max(math.ceil(0.9 * len(s)) - 1, 0)],
            "mean": sum(s) / len(s), "argmax_share": sum(1 for x in s if x == 0) / len(s),
            "n": len(s)}


def gaps(cell, seeds, control_seeds, seconds, device, out) -> None:
    import torch

    driver = cell.driver()
    for seed in seeds:
        t = time.monotonic()
        res = driver.drive(cell, seed, seconds, False, device, t,
                           control=seed in control_seeds)
        run = res["record"]
        ctl = res.get("control_readings") or {}
        _emit({"workload": cell.name, "seed": seed, "correct": res["correct"],
               "control_correct": res.get("control_correct"),
               "gap": res["readings"]["served_logit_gap"],
               "gap_mean": res["readings"]["served_logit_gap_mean"],
               "control_gap": ctl.get("served_logit_gap"),
               "control_gap_mean": ctl.get("served_logit_gap_mean"),
               "gap_stats": _stats(res["token_gaps"]),
               "control_stats": _stats(res.get("control_token_gaps") or []),
               "check_s": res["check_s"], "setup_s": run.setup_s,
               "compared_tokens": res["checks"]["compared_tokens"]["value"],
               "sampled_requests": res["sampled_requests"],
               "attempted": res["attempted"], "failed": res["failed"],
               "batches": len(run.batches),
               "memory_peak_bytes": res["memory_peak_bytes"],
               "wall_s": time.monotonic() - t}, out)
        del res, run
        torch.cuda.empty_cache()


def knee(cell, rates, seconds, seed, device, out) -> None:
    import torch

    driver = cell.driver()
    base = cell.mix
    for rate in rates:
        cell.mix = copy.deepcopy(base)
        cell.mix["rate_per_s"] = rate
        res = driver.drive(cell, seed, seconds, False, device, time.monotonic(), check=False)
        run = res["record"]
        close = run.window_close
        due = [r for r in run.requests if r.due < close]
        waiting = sum(1 for r in due if not (r.t_batch_start <= close))
        last = max((r.t_done for r in due if math.isfinite(r.t_done)), default=close)
        busy = sum(min(b.t_end, close) - b.t_start for b in run.batches if b.t_start < close)
        ttft = sorted(r.t_first - r.due for r in due)
        _emit({"workload": cell.name, "rate_per_s": rate, "due": len(due),
               "served_by_close": sum(1 for r in due if r.t_done <= close),
               "waiting_at_close": waiting, "drain_s": last - close,
               "busy_share": busy / seconds, "batches": len(run.batches),
               "mean_batch_rows": sum(len(b.rows) for b in run.batches) / max(len(run.batches), 1),
               "mean_batch_s": sum(b.t_end - b.t_start for b in run.batches) / max(len(run.batches), 1),
               "ttft_p50_s": ttft[len(ttft) // 2] if ttft else None,
               "ttft_p90_s": ttft[max(math.ceil(0.9 * len(ttft)) - 1, 0)] if ttft else None}, out)
        del res, run
        torch.cuda.empty_cache()
    cell.mix = base


def window(cell, seconds, seed, device, out) -> None:
    from perfbench.harness import read_metrics

    res = cell.driver().drive(cell, seed, seconds, False, device, T0, check=False)
    run = res["record"]
    metrics = read_metrics(cell, run, "end_to_end")
    _emit({"workload": cell.name, "seed": seed, "rate_per_s": cell.mix.get("rate_per_s"),
           **{k: v["value"] for k, v in metrics.items()},
           "due": sum(1 for r in run.requests if r.due < run.window_close),
           "batches": len(run.batches), "window_s": run.window_end - run.window_open,
           "memory_peak_bytes": res["memory_peak_bytes"]}, out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("gaps", "knee", "window"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--rates", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from perfbench.harness import forbidden_loaded, load_cell
    from perfbench.run import _cache_dirs

    _cache_dirs(ROOT)
    cell = load_cell(ROOT, args.workload)
    ints = [int(s) for s in args.seeds.split(",") if s]
    if args.mode == "gaps":
        gaps(cell, ints, {int(s) for s in args.control_seeds.split(",") if s},
             args.seconds, "cuda", args.out)
    elif args.mode == "window":
        window(cell, args.seconds, ints[0], "cuda", args.out)
    else:
        knee(cell, [float(r) for r in args.rates.split(",")], args.seconds,
             ints[0] if ints else 1, "cuda", args.out)
    bad = forbidden_loaded()
    if bad:
        print(f"calibrate: loaded {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
