"""90th percentile over every request due in the window of its first token's
time (the engine's ``Request.t_first_token``) less the time it was due; a
request that never got one counts as missing (infinitely late)."""
import math

from perfbench.harness import p90


def read(run):
    due = [r for r in run.requests if r.due < run.window_close]
    vals = [r.t_first - r.due if math.isfinite(r.t_first) else math.inf for r in due]
    return p90(vals)
