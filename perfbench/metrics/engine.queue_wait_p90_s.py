"""90th percentile of the wait from a request's due time to the start of
the ``step_batch`` call that served it, over the requests whose batch began
before the profiler started (the profiler slows the host)."""
from perfbench.harness import p90


def read(run):
    return p90([r.t_batch_start - r.due for r in run.requests
                if r.t_batch_start < run.trace_start])
