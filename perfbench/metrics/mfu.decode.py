"""The decode step's share of its roofline: the least time the card could
take (the larger of operations over the bf16 peak and bytes over HBM
bandwidth: the weights once in bf16, each row's real keys and values read
and the new ones written) over the step's time (host clock to a
synchronise), summed over the traced run's steps outside the profiled
stretch, in percent."""
from perfbench.flops import decode_step_work, roofline_s


def read(run):
    bound = secs = 0.0
    for b in run.batches:
        for step_s, contexts, in_trace in b.steps:
            if in_trace:
                continue
            bound += roofline_s(*decode_step_work(run.model, contexts))
            secs += step_s
    return 100.0 * bound / secs if secs else None
