"""Share of the card's bf16 peak in prefill: the operations the batch's
first tokens need (each request's real prompt only, causal attention over
it, the head at its last position) over the prefill's time (host clock to a
synchronise), summed over the traced run's prefills outside the profiled
stretch, in percent."""
from perfbench.flops import PEAK_BF16_FLOPS, first_token_flops


def read(run):
    flops = secs = 0.0
    for b in run.batches:
        if b.prefill_s is None or b.prefill_in_trace:
            continue
        flops += sum(first_token_flops(run.model, run.requests[i].prompt_len) for i in b.rows)
        secs += b.prefill_s
    return 100.0 * flops / (secs * PEAK_BF16_FLOPS) if secs else None
