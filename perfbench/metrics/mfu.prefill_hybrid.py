"""Share of the card's bf16 peak in a hybrid model's prefill: ``mfu.prefill``
applied to the first-token operations of ``flops_hybrid.py`` (projections,
the SSD's chunked products, router, top-k and shared experts, NoPE attention
over half the causal square, the head at the last position) over the
prefill's time (host clock to a synchronise), summed over the traced run's
prefills outside the profiled stretch, in percent."""
from perfbench.flops import PEAK_BF16_FLOPS
from perfbench.flops_hybrid import first_token_flops


def read(run):
    if not run.model.get("ssm"):
        return None
    flops = secs = 0.0
    for b in run.batches:
        if b.prefill_s is None or b.prefill_in_trace:
            continue
        flops += sum(first_token_flops(run.model, run.requests[i].prompt_len) for i in b.rows)
        secs += b.prefill_s
    return 100.0 * flops / (secs * PEAK_BF16_FLOPS) if secs else None
