"""Tokens kept over the token slots computed (rows x the batch's longest
budget: a batch decodes to its longest request), over the batches that ran
to their end, in percent."""
import math


def read(run):
    done = [b for b in run.batches if math.isfinite(b.t_end) and all(
        run.requests[i].finished for i in b.rows)]
    kept = sum(min(len(run.requests[i].tokens), run.requests[i].max_new)
               for b in done for i in b.rows)
    slots = sum(len(b.rows) * b.budget for b in done)
    return 100.0 * kept / slots if slots else None
