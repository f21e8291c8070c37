"""Real prompt tokens over the tokens prefilled (rows x the batch's padded
length), over every batch of the window, in percent."""


def read(run):
    real = sum(run.requests[i].prompt_len for b in run.batches for i in b.rows)
    padded = sum(len(b.rows) * b.padded_t for b in run.batches)
    return 100.0 * real / padded if padded else None
