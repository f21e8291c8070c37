"""Tokens kept (each request's up to its own ``max_new_tokens``) that were
complete by the window's close, over the window's whole length."""


def read(run):
    done = sum(1 for r in run.requests for t in r.token_times[:r.max_new]
               if t <= run.window_close)
    return done / run.seconds
