"""Device milliseconds of the operations launched inside the router's
dispatch plan (``models/moe.py``: router logits, ``route_topk``, the
scatter into the expert buffer) per 1,000 tokens routed through every
expert layer of the model, in the profiled stretch."""


def read(run):
    moe = run.model.get("moe")
    if run.trace is None or not moe:
        return None
    first, every = moe.get("moe_first_dense", 0), moe.get("moe_every", 1)
    layers = len(range(first, run.model["n_layers"], every))
    calls = run.trace.range_device_s("bench.router")
    tokens = sum(int(args[0]) for args, _ in calls) / layers
    dev_s = sum(s for _, s in calls)
    return dev_s * 1e3 / (tokens / 1e3) if tokens and dev_s > 0 else None
