"""Serving driver: a traffic mix through ``repro_torch.serving.engine.ServeEngine``.

Set-up draws the weights on the device from the seed (the reference's
:func:`make_params`), hands them to the engine with ``set_params``, and serves
one warm-up batch of the mix's longest prompts.  The window then offers the
mix's requests at their due times (``submit``) and serves batches
(``step_batch``) whenever the queue holds any.  The harness wraps the
engine's two model calls to see when each step starts; in a traced run it
also synchronises after each, and puts ``bench.*`` ranges around them, the
router's dispatch plan and the flash-attention entry.

How the window ends is the mix's ``close``: ``drain`` serves every request
due in the window, however long that takes past the close (and idles until
the close if they are done before it); ``cut`` starts no batch after the
close and stops the batch in flight at its first step after it.

After the window, a sample of the served requests drawn from the seed (the
longest among them) is checked against the plain reference: the gap by which
each served token's reference logit lies below the reference's best, as its
widest (``served_logit_gap``) and its mean (``served_logit_gap_mean``); a
cell's limits file names which of the two it compares.  The precision control
(``control=True``: the reference with fp8 linear layers picks each token) is
judged by the same function against the same limits.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import time

import numpy as np

from perfbench import traffic
from perfbench.harness import Batch, Request, RunRecord
from perfbench.trace import summarize


class WindowClosed(Exception):
    """Raised inside the engine's decode call at the close of a ``cut`` window."""


def port_config(model: dict):
    from repro_torch.configs.base import ModelConfig, MoEConfig

    kw = dict(model)
    moe = kw.pop("moe", None)
    return ModelConfig(**kw, moe=MoEConfig(**moe) if moe else None)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Observer:
    """Wraps the engine's ``prefill`` and ``decode_step``: records when each
    call starts, and in a traced run its synchronised duration and range.

    A traced run profiles the last ``trace_seconds`` of the window: the
    profiler starts at the first model call or wait after that point and
    stops at the first one after the close (or when the window's work is
    done).  Host-clock readings taken before it started, and model calls
    timed after it stopped, are not slowed by it."""

    def __init__(self, run: RunRecord, device, traced: bool, cut: bool):
        self.run, self.device, self.traced, self.cut = run, device, traced, cut
        self.batch: Batch | None = None
        self.prof = None
        self.trace_from = math.inf

    def _range(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def maybe_trace(self) -> None:
        """Start the profiler once ``trace_from`` has come; stop it at the
        window's close, so a long drain does not lengthen the stretch."""
        now = time.monotonic()
        if self.prof is not None and now >= self.run.window_close:
            self.stop_trace()
        elif self.traced and self.prof is None and now >= self.trace_from:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
            self.run.trace_start = time.monotonic()
            self.trace_from = math.inf  # started: no more waking for it

    def stop_trace(self) -> None:
        if self.prof is not None:
            _sync(self.device)
            end = time.monotonic()
            self.prof.stop()
            self.run.trace = summarize(self.prof, end - self.run.trace_start)
            self.prof = None

    @property
    def in_trace(self) -> bool:
        return self.prof is not None

    def wrap(self, model):
        real_prefill, real_decode = model.prefill, model.decode_step

        def prefill(params, batch, cache_len=None):
            self.maybe_trace()
            in_trace = self.in_trace
            t = time.monotonic()
            with self._range("bench.prefill"):
                out = real_prefill(params, batch, cache_len=cache_len)
                if self.traced:
                    _sync(self.device)
                    self.batch.prefill_s = time.monotonic() - t
                    self.batch.prefill_in_trace = in_trace
            return out

        def decode_step(params, batch, cache):
            t = time.monotonic()
            b = self.batch
            b.step_calls.append(t)
            if self.cut and t >= self.run.window_close:
                raise WindowClosed
            self.maybe_trace()
            in_trace = self.in_trace
            t = time.monotonic()
            with self._range("bench.decode_step"):
                out = real_decode(params, batch, cache)
                if self.traced:
                    _sync(self.device)
                    k = len(b.step_calls)  # step k: k - 1 served tokens are cached
                    ctx = [self.run.requests[i].prompt_len + k - 1 for i in b.rows]
                    b.steps.append((time.monotonic() - t, ctx, in_trace))
            return out

        return dataclasses.replace(model, prefill=prefill, decode_step=decode_step)


@contextlib.contextmanager
def _traced_entries():
    """Ranges around the router's dispatch plan and the flash-attention entry,
    each named with the shapes its reader needs."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import moe

    real_fa, real_plan = ops.flash_attention, moe._dispatch_combine_plan

    def flash_attention(q, k, v, **kw):
        b, h, t, hd = q.shape
        with torch.profiler.record_function(f"bench.k3|{b * h}|{t}|{hd}|{q.element_size()}"):
            return real_fa(q, k, v, **kw)

    def plan(xf, router, m, t):
        with torch.profiler.record_function(f"bench.router|{xf.shape[0]}"):
            return real_plan(xf, router, m, t)

    ops.flash_attention, moe._dispatch_combine_plan = flash_attention, plan
    try:
        yield
    finally:
        ops.flash_attention, moe._dispatch_combine_plan = real_fa, real_plan


def _longest_prompt(mix: dict) -> int:
    spec = mix["prompt_tokens"]
    return int(spec["value"] if spec["dist"] == "fixed" else spec["max"])


def _serve_batch(engine, run: RunRecord, obs: _Observer, rid_to_req: dict) -> bool:
    """One ``step_batch``; False when the window's close cut it short."""
    head = list(engine.queue)[:engine.max_batch]
    rows = [rid_to_req[r.rid] for r in head]
    reqs = [run.requests[i] for i in rows]
    b = Batch(rows=rows, t_start=time.monotonic(),
              padded_t=max(r.prompt_len for r in reqs), budget=max(r.max_new for r in reqs))
    run.batches.append(b)
    for r in reqs:
        r.batch, r.t_batch_start = len(run.batches) - 1, b.t_start
    obs.batch = b
    cut = False
    try:
        with obs._range("bench.step_batch"):
            engine.step_batch()
    except WindowClosed:
        cut = True
    b.t_end = time.monotonic()
    for r, er in zip(reqs, head):
        r.tokens = list(er.out_tokens)
        r.t_first = er.t_first_token if er.out_tokens else math.nan
        # token j > 0 is complete when step j + 1 is called, or at t_done
        r.token_times = [r.t_first] + [
            b.step_calls[j] if j < len(b.step_calls) else er.t_done
            for j in range(1, len(r.tokens))]
        r.finished = not cut
        r.t_done = er.t_done if not cut else math.nan
    return not cut


def drive(cell, seed: int, seconds: float, traced: bool, device: str, t0: float,
          control: bool = False, check: bool = True) -> dict:
    import torch
    from repro_torch.kernels import reset_launches
    from repro_torch.serving.engine import ServeEngine

    dev = torch.device(device)
    mix, config = cell.mix, cell.config
    model, deploy = config["model"], config["deployment"]
    ref = cell.reference()
    run = RunRecord(config=config, mix=mix, seconds=seconds)
    cut = mix.get("close", "drain") == "cut"

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = ref.make_params(model, seed, dev)
    engine = ServeEngine(port_config(model), max_batch=deploy["max_batch"],
                         max_len=deploy["context"], device=dev)
    engine.set_params(params)
    obs = _Observer(run, dev, traced, cut)
    engine.model = obs.wrap(engine.model)

    # warm-up: one full batch of the mix's longest prompt, two tokens each
    warm = np.random.default_rng([int(seed), 1])
    longest = _longest_prompt(mix)
    for _ in range(engine.max_batch):
        engine.submit(warm.integers(1, model["vocab_size"], longest).astype(np.int32), 2)
    obs.batch = Batch(rows=[], t_start=0.0, padded_t=longest, budget=2)
    engine.step_batch()
    engine.done.clear()
    _sync(dev)
    reset_launches()

    if traced:  # the profiler's first start initialises it: seconds, kept out of the window
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            _sync(dev)
    arrivals = traffic.generate(mix, seconds, seed, model["vocab_size"])
    # set-up's objects out of the collector's way, so its pauses in the
    # window do not depend on what set-up left behind
    gc.collect()
    gc.freeze()
    ctx = _traced_entries() if traced else contextlib.nullcontext()
    with ctx:
        run.window_open = time.monotonic()
        run.setup_s = run.window_open - t0
        run.window_close = run.window_open + seconds
        if traced:
            obs.trace_from = run.window_close - float(mix.get("trace_seconds", seconds))
        run.requests = [Request(due=run.window_open + a.due_s, prompt_len=a.prompt_len,
                                max_new=a.max_new, prompt=a.prompt) for a in arrivals]
        rid_to_req: dict = {}
        i, n = 0, len(arrivals)
        while True:
            now = time.monotonic()
            while i < n and run.requests[i].due <= now:
                r = run.requests[i]
                rid_to_req[engine.submit(r.prompt, r.max_new)] = i
                i += 1
            if engine.queue:
                if cut and now >= run.window_close:
                    break
                if not _serve_batch(engine, run, obs, rid_to_req):
                    break
            elif i < n or now < run.window_close:  # idle until the next due or the close
                obs.maybe_trace()
                nxt = run.requests[i].due if i < n else run.window_close
                with obs._range("bench.wait"):
                    time.sleep(max(min(nxt, obs.trace_from) - time.monotonic(), 0.0))
            else:
                break
        _sync(dev)
        run.window_end = time.monotonic()
        obs.stop_trace()
    gc.unfreeze()
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0

    # the program's state goes before the reference runs
    del engine, obs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if not check:
        return {"record": run, "memory_peak_bytes": peak}
    return {"record": run, "memory_peak_bytes": peak,
            **check_sample(cell, ref, params, run, seed, control=control)}


def _sample(run: RunRecord, seed: int, k: int) -> list[int]:
    """``k`` requests with served tokens (finished, or stopped by a cut
    window's close) drawn from the seed, the longest among them."""
    done = [i for i, r in enumerate(run.requests) if r.tokens]
    if not done:
        return []
    longest = max(done, key=lambda i: (run.batches[run.requests[i].batch].padded_t
                                       + run.requests[i].max_new, -i))
    rest = [i for i in done if i != longest]
    rng = np.random.default_rng([int(seed), 2])
    pick = list(rng.choice(rest, size=min(k - 1, len(rest)), replace=False)) if rest else []
    return sorted([longest, *pick])


def check_sample(cell, ref, params, run: RunRecord, seed: int, control: bool = False) -> dict:
    """Compare the sampled requests' served tokens with the reference.

    A router with a capacity makes a batch's rows depend on each other, so a
    configuration with experts has its sampled requests' whole batches
    recomputed; otherwise only the sampled rows, each left-padded to its
    batch's length as the engine padded it."""
    import torch

    t_check = time.monotonic()
    model = run.model
    dev = next(iter(params["embed"].values())).device
    if run.mix.get("close", "drain") == "cut":
        # requests whose batch began; the close stops the last one by design
        attempted = [r for r in run.requests if r.batch >= 0]
        failed = sum(1 for r in attempted if r.finished and len(r.tokens) != r.max_new)
    else:  # every request due in the window has to finish
        attempted = [r for r in run.requests if r.due < run.window_close]
        failed = sum(1 for r in attempted if not r.finished or len(r.tokens) != r.max_new)
    sample = _sample(run, seed, int(run.mix.get("check_requests", 16)))
    by_batch: dict[int, list[int]] = {}
    for i in sample:
        by_batch.setdefault(run.requests[i].batch, []).append(i)
    gaps, control_gaps, compared = [], [], 0
    for bi, picked in sorted(by_batch.items()):
        b = run.batches[bi]
        rows = b.rows if model.get("moe") else picked
        reqs = [run.requests[i] for i in rows]
        n_gen = max(len(r.tokens) for r in reqs) - 1
        prompts = torch.zeros((len(rows), b.padded_t), dtype=torch.long)
        gen = torch.zeros((len(rows), max(n_gen, 0)), dtype=torch.long)
        for j, r in enumerate(reqs):
            prompts[j, b.padded_t - r.prompt_len:] = torch.from_numpy(r.prompt.astype(np.int64))
            gen[j, :len(r.tokens) - 1] = torch.tensor(r.tokens[:-1], dtype=torch.long)
        logits = ref.served_logits(model, params, prompts.to(dev), gen.to(dev))
        low = ref.served_logits(model, params, prompts.to(dev), gen.to(dev), quant="fp8") \
            if control else None
        for j, i in enumerate(rows):
            if i not in picked:
                continue
            r = run.requests[i]
            lg = logits[j, :len(r.tokens)]
            best = lg.max(dim=-1).values
            served = lg.gather(1, torch.tensor(r.tokens, device=dev)[:, None])[:, 0]
            gaps += (best - served).tolist()
            compared += len(r.tokens)
            if low is not None:
                pick = low[j, :len(r.tokens)].argmax(dim=-1)
                control_gaps += (best - lg.gather(1, pick[:, None])[:, 0]).tolist()
        del logits, low
    readings = gap_readings(gaps)
    checks, correct = judge(readings, cell.limits, failed, compared)
    out = {"attempted": len(attempted), "failed": failed, "checks": checks,
           "correct": correct, "sampled_requests": len(sample), "readings": readings,
           "token_gaps": gaps, "check_s": time.monotonic() - t_check}
    if control:
        # the control stands in the program's place: the same sample, the same verdict
        out["control_readings"] = gap_readings(control_gaps)
        out["control_correct"] = judge(out["control_readings"], cell.limits, 0,
                                       len(control_gaps))[1]
        out["control_token_gaps"] = control_gaps
    return out


def gap_readings(gaps: list) -> dict:
    """The numbers a cell's limits may name: the widest and the mean gap."""
    return {"served_logit_gap": max(gaps) if gaps else math.inf,
            "served_logit_gap_mean": sum(gaps) / len(gaps) if gaps else math.inf}


def judge(readings: dict, limits: dict, failed: int, compared: int) -> tuple[dict, bool]:
    """Each reading the cell's limits name beside its limit, with the failed
    requests (limit 0) and the compared tokens (at least 1); and the verdict."""
    checks = {name: {"value": readings[name], "limit": limits[name]["limit"]}
              for name in readings if name in limits}
    if not checks:
        raise KeyError(f"the limits name none of {sorted(readings)}")
    correct = failed == 0 and compared >= 1 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    checks["failed_requests"] = {"value": failed, "limit": 0}
    checks["compared_tokens"] = {"value": compared, "limit": 1}
    return checks, bool(correct)
