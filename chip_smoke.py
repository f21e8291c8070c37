#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, all started together), holds each against its plain
PyTorch version on the card, and drives the port's two paths:

* provisioning: ``repro_torch.sim.run_scale`` with the ``vector_torch``
  engine on ``cuda`` at the paper tier (1,000 VMs, 5 x 500 containers) and
  the production-fleet tier (100,000 VMs, 25 x 40,000 containers), checked
  exactly against the values ``BENCH_scale.json`` records;
* serving: ``ServeEngine`` on ``deepseek_7b`` at full width (30 layers,
  d 4096, random float32 master weights drawn on the card from a seed) with
  ``attn_impl="pallas"``, answering 8 requests of 512 prompt tokens with 16
  new tokens each, 4 to a batch, so the flash-attention kernel runs at its
  serving shape; a float32 prefill of the same weights through the kernel
  and through the ``chunked`` attention must agree; and the block-checkpoint
  cold start (save, lazy restore, serve) on the smoke config.

It then times the kernels.  Each phase prints one JSON line; any failure
raises and the script exits non-zero.  The last lines are the kernel table, the
card's name and power limit as ``nvidia-smi`` reports them, and
``{"ok": true, "device": {...}}``.  Without CUDA, or outside a checkout, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

PAPER_MAKESPAN = 12.810758878720002
GIGA_MAKESPAN = 57.796700031959624
GIGA_FRONTS = 5949
GIGA_FLOWS = 5_361_821
GIGA_MEAN_WIDTH = GIGA_FLOWS // GIGA_FRONTS  # 901
SMALL_SHA = "bb5965a1fa885edd0aaf968dfec9bad59941edf5c13a367d869ed2eea7954c82"

# H100 SXM data sheet: HBM3 bandwidth, FP64 (non-tensor) peak, INT32 peak
# (64 INT32 lanes per SM, half the FP32 rate), dense BF16 tensor-core peak.
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
INT32_OPS_PER_S = 33.5e12
BF16_OPS_PER_S = 989e12

# K3 shapes: the flash-attention sweep of tests/test_kernels.py as
# (BH, T, hd, window), one masked-row window case, and the serving shape.
K3_SWEEP = [(8, 256, 64, None), (2, 512, 64, None), (4, 256, 128, None),
            (4, 256, 64, 64), (1, 128, 32, 32), (2, 256, 64, 16)]
K3_SERVE = (128, 512, 128, None)
K3_TOL = {"bfloat16": 2e-2, "float32": 2e-4}

SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW, SERVE_BATCH = 8, 512, 16, 4

CAPS = dict(
    per_stream_cap=30e6,
    in_cap=1.25e8,
    decompress_rate=2e9,
    block_size=float(512 * 1024),
)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ----------------------------------------------------------------------
# comparisons and timing
# ----------------------------------------------------------------------
def bit_mismatch(got, want) -> tuple[int, float]:
    """(lanes whose float64 bits differ, max |got - want|); NaN == NaN."""
    import torch

    got, want = got.detach().cpu(), want.detach().cpu()
    check(got.shape == want.shape and got.dtype == want.dtype, "shape or dtype differs")
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    differ = (got.view(torch.int64) != want.view(torch.int64)) & ~(nan_g & nan_w)
    n = int(differ.sum())
    if n == 0:
        return 0, 0.0
    return n, float((got[differ] - want[differ]).abs().nan_to_num(float("inf")).max())


def seeded_front(n: int, seed: int, blk_mode: str):
    """Cap-chain operands with the engine's edge lanes: inf caps, NaN, blk."""
    rng = np.random.default_rng(seed)
    n_out = rng.integers(1, 50, n)
    n_in = rng.integers(1, 50, n)
    out_cap = rng.uniform(1e6, 2e9, n)
    qps = rng.uniform(100.0, 5000.0, n)
    par = rng.uniform(1e6, 2e8, n)
    out_cap[rng.random(n) < 0.1] = np.inf
    qps[rng.random(n) < 0.3] = np.inf
    par[rng.random(n) < 0.3] = np.inf
    if n > 3:
        out_cap[n // 3] = np.nan
        par[n // 2] = np.nan
    blk = rng.random(n) < 0.5 if blk_mode == "mixed" else np.zeros(n, dtype=bool)
    return n_out, n_in, out_cap, qps, par, blk


def numpy_front_rates(ops, caps) -> np.ndarray:
    """The engine's numpy ``_front_rates`` arithmetic on gathered operands."""
    n_out, n_in, out_cap, qps, par, blk = ops
    r = np.minimum(caps["per_stream_cap"], out_cap / n_out)
    np.minimum(r, caps["in_cap"] / n_in, out=r)
    np.minimum(r, caps["decompress_rate"], out=r)
    if blk.any():
        bi = np.flatnonzero(blk)
        r[bi] = np.minimum(r[bi], caps["block_size"] * qps[bi] / n_out[bi])
    return np.minimum(r, par)


def graph_ms(fn, reps: int = 200) -> float:
    """Device time per call: ``reps`` calls captured in a CUDA graph, replayed."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def event_ms(fn, iters: int = 200) -> float:
    """Per-call time of back-to-back eager calls, by CUDA events."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 200) -> float:
    for _ in range(10):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def record_engine(on_engine):
    """Hand every engine ``run_scale`` builds to ``on_engine`` before it runs."""
    from repro_torch.sim import scale

    make = scale.make_sim

    def make_and_record(cfg, **kw):
        sim = make(cfg, **kw)
        on_engine(sim)
        return sim

    scale.make_sim = make_and_record
    try:
        yield
    finally:
        scale.make_sim = make


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def phase_device() -> tuple[str, str]:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    return smi, name


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build

    names = sorted(_build.LIBRARIES)
    fresh = {n: not _build.library_path(n).exists() for n in names}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, all at once
        paths = dict(zip(names, pool.map(_build.build, names)))
    for n in names:
        _build.library(n)
    emit("build", seconds=time.perf_counter() - t0, compiled=fresh,
         libraries={n: str(paths[n].relative_to(ROOT)) for n in names},
         nvcc_flags={n: " ".join(_build.LIBRARIES[n][1]) for n in names})


def phase_kernels_vs_plain() -> float:
    import torch

    from repro_torch.kernels import cap_chain as cc

    worst = 0.0
    for n in (1, 255, 257, 901, 100_000):
        for blk_mode in ("mixed", "none"):
            ops = seeded_front(n, seed=n, blk_mode=blk_mode)
            dev = [torch.from_numpy(a).cuda() for a in ops]
            got = cc.cap_chain_rates(*dev, **CAPS)
            torch.cuda.synchronize()
            for ref_name, want in (
                ("plain", cc.cap_chain_rates_torch(*dev, **CAPS)),
                ("numpy", torch.from_numpy(numpy_front_rates(ops, CAPS))),
            ):
                bad, err = bit_mismatch(got, want)
                check(bad == 0, f"K1 vs {ref_name} at n={n} blk={blk_mode}: {bad} lanes, max err {err}")
                worst = max(worst, err)
    nodes = torch.from_numpy(np.random.default_rng(7).integers(0, 1000, 100_000)).cuda()
    check(torch.equal(cc.nic_flow_counts(nodes, 1000), cc.nic_flow_counts_torch(nodes, 1000)),
          "K2 vs plain on seeded nodes")
    emit("kernels_vs_plain", k1_widths=[1, 255, 257, 901, 100_000], k1_bit_identical=True,
         k1_max_abs_err=worst, k2_exact=True)
    return worst


def run_tier(cfg):
    import torch

    from repro_torch.kernels import cap_chain as cc
    from repro_torch.sim import run_scale

    cc.reset_launches()
    t0 = time.perf_counter()
    res = run_scale(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, cc.cap_chain_rates.launches, cc.nic_flow_counts.launches


def phase_paper_tier(bench: dict) -> dict:
    from repro_torch.sim import ScaleConfig, WaveConfig, run_scale

    shape = dict(n_vms=1000, n_functions=5, containers_per_function=500, churn_ops=100, seed=0)
    res, wall, k1, k2 = run_tier(ScaleConfig(**shape, wave=WaveConfig(engine="vector_torch", device="cuda")))
    ds = res.dispatch_stats
    check(res.provision_makespan == PAPER_MAKESPAN, f"paper makespan {res.provision_makespan!r}")
    check(res.provision_makespan == bench["provision_makespan_s"], "paper makespan vs BENCH_scale.json")
    check(res.per_function == bench["per_function_makespan_s"], "paper per_function vs BENCH_scale.json")
    check(k1 == ds["fronts_torch"] == ds["fronts_vector"] > 0, f"paper launches {k1} vs {ds}")
    vec = run_scale(ScaleConfig(**shape, wave=WaveConfig(engine="vector")))
    check(res.per_function == vec.per_function and res.trace == vec.trace, "paper tier vs numpy vector engine")
    wide, _, k1_wide, _ = run_tier(ScaleConfig(
        **shape, wave=WaveConfig(engine="vector_torch", device="cuda", vector_scalar_cutoff=0)))
    dw = wide.dispatch_stats
    check(wide.provision_makespan == res.provision_makespan and wide.per_function == res.per_function
          and wide.trace == res.trace, "paper tier changed with vector_scalar_cutoff=0")
    check(k1_wide == dw["fronts_torch"] == dw["fronts_vector"] > 0 and dw["fronts_scalar"] == 0,
          f"cutoff-0 launches {k1_wide} vs {dw}")
    small = ScaleConfig(n_vms=32, n_functions=4, containers_per_function=8, churn_ops=5, seed=3,
                        wave=WaveConfig(engine="vector_torch", device="cuda"))
    sres, _, _, _ = run_tier(small)
    digest = hashlib.sha256("\n".join(f"{t!r} {e}" for t, e in sres.trace).encode()).hexdigest()
    check(digest == SMALL_SHA, f"small-config event-log SHA {digest}")
    out = dict(provision_makespan=res.provision_makespan, wall_s=wall, engine_wall_s=res.wall_s,
               events=res.events, events_per_s=res.events_per_s,
               fronts_torch=ds["fronts_torch"], flows_torch=ds["flows_torch"],
               k1_launches=k1, k2_launches=k2, cutoff0_fronts_torch=dw["fronts_torch"],
               cutoff0_launches=k1_wide, small_sha_ok=True)
    emit("paper_tier", **out)
    return out


def phase_giga_tier(bench: dict) -> dict:
    import torch

    from repro_torch.kernels import cap_chain as cc
    from repro_torch.sim import giga_burst_config

    engines, fronts = [], {}

    def on_engine(sim):
        engines.append(sim)
        rate = sim._front_rates

        def recording(fids, src, dst):
            # keep the operands of the widest front and of the front nearest
            # the mean width, for the timing phase
            w = int(fids.size)
            best = fronts.get("mean")
            if w > fronts.get("widest", (0,))[0]:
                fronts["widest"] = (w, sim._front_operands(fids, src, dst))
            if best is None or abs(w - GIGA_MEAN_WIDTH) < abs(best[0] - GIGA_MEAN_WIDTH):
                fronts["mean"] = (w, sim._front_operands(fids, src, dst))
            return rate(fids, src, dst)

        sim._front_rates = recording

    cfg = giga_burst_config()
    check(cfg.wave.engine == "vector_torch" and cfg.wave.device == "cuda", "giga tier defaults")
    with record_engine(on_engine):
        res, wall, k1, k2 = run_tier(cfg)
    ds = res.dispatch_stats
    check(res.provision_makespan == GIGA_MAKESPAN, f"giga makespan {res.provision_makespan!r}")
    check(res.per_function == bench["per_function_makespan_s"], "giga per_function vs BENCH_scale.json")
    check(ds["fronts_torch"] == ds["fronts_vector"] == GIGA_FRONTS, f"giga fronts {ds}")
    check(ds["flows_torch"] == ds["flows_vector"] == GIGA_FLOWS, f"giga flows {ds}")
    check(k1 == GIGA_FRONTS, f"giga K1 launches {k1}")
    (sim,) = engines
    # K2 on the tier's real plan: the source NIC of every one of its flows.
    n_flows, n_nodes = len(sim._flows), len(sim._nname)
    nodes = torch.from_numpy(sim._fsrc[:n_flows].copy()).cuda()
    got = cc.nic_flow_counts(nodes, n_nodes)
    check(torch.equal(got, cc.nic_flow_counts_torch(nodes, n_nodes)), "K2 vs plain on the giga plan")
    check(np.array_equal(got.cpu().numpy(), np.bincount(sim._fsrc[:n_flows], minlength=n_nodes)),
          "K2 vs numpy bincount on the giga plan")
    del sim, engines[:]
    # The same tier on the host-only numpy engine, on the same machine: the
    # card tier's cost or gain end to end, and one more exact comparison.
    vec, vec_wall, _, _ = run_tier(giga_burst_config(engine="vector"))
    check(vec.per_function == res.per_function, "giga tier vs numpy vector engine")
    out = dict(provision_makespan=res.provision_makespan, wall_s=wall, engine_wall_s=res.wall_s,
               build_s=res.build_s, events=res.events, events_per_s=res.events_per_s,
               n_flows=res.n_flows, fronts_torch=ds["fronts_torch"], flows_torch=ds["flows_torch"],
               fronts_scalar=ds["fronts_scalar"], k1_launches=k1, k2_launches=k2,
               mean_front=fronts["mean"][0], widest_front=fronts["widest"][0], k2_nodes=n_nodes,
               vector_wall_s=vec_wall, vector_engine_wall_s=vec.wall_s,
               vector_build_s=vec.build_s, vector_events_per_s=vec.events_per_s)
    emit("giga_tier", **out)
    return out | {"fronts": fronts, "k2_nodes_tensor": nodes}


def time_k1(ops) -> dict:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import cap_chain as cc

    n = ops[0].size
    dev = [torch.from_numpy(a).cuda() for a in ops]
    rate = torch.empty(n, dtype=torch.float64, device="cuda")
    lib = _build.library("cap_chain")
    ptrs = [t.data_ptr() for t in dev]

    def launch():
        rc = lib.repro_cap_chain_rates(*ptrs, rate.data_ptr(), n, *CAPS.values(),
                                       torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"K1 launch returned {rc}")

    def engine_path():
        put = [torch.from_numpy(a).to("cuda") for a in ops]
        return cc.cap_chain_rates(*put, **CAPS).cpu().numpy()

    out = dict(
        n=n,
        ms=graph_ms(launch),
        plain_ms=graph_ms(lambda: cc.cap_chain_rates_torch(*dev, **CAPS)),
        wrapper_ms=host_ms(engine_path),
        numpy_ms=host_ms(lambda: numpy_front_rates(ops, CAPS)),
    )
    check(bit_mismatch(torch.from_numpy(engine_path()), torch.from_numpy(numpy_front_rates(ops, CAPS)))[0] == 0,
          "K1 on a recorded giga front vs numpy")
    # 49 bytes a flow (two int64 counts, three doubles, one byte of blk read;
    # one double written); 12 fp64 operations a flow (two conversions,
    # three divisions, one product, six minima)
    out["bound_ms"], out["bound_by"] = bound_ms(49 * n, 12 * n, FP64_OPS_PER_S)
    return out


def time_k2(nodes, n_nodes: int) -> dict:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import cap_chain as cc

    n = nodes.numel()
    counts = torch.zeros(n_nodes, dtype=torch.int64, device="cuda")
    lib = _build.library("cap_chain")

    def launch():
        counts.zero_()
        rc = lib.repro_nic_flow_counts(nodes.data_ptr(), n, counts.data_ptr(),
                                       torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"K2 launch returned {rc}")

    ones = torch.ones_like(nodes)

    def plain():  # nic_flow_counts_torch without its host-side range check
        return torch.zeros(n_nodes, dtype=torch.int64, device="cuda").index_add_(0, nodes, ones)

    out = dict(
        n=n,
        n_nodes=n_nodes,
        ms=graph_ms(launch),
        plain_ms=graph_ms(plain),
        wrapper_ms=event_ms(lambda: cc.nic_flow_counts(nodes, n_nodes)),
        library_ms=event_ms(lambda: torch.bincount(nodes, minlength=n_nodes)),
    )
    # read each int64 index once, write each int64 count once; one add a flow
    out["bound_ms"], out["bound_by"] = bound_ms(8 * n + 8 * n_nodes, n, INT32_OPS_PER_S)
    return out


def k3_operands(bh: int, t: int, hd: int, dtype: str, seed: int):
    """q, k, v on the card: numpy normal draws rounded once to ``dtype``."""
    import torch

    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((bh, t, hd), dtype=np.float32))
            .to(device="cuda", dtype=getattr(torch, dtype)) for _ in range(3)]


def phase_k3_vs_plain() -> dict:
    import torch

    from repro_torch.kernels import flash_attention as fa

    worst, per_shape = {}, []
    cases = [(shape, dt) for dt in ("bfloat16", "float32") for shape in K3_SWEEP]
    cases.append((K3_SERVE, "bfloat16"))
    for (bh, t, hd, window), dt in cases:
        q, k, v = k3_operands(bh, t, hd, dt, seed=bh * 1000 + t + hd)
        got = fa.flash_attention_bhtd(q, k, v, scale=hd**-0.5, window=window)
        torch.cuda.synchronize()
        want = fa.flash_attention_torch(q, k, v, scale=hd**-0.5, window=window)
        check(got.dtype == q.dtype and got.shape == q.shape, f"K3 output at {(bh, t, hd)}")
        check(bool(torch.isfinite(got).all()), f"K3 non-finite at {(bh, t, hd, window)} {dt}")
        err = float((got.float() - want.float()).abs().max())
        check(err <= K3_TOL[dt], f"K3 vs plain at {(bh, t, hd, window)} {dt}: max err {err}")
        worst[dt] = max(worst.get(dt, 0.0), err)
        per_shape.append({"bh": bh, "t": t, "hd": hd, "window": window, "dtype": dt,
                          "max_abs_err": err})
    emit("k3_vs_plain", tolerances=K3_TOL, worst=worst, shapes=per_shape)
    return {"worst": worst, "serve_err": per_shape[-1]["max_abs_err"]}


def serve_prompts(cfg, n: int, length: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=length) for _ in range(n)]


def phase_serve_full_width() -> dict:
    """deepseek_7b at full width through ServeEngine on the card, with K3."""
    import dataclasses

    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.params import tree_leaves_with_path
    from repro_torch.serving.engine import ServeEngine

    cfg = dataclasses.replace(get_config("deepseek_7b"), attn_impl="pallas")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, max_batch=SERVE_BATCH, device="cuda")
    params = eng.model.init(torch.Generator(device="cuda").manual_seed(0))
    eng.set_params(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for _, x in tree_leaves_with_path(params))
    check(n_params == cfg.param_count(), f"param count {n_params} vs {cfg.param_count()}")

    walls = {"prefill": [], "decode": []}

    def timed(kind, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            walls[kind].append(time.perf_counter() - t)
            return out
        return run

    model = eng.model
    eng.model = dataclasses.replace(model, prefill=timed("prefill", model.prefill),
                                    decode_step=timed("decode", model.decode_step))
    prompts = serve_prompts(cfg, SERVE_REQUESTS, SERVE_PROMPT, seed=0)
    kernels.reset_launches()
    t_serve = time.perf_counter()
    for pr in prompts:
        eng.submit(pr, max_new_tokens=SERVE_NEW)
    done = []
    while eng.queue:
        done += eng.step_batch()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t_serve
    launches = fa.flash_attention_bhtd.launches
    n_prefills = -(-SERVE_REQUESTS // SERVE_BATCH)
    check(len(walls["prefill"]) == n_prefills, f"prefills {len(walls['prefill'])}")
    check(launches == cfg.n_layers * n_prefills,
          f"K3 launches {launches} vs {cfg.n_layers} x {n_prefills}")
    check(len(walls["decode"]) == n_prefills * (SERVE_NEW - 1), f"decode steps {len(walls['decode'])}")
    check(all(len(r.out_tokens) == SERVE_NEW for r in done) and len(done) == SERVE_REQUESTS,
          "every request got its tokens")
    check(all(0 <= tok < cfg.vocab_size for r in done for tok in r.out_tokens), "token ids in range")
    peak = torch.cuda.max_memory_allocated()
    ttft = [r.t_first_token - r.t_submit for r in done]
    lat = [r.t_done - r.t_submit for r in done]
    out = dict(
        arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model, params=n_params,
        requests=SERVE_REQUESTS, prompt_len=SERVE_PROMPT, new_tokens=SERVE_NEW,
        max_batch=SERVE_BATCH, k3_launches=launches, prefills=n_prefills,
        decode_steps=len(walls["decode"]), weights_init_s=init_s,
        cold_path_ttft_s=init_s + ttft[0], ttft_s=ttft, latency_s=lat,
        serve_wall_s=serve_s, prefill_wall_s=walls["prefill"], decode_wall_s=sum(walls["decode"]),
        decode_step_mean_s=sum(walls["decode"]) / len(walls["decode"]),
        tokens_per_s=SERVE_REQUESTS * SERVE_NEW / serve_s,
        peak_memory_bytes=peak, first_tokens=[r.out_tokens[:4] for r in done],
    )
    out["profile"] = profile_prefill_and_decode(model, params, prompts[:SERVE_BATCH])
    out["f32_check"] = f32_pallas_vs_chunked(cfg, params, prompts[:SERVE_BATCH])
    emit("serve_full_width", **out)
    del eng, params
    torch.cuda.empty_cache()
    return out


def profile_prefill_and_decode(model, params, prompts) -> dict:
    """Device busy time against wall time for one prefill and one decode step
    of a full batch, from a ``torch.profiler`` trace (kernel events only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    toks = torch.from_numpy(np.stack(prompts).astype(np.int32)).cuda()
    out = {}
    cache = None
    for kind in ("prefill", "decode"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if kind == "prefill":
                logits, cache = model.prefill(params, {"tokens": toks}, cache_len=toks.shape[1] + 1)
            else:
                nxt = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
                logits, cache = model.decode_step(params, {"tokens": nxt, "pos": toks.shape[1]}, cache)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        out[kind] = dict(wall_ms=wall * 1e3, device_busy_ms=busy,
                         idle_share=1 - busy / (wall * 1e3), kernels=sum(1 for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                         top_ms=[[name[:80], ms] for name, ms in top])
    return out


def f32_pallas_vs_chunked(cfg, params, prompts) -> dict:
    """One full-width float32 prefill through K3 and through ``chunked``."""
    import dataclasses

    import torch

    from repro_torch.models import model_for

    toks = torch.from_numpy(np.stack(prompts).astype(np.int32)).cuda()
    logits = {}
    for impl in ("pallas", "chunked"):
        m = model_for(dataclasses.replace(cfg, compute_dtype="float32", attn_impl=impl))
        out, _ = m.prefill(params, {"tokens": toks})
        logits[impl] = out
        torch.cuda.synchronize()
    lp, lc = logits["pallas"], logits["chunked"]
    check(bool(torch.isfinite(lp).all()), "f32 pallas logits finite")
    diff = float((lp - lc).abs().max())
    scale = float(lc.abs().max())
    last_p, last_c = lp[:, -1].argmax(-1), lc[:, -1].argmax(-1)
    agree = float((lp.argmax(-1) == lc.argmax(-1)).float().mean())
    check(torch.equal(last_p, last_c), f"f32 greedy tokens differ: {last_p.tolist()} vs {last_c.tolist()}")
    check(diff <= 1e-3 * scale, f"f32 pallas vs chunked: max diff {diff} at max |logit| {scale}")
    return dict(shape=list(lp.shape), max_abs_diff=diff, max_abs_logit=scale,
                rel_diff=diff / scale, limit=1e-3, greedy_tokens=last_p.tolist(),
                argmax_agreement_all_positions=agree)


def phase_cold_start() -> dict:
    """launch/serve's flow on deepseek_7b's smoke config: save, lazy start, serve."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import serve
    from repro_torch.serving.engine import ServeEngine

    cfg = dataclasses.replace(get_smoke("deepseek_7b"), attn_impl="pallas", compute_dtype="float32")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        fa.reset_launches()
        eng, done = serve(cfg, requests=8, max_new_tokens=8, prompt_len=16,
                          ckpt_dir=ckpt_dir, device="cuda", seed=0)
        torch.cuda.synchronize()
        launches = fa.flash_attention_bhtd.launches
        check(launches == cfg.n_layers * 2, f"cold-start K3 launches {launches}")
        stats = eng.cold_start_stats
        check(0 < stats["first_fetch_compressed_bytes"] <= stats["total_fetch_compressed_bytes"],
              f"cold-start fetch stats {stats}")
        # The same checkpoint served on the CPU (plain versions) gives the same tokens.
        cpu = ServeEngine(cfg, max_batch=4, device="cpu")
        cpu.start(CheckpointManager(ckpt_dir), 0, eng.params, lazy=True)
        check({k: cpu.cold_start_stats[k] for k in ("first_fetch_compressed_bytes", "read_amplification")}
              == {k: stats[k] for k in ("first_fetch_compressed_bytes", "read_amplification")},
              "cold-start stats on cpu vs cuda")
        for pr in serve_prompts(cfg, 8, 16, seed=0):
            cpu.submit(pr, max_new_tokens=8)
        cpu_done = []
        while cpu.queue:
            cpu_done += cpu.step_batch()
        check([r.out_tokens for r in done] == [r.out_tokens for r in cpu_done],
              "cold-start tokens on the card vs the CPU")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    out = dict(arch=cfg.name, k3_launches=launches, requests=len(done),
               tokens_equal_cpu=True, **{k: v for k, v in stats.items()})
    emit("cold_start", **out)
    return out


def time_k3() -> dict:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    bh, t, hd, _ = K3_SERVE
    q, k, v = k3_operands(bh, t, hd, "bfloat16", seed=1)
    o = torch.empty_like(q)
    lib = _build.library("flash_attention")
    scale = hd**-0.5

    def launch():
        rc = lib.repro_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                       bh, t, hd, 1, scale, 2**31 - 1,
                                       torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"K3 launch returned {rc}")

    b4 = [x.view(4, bh // 4, t, hd) for x in (q, k, v)]
    out = dict(
        bh=bh, t=t, hd=hd, dtype="bfloat16",
        ms=graph_ms(launch, reps=50),
        plain_ms=event_ms(lambda: fa.flash_attention_torch(q, k, v, scale=scale), iters=20),
        wrapper_ms=event_ms(lambda: ops.flash_attention(*b4, scale=scale), iters=50),
        library_ms=event_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            *b4, is_causal=True, scale=scale), iters=50),
    )
    # causal half of 4 BH T^2 hd flops at the bf16 tensor rate; q, k, v, o once each
    out["bound_ms"], out["bound_by"] = bound_ms(4 * bh * t * hd * 2, 4 * bh * t * t * hd / 2,
                                                BF16_OPS_PER_S)
    return out


def phase_timings(giga: dict) -> tuple[dict, dict, dict]:
    k1 = {name: time_k1(ops) for name, (_, ops) in giga["fronts"].items()}
    k2 = time_k2(giga["k2_nodes_tensor"], giga["k2_nodes"])
    k3 = time_k3()
    emit("timings", k1=k1, k2=k2, k3=k3)
    return k1, k2, k3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir() or not (ROOT / "BENCH_scale.json").is_file():
        print(f"chip_smoke: run from the root of a checkout ({ROOT} has no src/repro_torch)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    bench = json.loads((ROOT / "BENCH_scale.json").read_text())
    t_start = time.perf_counter()

    # float32 products in full float32 (the defaults, stated): the f32 check
    # compares two attention paths, not TF32 rounding
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi, name = phase_device()
    phase_build()
    k1_err = phase_kernels_vs_plain()
    k3_check = phase_k3_vs_plain()
    paper = phase_paper_tier(bench)
    giga = phase_giga_tier(bench["giga_burst"])
    serve = phase_serve_full_width()
    cold = phase_cold_start()
    k1_t, k2_t, k3_t = phase_timings(giga)

    src = "src/repro_torch/kernels/csrc/cap_chain.cu"
    mean = k1_t["mean"]
    kernels = [
        {"name": "cap_chain_rates", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/cap_chain.py:102",
         "launches": giga["k1_launches"], "max_abs_err": k1_err,
         "ms": mean["ms"], "plain_ms": mean["plain_ms"],
         "bound_ms": mean["bound_ms"], "bound_by": mean["bound_by"], "library_ms": None,
         "on_main_path": True, "n": mean["n"], "wrapper_ms": mean["wrapper_ms"],
         "numpy_ms": mean["numpy_ms"], "paper_tier_launches": paper["k1_launches"]},
        {"name": "nic_flow_counts", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/cap_chain.py:137",
         "launches": giga["k2_launches"], "max_abs_err": 0.0,
         "ms": k2_t["ms"], "plain_ms": k2_t["plain_ms"],
         "bound_ms": k2_t["bound_ms"], "bound_by": k2_t["bound_by"],
         "library_ms": k2_t["library_ms"],
         "on_main_path": False, "n": k2_t["n"], "wrapper_ms": k2_t["wrapper_ms"]},
        {"name": "flash_attention_bhtd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:25",
         "launches": serve["k3_launches"], "max_abs_err": k3_check["serve_err"],
         "ms": k3_t["ms"], "plain_ms": k3_t["plain_ms"],
         "bound_ms": k3_t["bound_ms"], "bound_by": k3_t["bound_by"],
         "library_ms": k3_t["library_ms"], "library": "scaled_dot_product_attention",
         "on_main_path": True, "shape": [k3_t["bh"], k3_t["t"], k3_t["hd"]], "dtype": "bfloat16",
         "wrapper_ms": k3_t["wrapper_ms"], "cold_start_launches": cold["k3_launches"]},
    ]
    # The engine keeps its per-NIC counts incrementally and never calls K2,
    # as in the JAX package; every kernel it does call must have launched.
    for k in kernels:
        check(not k["on_main_path"] or k["launches"] > 0, f"{k['name']} never launched on the main path")
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
