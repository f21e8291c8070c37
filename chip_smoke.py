#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, drives the
provisioning path (``repro_torch.sim.run_scale`` with the ``vector_torch``
engine on ``cuda``) at the paper tier (1,000 VMs, 5 x 500 containers) and
the production-fleet tier (100,000 VMs, 25 x 40,000 containers), checks the
simulated outputs exactly against the values ``BENCH_scale.json`` records,
and times the kernels.  Each phase prints one JSON line; any failure raises
and the script exits non-zero.  The last lines are the kernel table, the
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
# (64 INT32 lanes per SM, half the FP32 rate).
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
INT32_OPS_PER_S = 33.5e12

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
    from repro_torch.kernels import _build

    fresh = not _build.library_path().exists()
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    emit("build", seconds=time.perf_counter() - t0, compiled=fresh,
         library=str(path.relative_to(ROOT)), nvcc_flags=" ".join(_build.NVCC_FLAGS))


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
    lib = _build.library()
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
    lib = _build.library()

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


def phase_timings(giga: dict) -> tuple[dict, dict]:
    k1 = {name: time_k1(ops) for name, (_, ops) in giga["fronts"].items()}
    k2 = time_k2(giga["k2_nodes_tensor"], giga["k2_nodes"])
    emit("timings", k1=k1, k2=k2)
    return k1, k2


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

    smi, name = phase_device()
    phase_build()
    k1_err = phase_kernels_vs_plain()
    paper = phase_paper_tier(bench)
    giga = phase_giga_tier(bench["giga_burst"])
    k1_t, k2_t = phase_timings(giga)

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
