"""One benchmark per paper table/figure (FaaSNet, USENIX ATC'21), on the port.

The port's counterpart of ``benchmarks/paper_figures.py``.  Each function
returns a list of CSV rows ``(name, value, derived)`` with the paper's
reference number where one exists, and takes ``device`` (``"cuda"`` by
default), which it threads into every engine it builds:

  * Figures 11-15 go through the port's ``TraceReplay``, ``provision_wave``,
    ``scalability_table`` and ``startup_timeline`` on ``vector_torch``, the
    cap-chain kernel (K1) on ``device`` for wide fronts;
  * Figure 16 samples per-flow ``rate`` / ``started`` / ``done`` from
    ``add_plan``'s flow states, which only the incremental ``FlowSim``
    returns, so it keeps that engine;
  * Figures 17 and 18 build their shared engine with ``make_sim`` on
    ``vector_torch``, which takes ``add_plan(..., on_node_done=)`` and
    ``run()`` as ``sim/cluster.py`` uses them;
  * Figures 19 and 20 time and measure real block stores, written under
    ``tempfile``'s directory, from ``os.urandom`` payloads.

All simulated timings are deterministic simulator outputs, equal to the
reference's.
"""
from __future__ import annotations

import statistics as st

from repro_torch.sim import (
    ReplayConfig,
    TraceReplay,
    WaveConfig,
    iot_trace,
    provision_wave,
    scalability_table,
    startup_timeline,
    synthetic_gaming_trace,
)

Row = tuple[str, float, str]


def fig11_iot_trace(quick: bool = False, device: str = "cuda") -> list[Row]:
    """IoT trace replay: peak response + recovery (paper Fig. 11)."""
    rows: list[Row] = []
    trace = iot_trace(scale=1 / 3)[: (20 if quick else 35) * 60]
    burst_t = 9 * 60
    for system in ("faasnet", "on_demand", "baseline"):
        r = TraceReplay(ReplayConfig(system=system, idle_reclaim_s=420,
                                     wave=WaveConfig(device=device)))
        tl = r.run(trace)
        peak = max(ts.mean_response_s for ts in tl if ts.t >= burst_t)
        rec = r.recovery_time(burst_t + 60, normal_s=3.5)
        pl = r.prov_latencies
        rows.append((f"fig11/{system}/peak_resp_s", peak, "paper: faasnet 6, baseline 28"))
        rows.append((f"fig11/{system}/recovery_s", rec,
                     "paper: faasnet 28, on-demand 112, baseline 113"))
        if pl:
            rows.append((f"fig11/{system}/prov_mean_s", st.mean(pl), ""))
    return rows


def fig12_synthetic_trace(quick: bool = False, device: str = "cuda") -> list[Row]:
    """Synthetic gaming burst: FT height adaptation (paper Fig. 12)."""
    trace = synthetic_gaming_trace(scale=1.0)[: (15 if quick else 26) * 60]
    # short gaming functions (paper's synthetic burst grows to 82 VMs at
    # 100 RPS => sub-second effective service time)
    r = TraceReplay(ReplayConfig(system="faasnet", idle_reclaim_s=420,
                                 function_duration_s=0.8,
                                 wave=WaveConfig(device=device)))
    tl = r.run(trace)
    h_burst1 = max(ts.ft_height for ts in tl if 11 * 60 <= ts.t < 14 * 60)
    vm_peak = max(ts.active_vms for ts in tl)
    between = [ts.ft_height for ts in tl if 18 * 60 <= ts.t < 21 * 60]
    rows = [
        ("fig12/ft_height_burst1", h_burst1, "paper: 7 (82 VMs)"),
        ("fig12/active_vms_peak", vm_peak, "paper: ~82-102"),
    ]
    if between:
        rows.append(("fig12/ft_height_after_reclaim", min(between),
                     "paper: shrinks to 5-6 (~30 VMs)"))
    if len(tl) > 22 * 60:
        h_burst2 = max(ts.ft_height for ts in tl if 21 * 60 <= ts.t < 24 * 60)
        rows.append(("fig12/ft_height_burst2", h_burst2, "paper: 7 (102 VMs)"))
    return rows


def fig13_provisioning_cdf(quick: bool = False, device: str = "cuda") -> list[Row]:
    """Container provisioning latency distribution (paper Fig. 13)."""
    rows: list[Row] = []
    for name, system in (("faasnet", "faasnet"), ("on_demand", "on_demand")):
        lat = sorted(provision_wave(system, 64 if quick else 128,
                                    WaveConfig(device=device)).values())
        p = lambda q: lat[int(q * (len(lat) - 1))]
        rows.append((f"fig13/{name}/p50_s", p(0.5), ""))
        rows.append((f"fig13/{name}/p96_s", p(0.96),
                     "paper: faasnet 5.8-7.9 tight; on-demand 7-21 wide"))
        rows.append((f"fig13/{name}/spread_s", lat[-1] - lat[0], ""))
    return rows


def fig14_scalability(quick: bool = False, device: str = "cuda") -> list[Row]:
    """Provisioning latency vs concurrency, five systems (paper Fig. 14)."""
    ns = (8, 32) if quick else (8, 16, 32, 64, 128)
    table = scalability_table(ns=ns, cfg=WaveConfig(device=device))
    rows: list[Row] = []
    for system, per_n in table.items():
        for n, d in per_n.items():
            rows.append((f"fig14/{system}/n{n}_mean_s", d["mean"], ""))
    nmax = max(ns)
    f = table["faasnet"][nmax]["mean"]
    rows.append(("fig14/speedup_vs_baseline", table["baseline"][nmax]["mean"] / f,
                 "paper: 13.4x"))
    rows.append(("fig14/speedup_vs_kraken", table["kraken"][nmax]["max"] / f,
                 "paper: 16.3x"))
    rows.append(("fig14/speedup_vs_on_demand", table["on_demand"][nmax]["mean"] / f,
                 "paper: 5x"))
    rows.append(("fig14/speedup_vs_dadi", table["dadi_p2p"][nmax]["mean"] / f,
                 "paper: 2.8x"))
    return rows


def fig15_startup_timeline(quick: bool = False, device: str = "cuda") -> list[Row]:
    """Wall-clock span from first to last function start (paper Fig. 15)."""
    n = 64 if quick else 128
    rows: list[Row] = []
    for system in ("faasnet", "on_demand", "dadi_p2p"):
        tl = startup_timeline(system, n, WaveConfig(device=device))
        rows.append((f"fig15/{system}/first_start_s", tl[0],
                     "paper: faasnet first at 5.5s"))
        rows.append((f"fig15/{system}/span_s", tl[-1] - tl[0],
                     "paper: faasnet 1.5s, on-demand 16.4s, dadi 19s"))
    return rows


def fig16_bandwidth(quick: bool = False, device: str = "cuda") -> list[Row]:
    """Interior-VM in/out bandwidth during a wave (paper Fig. 16).

    Reads per-flow states, which only the incremental ``FlowSim`` hands
    back from ``add_plan``; ``device`` is threaded into its config all the
    same and reaches no kernel.
    """
    from repro_torch.core import FunctionTree
    from repro_torch.core.topology import faasnet_plan
    from repro_torch.sim import FlowSim, SimConfig

    cfg = WaveConfig(device=device)
    ft = FunctionTree("f")
    for i in range(64):
        ft.insert(f"vm{i}")
    interior = next(
        n.vm_id for n in ft.bfs() if len(n.children()) == 2 and n.parent is not None
    )
    plan = faasnet_plan(ft, image_bytes=cfg.image_bytes,
                        startup_fraction=cfg.startup_fraction)
    sim = FlowSim(SimConfig(per_stream_cap=cfg.per_stream_cap,
                            hop_latency=cfg.hop_latency,
                            engine="incremental", device=device))
    states = sim.add_plan(plan)
    # sample rates while running
    peak_in = peak_out = 0.0
    for t in range(1, 80):
        sim.run(until=float(t) * 0.1)
        rin = sum(f.rate for f in states
                  if f.flow.dst == interior and f.started and not f.done)
        rout = sum(f.rate for f in states
                   if f.flow.src == interior and f.started and not f.done)
        peak_in, peak_out = max(peak_in, rin), max(peak_out, rout)
    return [
        ("fig16/interior_peak_in_MBps", peak_in / 1e6, "paper: ~15 MB/s"),
        ("fig16/interior_peak_out_MBps", peak_out / 1e6, "paper: ~30 MB/s"),
        ("fig16/out_over_in", peak_out / max(peak_in, 1e-9),
         "paper: outbound ≈ 2x inbound (binary fan-out)"),
    ]


def fig17_large_scale(quick: bool = False, device: str = "cuda") -> list[Row]:
    """2,500 functions on 1,000 VMs (paper Fig. 17)."""
    from repro_torch.core import FTManager, VMInfo
    from repro_torch.core.topology import faasnet_plan
    from repro_torch.sim import SimConfig, make_sim

    n_vms = 200 if quick else 1000
    n_funcs = 500 if quick else 2500
    cfg = WaveConfig(image_bytes=int(428e6), container_start=2.5, device=device)
    mgr = FTManager()
    for i in range(n_vms):
        mgr.add_free_vm(VMInfo(f"vm{i}"))
        mgr.reserve_vm()
    # 3 distinct functions spread over the pool, 2-3 instances per VM
    sim = make_sim(SimConfig(per_stream_cap=cfg.per_stream_cap,
                             hop_latency=cfg.hop_latency,
                             registry_out_cap=cfg.registry_out_cap,
                             engine="vector_torch", device=device))
    done: dict[str, float] = {}
    for f in range(n_funcs // n_vms + 1):
        fid = f"f{f}"
        for i in range(n_vms):
            if f * n_vms + i >= n_funcs:
                break
            mgr.insert(fid, f"vm{i}")
        ft = mgr.trees.get(fid)
        if ft is None:
            continue
        plan = faasnet_plan(ft, image_bytes=cfg.image_bytes,
                            startup_fraction=cfg.startup_fraction)
        sim.add_plan(
            plan, t0=cfg.rpc.control_plane_total(),
            on_node_done=lambda vm, t, fid=fid: done.setdefault(f"{fid}@{vm}", t),
        )
    sim.run()
    extra = cfg.container_start + cfg.rpc.image_load
    lats = [t + extra for t in done.values()]
    return [
        ("fig17/n_functions", float(len(lats)), ""),
        ("fig17/first_start_s", min(lats), "paper: 5.1s"),
        ("fig17/last_start_s", max(lats), "paper: 8.3s"),
    ]


def fig18_placement(quick: bool = False, device: str = "cuda") -> list[Row]:
    """8 functions packed onto N VMs: FaaSNet vs DADI (paper Fig. 18)."""
    from repro_torch.core import FunctionTree
    from repro_torch.core.topology import dadi_plan, faasnet_plan
    from repro_torch.sim import SimConfig, make_sim

    img = int(75.4e6)
    rows: list[Row] = []
    for n_vms in (4, 2, 1):
        for system in ("faasnet", "dadi_p2p"):
            sim = make_sim(SimConfig(per_stream_cap=30e6, hop_latency=0.05,
                                     coordinator_cost_s=0.1 if system != "faasnet" else 0.0,
                                     engine="vector_torch", device=device))
            done: dict[str, float] = {}
            for f in range(8):
                nodes = [f"vm{i}" for i in range(n_vms)]
                if system == "faasnet":
                    ft = FunctionTree(f"f{f}")
                    for v in nodes:
                        ft.insert(v)
                    plan = faasnet_plan(ft, image_bytes=img, startup_fraction=0.16)
                else:
                    plan = dadi_plan(nodes, image_bytes=img, root="vm0",
                                     startup_fraction=0.16)
                sim.add_plan(plan, on_node_done=lambda vm, t, f=f: done.setdefault(
                    f"{f}@{vm}", t))
            sim.run()
            lat = list(done.values())
            rows.append((f"fig18/{system}/vms{n_vms}_max_s", max(lat),
                         "paper: dadi variance blows up at 1-2 VMs"))
    return rows


def fig19_code_packages(quick: bool = False, device: str = "cuda") -> list[Row]:
    """I/O-efficient format vs .zip for code packages (paper Fig. 19).

    Host file I/O only; ``device`` is taken for a uniform signature.
    """
    import io
    import os
    import tempfile
    import time
    import zipfile

    from repro_torch.core.blockstore import BlockReader, write_blockstore

    rows: list[Row] = []
    cases = {
        "helloworld": (11 * 1024, 1.0),  # tiny package, reads all
        "video": (2 << 20 if quick else 50 << 20, 0.2),  # reads 20% on start
        "ai": (4 << 20 if quick else 100 << 20, 0.1),
    }
    with tempfile.TemporaryDirectory() as tmp:
        for name, (size, need) in cases.items():
            payload = os.urandom(size // 2) + b"\x00" * (size - size // 2)
            t0 = time.monotonic()
            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
                z.writestr("pkg", payload)
            zbuf = buf.getvalue()
            with zipfile.ZipFile(io.BytesIO(zbuf)) as z:
                _ = z.read("pkg")  # .zip must extract everything
            t_zip = time.monotonic() - t0
            path = os.path.join(tmp, f"bench_{name}.blocks")
            t0 = time.monotonic()
            write_blockstore(payload, path)
            r = BlockReader(path)
            _ = r.read_range(0, int(size * need))  # on-demand subset
            t_blocks = time.monotonic() - t0
            rows.append((f"fig19/{name}/zip_s", t_zip, ""))
            rows.append((f"fig19/{name}/blocks_s", t_blocks,
                         "paper: I/O-efficient ≥ zip only for tiny packages"))
    return rows


def fig20_read_amplification(quick: bool = False, device: str = "cuda") -> list[Row]:
    """Bytes fetched vs block size on real block stores (paper Fig. 20).

    Host file I/O only; ``device`` is taken for a uniform signature.
    """
    import os
    import tempfile

    from repro_torch.core.blockstore import BlockReader, write_blockstore

    rows: list[Row] = []
    img = os.urandom((8 if quick else 64) << 20)
    startup = 0.15  # fraction of the image actually read at container start
    reads = [(int(len(img) * i / 37), 80_000) for i in range(0, 30)]
    with tempfile.TemporaryDirectory() as tmp:
        for bs in (128 << 10, 512 << 10, 2 << 20):
            path = os.path.join(tmp, f"bench_amp_{bs}.blocks")
            write_blockstore(img, path, block_size=bs)
            r = BlockReader(path)
            for off, ln in reads:
                r.read_range(min(off, len(img) - ln), ln)
            rows.append((f"fig20/bs{bs >> 10}k/fetched_over_needed",
                         r.stats.amplification(),
                         "paper: amplification grows with block size"))
            rows.append((f"fig20/bs{bs >> 10}k/net_reduction_vs_full",
                         1.0 - r.stats.fetched_compressed / len(img),
                         "paper: 83.9% reduction at 512KB"))
    return rows


ALL = [
    fig11_iot_trace,
    fig12_synthetic_trace,
    fig13_provisioning_cdf,
    fig14_scalability,
    fig15_startup_timeline,
    fig16_bandwidth,
    fig17_large_scale,
    fig18_placement,
    fig19_code_packages,
    fig20_read_amplification,
]
