"""The port's provisioning path held against the JAX package, on the CPU.

``repro_torch``'s ``VectorTorchFlowSim`` (``device="cpu"``: the plain
PyTorch cap chain) must be bit-identical to the JAX package's ``FlowSim``,
``VectorFlowSim`` and ``VectorJaxFlowSim`` — a five-way differential with
the port's own numpy ``VectorFlowSim`` alongside — on the canonical plans of
``tests/test_vector_engine.py``, each plan built by each package's own
topology code.  The port's harnesses (``run_scale``, ``provision_wave``)
must reproduce the reference's goldens, and a control-plane snapshot taken
by the JAX package's ``FTManager`` must restore in the port's and continue
identically.  Every comparison is exact.
"""
import ast
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.core as jcore
import repro.sim as jsim
import repro_torch.core as tcore
import repro_torch.sim as tsim
from repro.sim.vector_engine import VectorJaxFlowSim
from repro_torch.sim.vector_engine import VectorTorchFlowSim

MB = 1e6
ROOT = Path(__file__).resolve().parents[1]


def _simconfig(pkg, **kw):
    base = dict(per_stream_cap=30 * MB, hop_latency=0.2, registry_qps=1100.0)
    base.update(kw)
    if pkg is tsim:
        base["device"] = "cpu"
    return pkg.SimConfig(**base)


def _run(cls, plan, cfg, slow_vms):
    sim = cls(cfg, record_rates=True)
    for vm, cap in (slow_vms or {}).items():
        sim.set_slow_vm(vm, cap)
    states = sim.add_plan(plan)
    sim.run()
    return sim, states


def _assert_same_run(ref, ref_states, other, other_states):
    assert other.now == ref.now
    assert other.trace == ref.trace
    assert other.events_processed == ref.events_processed
    assert other.completion_times() == ref.completion_times()
    assert other.peak_registry_egress == ref.peak_registry_egress
    assert other.peak_shard_egress == ref.peak_shard_egress
    assert other.peak_nic_utilization == ref.peak_nic_utilization
    assert other.rate_log == ref.rate_log
    assert len(other_states) == len(ref_states)
    for a, b in zip(other_states, ref_states):
        assert dataclasses.astuple(a.flow) == dataclasses.astuple(b.flow)
        assert a.t_start == b.t_start and a.t_done == b.t_done
        assert a.remaining == b.remaining and a.rate == b.rate


def _base_stats(sim):
    skip = ("fronts_jax", "flows_jax", "fronts_torch", "flows_torch")
    return {k: v for k, v in sim.dispatch_stats.items() if k not in skip}


def _faasnet_plan(core):
    ft = core.FunctionTree("f")
    for i in range(15):
        ft.insert(f"vm{i}")
    return core.faasnet_plan(ft, image_bytes=int(100 * MB), startup_fraction=0.2)


def _star_plan(core):
    return core.on_demand_plan(
        [f"vm{i}" for i in range(16)], image_bytes=int(100 * MB), startup_fraction=0.2
    )


def _kraken_plan(core):
    return core.kraken_plan(
        [f"vm{i}" for i in range(12)],
        layer_bytes=[int(10 * MB)] * 4,
        origin="origin",
        seed=7,
    )


def _sharded_spec(core):
    return core.RegistrySpec(shards=3, egress_cap=2.0 * 125e6, qps=500.0)


def _sharded_plan(core):
    return core.on_demand_plan(
        [f"vm{i}" for i in range(18)],
        image_bytes=int(60 * MB),
        startup_fraction=0.25,
        registry=_sharded_spec(core),
    )


# (plan builder, SimConfig overrides, slow VMs): the canonical plans of the
# JAX package's four-way differential.
CASES = {
    "faasnet_tree": (_faasnet_plan, lambda core: {}, None),
    "faasnet_tree_with_straggler": (_faasnet_plan, lambda core: {}, {"vm1": 2 * MB}),
    "registry_star": (_star_plan, lambda core: {}, None),
    "kraken_mesh": (_kraken_plan, lambda core: {"coordinator_cost_s": 0.070}, None),
    "sharded_registry": (
        _sharded_plan,
        lambda core: {"registry": _sharded_spec(core)},
        None,
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_five_way_differential(case):
    build_plan, overrides, slow = CASES[case]
    jplan, tplan = build_plan(jcore), build_plan(tcore)
    assert [dataclasses.astuple(f) for f in tplan.flows] == [
        dataclasses.astuple(f) for f in jplan.flows
    ]
    jcfg = _simconfig(jsim, **overrides(jcore))
    tcfg = _simconfig(tsim, **overrides(tcore))
    inc, inc_states = _run(jsim.FlowSim, jplan, jcfg, slow)
    for cutoff in (jcfg.vector_scalar_cutoff, 0):
        jc = dataclasses.replace(jcfg, vector_scalar_cutoff=cutoff)
        tc = dataclasses.replace(tcfg, vector_scalar_cutoff=cutoff)
        vec, vec_states = _run(jsim.VectorFlowSim, jplan, jc, slow)
        jx, jx_states = _run(VectorJaxFlowSim, jplan, jc, slow)
        tvec, tvec_states = _run(tsim.VectorFlowSim, tplan, tc, slow)
        tt, tt_states = _run(VectorTorchFlowSim, tplan, tc, slow)
        for sim, states in ((vec, vec_states), (jx, jx_states), (tvec, tvec_states), (tt, tt_states)):
            _assert_same_run(inc, inc_states, sim, states)
        assert _base_stats(tt) == _base_stats(vec) == _base_stats(jx) == _base_stats(tvec)
        s = tt.dispatch_stats
        # every wide front went through the port's cap chain
        assert s["fronts_torch"] == s["fronts_vector"]
        assert s["flows_torch"] == s["flows_vector"]
        if cutoff == 0:
            assert s["fronts_scalar"] == 0 and s["fronts_torch"] > 0


def test_run_scale_trace_sha_golden():
    cfg = tsim.ScaleConfig(
        n_vms=32,
        n_functions=4,
        containers_per_function=8,
        churn_ops=5,
        seed=3,
        wave=tsim.WaveConfig(device="cpu"),
    )
    res = tsim.run_scale(cfg)
    digest = hashlib.sha256(
        "\n".join(f"{t!r} {e}" for t, e in res.trace).encode()
    ).hexdigest()
    assert digest == "bb5965a1fa885edd0aaf968dfec9bad59941edf5c13a367d869ed2eea7954c82"
    assert res.engine == "vector_torch"


@pytest.mark.parametrize("system", tsim.SYSTEMS)
def test_provision_wave_golden(system):
    want = jsim.provision_wave(system, 32, jsim.WaveConfig())
    got = tsim.provision_wave(system, 32, tsim.WaveConfig(device="cpu"))
    assert got == want


def _blocks_run(core, sim, imgs):
    cache = core.BlockCache()
    cache.add_image("seed", imgs[0])  # warm: base layers resident
    runnable, done = {}, {}
    for i, img in enumerate(imgs):
        ft = core.FunctionTree(img.name)
        for v in (f"f{i}a", f"f{i}b", f"f{i}c"):
            ft.insert(v)
        sim.add_plan(
            core.faasnet_block_plan(ft, image=img, cache=cache),
            t0=0.01 * i,
            on_node_done=lambda vm, t, i=i: done.__setitem__(
                (i, vm), max(done.get((i, vm), 0.0), t)
            ),
            on_node_runnable=lambda vm, t, i=i: runnable.setdefault((i, vm), t),
        )
    sim.run()
    return runnable, done, sim.now, sim.events_processed, sim.trace


def test_blocks_on_warm_cache_matches_reference():
    """Block-granular flows exercise the QPS-throttle leg of the cap chain."""
    want = _blocks_run(
        jcore,
        jsim.FlowSim(jsim.SimConfig(record_trace=True)),
        jcore.shared_base_images(6, 2, image_bytes=int(48 * MB)),
    )
    for cutoff in (0, 64):
        sim = VectorTorchFlowSim(
            tsim.SimConfig(record_trace=True, vector_scalar_cutoff=cutoff, device="cpu")
        )
        imgs = tcore.shared_base_images(6, 2, image_bytes=int(48 * MB))
        assert _blocks_run(tcore, sim, imgs) == want, cutoff
        if cutoff == 0:
            assert sim.dispatch_stats["fronts_torch"] == sim.dispatch_stats["fronts_vector"] > 0


def test_paper_tier_matches_reference():
    """1000 VMs, 5 functions x 500 containers, 100 churn ops (bench defaults)."""
    shape = dict(n_vms=1000, n_functions=5, containers_per_function=500, churn_ops=100, seed=0)
    want = jsim.run_scale(jsim.ScaleConfig(**shape, wave=jsim.WaveConfig(engine="vector")))
    got = tsim.run_scale(tsim.ScaleConfig(**shape, wave=tsim.WaveConfig(device="cpu")))
    assert got.provision_makespan == want.provision_makespan == 12.810758878720002
    assert got.per_function == want.per_function
    assert got.trace == want.trace
    assert got.events == want.events
    assert got.dispatch_stats["fronts_torch"] == want.dispatch_stats["fronts_vector"] == 54


def test_ft_manager_restores_reference_snapshot():
    """A JAX-package snapshot, through JSON, continues identically in the port."""
    cfg = jsim.ScaleConfig(n_vms=64, n_functions=4, containers_per_function=24, churn_ops=10, seed=5)
    jmgr, members = jsim.scale.build_manager(cfg)
    assert jsim.scale.apply_churn(jmgr, members, cfg) > 0
    snap = json.loads(json.dumps(jmgr.snapshot()))
    kw = dict(max_functions_per_vm=cfg.max_functions_per_vm)
    jnext = jcore.FTManager.restore(json.loads(json.dumps(snap)), **kw)
    tmgr = tcore.FTManager.restore(snap, **kw)
    assert tmgr.tree_stats() == jmgr.tree_stats()
    assert {f: t.to_dict() for f, t in tmgr.trees.items()} == {
        f: t.to_dict() for f, t in jmgr.trees.items()
    }
    fids = sorted(jnext.trees)
    for k in range(25):
        fid = fids[k % len(fids)]
        want, got = jnext.pick_vm_for(fid, now=float(k)), tmgr.pick_vm_for(fid, now=float(k))
        assert (got and got.vm_id) == (want and want.vm_id), k
        if want is not None:
            jnext.insert(fid, want.vm_id, now=float(k))
            tmgr.insert(fid, got.vm_id, now=float(k))
    assert tmgr.snapshot() == jnext.snapshot()


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_reference():
    files = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "examples").glob("torch_*.py"))
             + sorted((ROOT / "scripts").glob("torch_*.py")))
    assert len(files) > 10
    assert {"torch_quickstart.py", "torch_burst_serving.py"} <= {f.name for f in files}
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
        assert not bad, (path, bad)


def test_training_path_runs_with_jax_and_reference_blocked(tmp_path):
    """Every module of the training path imports, and the launcher trains and
    resumes on the CPU, with ``jax`` and ``repro`` absent."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.data.synthetic, repro_torch.optim.adamw, repro_torch.optim.compress\n"
        "import repro_torch.train.step, repro_torch.train.loop\n"
        "from repro_torch.launch import train\n"
        f"args = ['--arch', 'mamba2_130m', '--steps', '2', '--seq-len', '16', '--batch', '2',\n"
        f"        '--device', 'cpu', '--ckpt-dir', {str(tmp_path)!r}, '--ckpt-every', '1']\n"
        "train.main(args)\n"
        "train.main(args[:3] + ['3'] + args[4:])\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert "step      3  loss" in out.stdout and "(resumed from checkpoint step 2)" in out.stdout


def test_port_runs_with_jax_and_reference_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.sim.multi_tenant, repro_torch.sim.workload\n"
        "import repro_torch.sim.reference, repro_torch.distributed.elastic\n"
        "import repro_torch.distributed.fault\n"
        "from repro_torch.sim import WaveConfig, provision_wave\n"
        "from repro_torch.sim import MultiTenantConfig, MultiTenantReplay, TenantConfig\n"
        "lat = provision_wave('faasnet', 16, WaveConfig(device='cpu'))\n"
        "print(repr(sorted(lat.items())))\n"
        "trace = [0.0] * 5 + [40.0] * 30 + [2.0] * 25\n"
        "rep = MultiTenantReplay(MultiTenantConfig(tenants=[TenantConfig('f', trace, seed=1)],\n"
        "    vm_pool_size=64, wave=WaveConfig(device='cpu')))\n"
        "res = rep.run()\n"
        "print(repr([tuple(vars(s).values()) for s in res.timelines['f']]))\n"
        "print(repr(rep.tenants[0].responses))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    lat_line, ticks_line, responses_line = out.stdout.strip().splitlines()
    want = sorted(jsim.provision_wave("faasnet", 16, jsim.WaveConfig()).items())
    assert lat_line == repr(want)
    trace = [0.0] * 5 + [40.0] * 30 + [2.0] * 25
    rep = jsim.MultiTenantReplay(
        jsim.MultiTenantConfig(tenants=[jsim.TenantConfig("f", trace, seed=1)], vm_pool_size=64)
    )
    res = rep.run()
    assert len(res.timelines["f"]) == 60 and res.cold_starts > 0
    assert ticks_line == repr([dataclasses.astuple(s) for s in res.timelines["f"]])
    assert responses_line == repr(rep.tenants[0].responses)


def test_no_silent_cpu_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VectorTorchFlowSim(tsim.SimConfig(device="cuda"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsim.make_sim(tsim.SimConfig())  # the port's default: vector_torch on cuda
