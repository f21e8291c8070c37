"""The port's full-recompute oracle held against the JAX package's, on the CPU.

``repro_torch.sim.reference.ReferenceFlowSim`` is a copy of the JAX
package's: on the scenarios of ``tests/test_scale.py`` and
``tests/test_vector_engine.py`` (a FaaSNet tree, with and without a
straggler, a registry star, a Kraken mesh, a sharded registry, a mid-flight
parent attach and seeded random plans), each built by each package's own
topology code, its event log, rate log, flow states and peak egress must
equal the JAX oracle's exactly.  Against the port's incremental ``FlowSim``
it must agree to ±1e-9 on completion times and peak egress — the oracle
re-rates after every event, so a batch of same-instant completions can take
a microscopically different arithmetic path.
"""
import dataclasses
import random

import pytest

import repro.core.topology as jtop
import repro.sim as jsim
import repro_torch.core.topology as ttop
import repro_torch.sim as tsim
from repro.core import FunctionTree as JFunctionTree
from repro.core.registry import RegistrySpec as JRegistrySpec
from repro_torch.core import FunctionTree as TFunctionTree
from repro_torch.core.registry import RegistrySpec as TRegistrySpec

MB = 1e6
REL_TOL = 1e-9

PKGS = {
    "jax": (jsim, jtop, JFunctionTree, JRegistrySpec),
    "port": (tsim, ttop, TFunctionTree, TRegistrySpec),
}


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= REL_TOL * max(1.0, abs(a), abs(b))


def _faasnet(top, FunctionTree, RegistrySpec):
    ft = FunctionTree("f")
    for i in range(15):
        ft.insert(f"vm{i}")
    return top.faasnet_plan(ft, image_bytes=int(100 * MB), startup_fraction=0.2), {}, {}


def _straggler(top, FunctionTree, RegistrySpec):
    plan, kw, _ = _faasnet(top, FunctionTree, RegistrySpec)
    return plan, kw, {"vm1": 2 * MB}


def _star(top, FunctionTree, RegistrySpec):
    plan = top.on_demand_plan([f"vm{i}" for i in range(16)], image_bytes=int(100 * MB), startup_fraction=0.2)
    return plan, {}, {}


def _kraken(top, FunctionTree, RegistrySpec):
    plan = top.kraken_plan(
        [f"vm{i}" for i in range(12)], layer_bytes=[int(10 * MB)] * 4, origin="origin", seed=7
    )
    return plan, {"coordinator_cost_s": 0.070}, {}


def _sharded(top, FunctionTree, RegistrySpec):
    spec = RegistrySpec(shards=3, egress_cap=2.0 * 125e6, qps=500.0)
    plan = top.on_demand_plan(
        [f"vm{i}" for i in range(18)], image_bytes=int(60 * MB), startup_fraction=0.25, registry=spec
    )
    return plan, {"registry": spec}, {}


def _random(seed):
    def build(top, FunctionTree, RegistrySpec):
        rng = random.Random(seed)
        nodes = [f"vm{i}" for i in range(10)]
        flows = []
        for i, n in enumerate(nodes):
            src = top.REGISTRY if i == 0 or rng.random() < 0.3 else nodes[rng.randrange(i)]
            flows.append(top.Flow(src, n, "img", rng.randrange(1_000_000, 50_000_000)))
        plan = top.DistributionPlan(
            flows=flows,
            control_latency={n: rng.random() * 0.05 for n in nodes},
            streaming=bool(seed % 2),
        )
        return plan, {}, {}

    return build


SCENARIOS = {
    "faasnet_tree": _faasnet,
    "faasnet_tree_straggler": _straggler,
    "registry_star": _star,
    "kraken_mesh": _kraken,
    "sharded_registry": _sharded,
    **{f"random_{s}": _random(s) for s in range(4)},
}


def _run(pkg_name: str, engine: str, scenario: str):
    sim_pkg, top, FunctionTree, RegistrySpec = PKGS[pkg_name]
    plan, cfg_kw, slow = SCENARIOS[scenario](top, FunctionTree, RegistrySpec)
    cfg = sim_pkg.SimConfig(per_stream_cap=30 * MB, hop_latency=0.2, registry_qps=1100.0, **cfg_kw)
    cls = sim_pkg.ReferenceFlowSim if engine == "reference" else sim_pkg.FlowSim
    sim = cls(cfg, record_rates=True)
    for vm, cap in slow.items():
        sim.set_slow_vm(vm, cap)
    states = sim.add_plan(plan)
    sim.run()
    return sim, states


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_reference_equals_jax_reference(scenario):
    got, got_states = _run("port", "reference", scenario)
    want, want_states = _run("jax", "reference", scenario)
    assert got.now == want.now
    assert got.trace == want.trace
    assert got.rate_log == want.rate_log
    assert got.completion_times() == want.completion_times()
    assert got.peak_registry_egress == want.peak_registry_egress
    assert got.peak_shard_egress == want.peak_shard_egress
    assert len(got_states) == len(want_states) > 0
    for a, b in zip(got_states, want_states):
        assert dataclasses.astuple(a.flow) == dataclasses.astuple(b.flow)
        assert (a.t_start, a.t_done, a.remaining, a.rate, a.done) == (
            b.t_start, b.t_done, b.remaining, b.rate, b.done
        )


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_reference_agrees_with_port_incremental(scenario):
    ref, ref_states = _run("port", "reference", scenario)
    inc, inc_states = _run("port", "incremental", scenario)
    assert _close(inc.now, ref.now), (inc.now, ref.now)
    assert len(inc_states) == len(ref_states)
    for a, b in zip(inc_states, ref_states):
        assert a.flow == b.flow
        assert a.done and b.done
        assert _close(a.t_start, b.t_start), (a.flow, a.t_start, b.t_start)
        assert _close(a.t_done, b.t_done), (a.flow, a.t_done, b.t_done)
    assert _close(inc.peak_registry_egress, ref.peak_registry_egress)
    assert set(inc.peak_shard_egress) == set(ref.peak_shard_egress)
    for k, v in inc.peak_shard_egress.items():
        assert _close(v, ref.peak_shard_egress[k]), (k, v)


def test_set_parent_mid_flight_matches_jax_and_incremental():
    """Attaching a parent to a started flow caps it at once (the replay's attach path)."""
    done = {}
    for name, cls in (
        ("jax_ref", jsim.ReferenceFlowSim),
        ("port_ref", tsim.ReferenceFlowSim),
        ("port_inc", tsim.FlowSim),
    ):
        top = jtop if name.startswith("jax") else ttop
        sim = cls((jsim if name.startswith("jax") else tsim).SimConfig(registry_out_cap=5e6))
        [p] = sim.add_plan(top.DistributionPlan(flows=[top.Flow(top.REGISTRY, "A", "img", 200_000_000)], streaming=False))
        [c] = sim.add_plan(top.DistributionPlan(flows=[top.Flow("A", "B", "img", 125_000_000)], streaming=False))
        sim.run(until=0.1)
        sim.set_parent(c, p)
        sim.run()
        done[name] = c.t_done
    assert done["port_ref"] == done["jax_ref"]
    assert _close(done["port_inc"], done["port_ref"])
    assert done["port_ref"] > 20.0  # capped at the parent's 5 MB/s


def test_make_sim_builds_the_reference_engine():
    assert set(tsim.ENGINES) == {"incremental", "vector", "vector_torch", "reference"}
    sim = tsim.make_sim(tsim.SimConfig(engine="reference"))
    assert isinstance(sim, tsim.ReferenceFlowSim)
    assert type(sim).__module__ == "repro_torch.sim.reference"
    with pytest.raises(ValueError, match="unknown engine"):
        tsim.make_sim(tsim.SimConfig(engine="vector_jax"))
