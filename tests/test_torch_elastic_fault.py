"""The port's elastic and fault coordinators held against the JAX package's.

The eight cases of ``tests/test_elastic_fault.py`` run through
``repro_torch.distributed``, and each one's outputs — join latencies and
upstreams, repaired trees, mesh proposals, dead hosts, flagged stragglers,
restarts and demotions — must equal what the same calls return in the JAX
package.  Every comparison is exact.
"""
import pytest

import repro.core as jcore
import repro.distributed.elastic as jel
import repro.distributed.fault as jfa
import repro_torch.core as tcore
import repro_torch.distributed.elastic as tel
import repro_torch.distributed.fault as tfa

PKGS = {"jax": (jcore, jel, jfa), "port": (tcore, tel, tfa)}


def _joins(el, payload_bytes, n):
    ec = el.ElasticCoordinator(el.ElasticConfig(payload_bytes=payload_bytes))
    return ec, [ec.join(now=float(i)) for i in range(n)]


def _tree(ec):
    return ec.mgr.trees[ec.cfg.model_id].to_dict()


def case_join_uses_peers(core, el, fa):
    ec, joins = _joins(el, 10**9, 8)
    assert joins[0].upstream is None
    assert all(j.upstream is not None for j in joins[1:])
    assert len(ec.hosts) == 8 and joins[-1].tree_height == 4
    return [tuple(vars(j).values()) for j in joins], ec.hosts, _tree(ec)


def case_leave_and_fail_repair(core, el, fa):
    ec = el.ElasticCoordinator()
    hosts = [ec.join().host for _ in range(10)]
    ec.leave(hosts[3])
    repaired = ec.fail(hosts[1])
    ec.mgr.trees[ec.cfg.model_id].check_invariants()
    assert len(ec.hosts) == 8
    return repaired, ec.hosts, _tree(ec), [j.provision_latency_s for j in ec.history]


def case_mesh_proposal(core, el, fa):
    ec = el.ElasticCoordinator()
    for _ in range(10):
        ec.join()
    first = ec.propose_mesh(16)
    for _ in range(6):
        ec.join()
    assert (first, ec.propose_mesh(16)) == ((8, 16), (16, 16))
    return first, ec.propose_mesh(16), ec.propose_mesh(4), _tree(ec)


def case_join_latency_scales(core, el, fa):
    small = el.ElasticCoordinator(el.ElasticConfig(payload_bytes=10**8))
    big = el.ElasticCoordinator(el.ElasticConfig(payload_bytes=4 * 10**9))
    small.join(); big.join()
    a, b = small.join().provision_latency_s, big.join().provision_latency_s
    assert b > a * 5
    return a, b


def case_heartbeat(core, el, fa):
    mon = fa.HeartbeatMonitor(timeout_s=5.0)
    mon.beat("h1", 0.0)
    mon.beat("h2", 8.0)
    assert mon.dead_hosts(now=10.0) == ["h1"]
    return mon.dead_hosts(now=10.0), mon.dead_hosts(now=14.0)


def case_straggler(core, el, fa):
    det = fa.StragglerDetector(threshold=1.5)
    for _ in range(10):
        det.record("fast1", 1.0)
        det.record("fast2", 1.1)
        det.record("slow", 3.0)
    assert det.stragglers() == ["slow"]
    return det.stragglers()


def case_coordinator_end_to_end(core, el, fa):
    mgr = core.FTManager()
    for i in range(6):
        mgr.add_free_vm(core.VMInfo(f"h{i}"))
    for i in range(6):
        mgr.insert("model", mgr.reserve_vm().vm_id)
    restarted = []
    fc = fa.FaultCoordinator(mgr, on_restart=lambda dead: restarted.extend(dead))
    for i in range(6):
        fc.monitor.beat(f"h{i}", 0.0)
    for i in range(6):
        if i != 2:
            fc.monitor.beat(f"h{i}", 20.0)
    actions = fc.tick(now=25.0)
    assert actions["dead"] == ["h2"] and restarted == ["h2"]
    mgr.trees["model"].check_invariants()
    assert "h2" not in mgr.trees["model"]
    return actions, restarted, mgr.trees["model"].to_dict()


def case_coordinator_demotes_straggler(core, el, fa):
    mgr = core.FTManager()
    for i in range(7):
        mgr.add_free_vm(core.VMInfo(f"h{i}"))
        mgr.reserve_vm()
        mgr.insert("model", f"h{i}", now=0.0)
    fc = fa.FaultCoordinator(mgr)
    ft = mgr.trees["model"]
    interior = next(n.vm_id for n in ft.bfs() if n.children())
    for h in [f"h{i}" for i in range(7)]:
        fc.detector.record(h, 5.0 if h == interior else 1.0)
    actions = fc.tick(now=1.0)
    assert ("model", interior) in actions["demoted"]
    assert ft.children_of(interior) == []
    ft.check_invariants()
    return actions, ft.to_dict()


CASES = [
    case_join_uses_peers,
    case_leave_and_fail_repair,
    case_mesh_proposal,
    case_join_latency_scales,
    case_heartbeat,
    case_straggler,
    case_coordinator_end_to_end,
    case_coordinator_demotes_straggler,
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__.removeprefix("case_"))
def test_case_equals_reference(case):
    assert case(*PKGS["port"]) == case(*PKGS["jax"])
