#!/usr/bin/env bash
# The port's counterpart of scripts/ci.sh: the same eight smokes, each on the
# port's engines with device="cpu" (the default vector_torch engine runs its
# cap chain's plain PyTorch version), then the port's tests.
#
#   scripts/ci_torch.sh                      smokes, then tests/test_torch_*.py
#   scripts/ci_torch.sh -k dryrun            any pytest args pass through
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"

# Perf smoke: the control plane must stay O(log n).  Building a 5k-node
# FunctionTree plus 500 churn ops takes ~50 ms on the frontier/index paths
# and seconds on the old O(n²) BFS-scan paths, so a generous 1.25 s budget
# can never be met by a quadratic regression silently sneaking back in.
python - <<'PY'
import random, time
from repro_torch.core import FunctionTree

t0 = time.perf_counter()
ft = FunctionTree("perf-smoke")
for i in range(5_000):
    ft.insert(f"v{i}")
rng = random.Random(0)
ids = [f"v{i}" for i in range(5_000)]
for _ in range(500):
    v = ids[rng.randrange(len(ids))]
    ft.delete(v)
    ft.insert(v)
elapsed = time.perf_counter() - t0
ft.check_invariants()
budget = 1.25
assert elapsed < budget, (
    f"perf smoke FAILED: 5k-node FT build + 500 churn ops took {elapsed:.2f} s "
    f"(budget {budget} s) — the O(n^2) control-plane path is back"
)
print(f"perf smoke ok: 5k-node FT build + 500 churn ops in {elapsed*1e3:.0f} ms")
PY

# Trace-replay smoke: a short multi-tenant prefix with a mid-run scheduler
# failover must (a) finish in seconds, (b) keep the pool partitioned at
# every tick, and (c) be bit-identical to an uninterrupted run — the tier-1
# guard on the whole replay stack (traces -> FTManager -> FlowSim).
python - <<'PY'
import time
from repro_torch.sim import MultiTenantReplay, multi_tenant_config

t0 = time.perf_counter()
cfg = multi_tenant_config(
    n_tenants=3, vm_pool_size=200, minutes=3, failover_at=80, check_partition=True
)
cfg.wave.device = "cpu"
res = MultiTenantReplay(cfg).run()
plain = multi_tenant_config(
    n_tenants=3, vm_pool_size=200, minutes=3, failover_at=None
)
plain.wave.device = "cpu"
unbroken = MultiTenantReplay(plain).run()
elapsed = time.perf_counter() - t0
assert res.failovers == 1
assert res.timelines == unbroken.timelines, "failover perturbed the replay"
assert sum(t.provisioned for t in res.per_tenant.values()) > 0
budget = 10.0
assert elapsed < budget, (
    f"trace smoke FAILED: 3-tenant / 3-min replay took {elapsed:.2f} s "
    f"(budget {budget} s)"
)
print(
    f"trace smoke ok: 3-tenant replay + failover parity in {elapsed*1e3:.0f} ms"
)
PY

# Registry shard-sweep smoke: per-shard egress accounting must not silently
# regress to a single aggregate cap.  With 4 replicated shards the baseline
# (registry-bound) wave must speed up >= 2x while faasnet (NIC-bound at the
# root) moves < 5% — the paper's §4.3 bottleneck-removal claim in miniature.
python - <<'PY'
import time
from repro_torch.sim import RegistrySpec, WaveConfig, provision_wave
from repro_torch.sim.engine import GBPS

t0 = time.perf_counter()
def makespan(system, shards):
    cfg = WaveConfig(
        per_stream_cap=float("inf"),
        registry=RegistrySpec(
            shards=shards, egress_cap=9.5 * GBPS, qps=1100.0, policy="replicated"
        ),
        device="cpu",
    )
    return max(provision_wave(system, 64, cfg).values())

b1, b4 = makespan("baseline", 1), makespan("baseline", 4)
f1, f4 = makespan("faasnet", 1), makespan("faasnet", 4)
elapsed = time.perf_counter() - t0
speedup = b1 / b4
drift = abs(f4 - f1) / f1 * 100.0
assert speedup >= 2.0, (
    f"registry smoke FAILED: baseline only sped up {speedup:.2f}x with 4 "
    f"shards ({b1:.1f}s -> {b4:.1f}s) — per-shard egress accounting has "
    f"regressed to an aggregate cap"
)
assert drift < 5.0, (
    f"registry smoke FAILED: faasnet moved {drift:.1f}% with 4 shards "
    f"({f1:.2f}s -> {f4:.2f}s) — it should be insensitive to registry "
    f"bandwidth"
)
budget = 10.0
assert elapsed < budget, (
    f"registry smoke FAILED: sweep took {elapsed:.2f} s (budget {budget} s)"
)
print(
    f"registry smoke ok: baseline {speedup:.2f}x faster with 4 shards, "
    f"faasnet drift {drift:.2f}%, in {elapsed*1e3:.0f} ms"
)
PY

# Shared-pool smoke: memory-aware cross-tenant placement must actually pay.
# On a short 3-tenant prefix the shared pool (a) spends fewer VM-hours than
# exclusive leasing, (b) genuinely co-locates tenants (more inserts than
# reservations), and (c) faasnet still beats the docker-pull baseline on the
# worst tenant's p99 provisioning latency — all under the per-tick
# memory/occupancy invariant checks.
python - <<'PY'
import time
from repro_torch.sim import MultiTenantReplay, multi_tenant_config

t0 = time.perf_counter()
def run(**kw):
    cfg = multi_tenant_config(
        n_tenants=3, vm_pool_size=200, minutes=3, failover_at=None,
        check_partition=True, **kw,
    )
    cfg.wave.device = "cpu"
    return MultiTenantReplay(cfg).run()

shared = run(placement="shared")
excl = run(placement="exclusive")
base = run(placement="shared", system="baseline")
elapsed = time.perf_counter() - t0
assert shared.vm_seconds < excl.vm_seconds, (
    f"placement smoke FAILED: shared pool used {shared.vm_seconds:.0f} VM-s, "
    f"exclusive {excl.vm_seconds:.0f} VM-s — co-location is not saving "
    f"capacity"
)
stats = shared.manager_stats
assert stats["inserts"] > stats["reservations"], (
    f"placement smoke FAILED: {stats['inserts']} inserts vs "
    f"{stats['reservations']} reservations — no cross-tenant co-location "
    f"happened"
)
worst_f = max(t.p99_prov_s for t in shared.per_tenant.values())
worst_b = max(t.p99_prov_s for t in base.per_tenant.values())
assert worst_f < worst_b, (
    f"placement smoke FAILED: faasnet worst p99 provisioning {worst_f:.2f}s "
    f"not better than baseline {worst_b:.2f}s on the shared pool"
)
budget = 10.0
assert elapsed < budget, (
    f"placement smoke FAILED: took {elapsed:.2f} s (budget {budget} s)"
)
print(
    f"placement smoke ok: shared {shared.vm_seconds:.0f} VM-s vs exclusive "
    f"{excl.vm_seconds:.0f} VM-s, faasnet p99prov {worst_f:.2f}s vs baseline "
    f"{worst_b:.2f}s, in {elapsed*1e3:.0f} ms"
)
PY

# Serving smoke: the request-level layer must (a) herd-control cold bursts —
# one right-sized wave instead of a reservation per queued request, so it
# wastes no provisions where naive admission wastes hundreds — and (b) keep
# faasnet's end-to-end p99 response ahead of the docker-pull baseline (every
# cold request under baseline waits out a full image pull).
python - <<'PY'
import time
from repro_torch.sim import MultiTenantReplay, WaveConfig, serving_config
from repro_torch.sim.multi_tenant import MultiTenantConfig, ServingConfig, TenantConfig

t0 = time.perf_counter()
def burst(herd):
    trace = [0.0] * 3 + [500.0] + [0.0] * 26
    return MultiTenantConfig(
        tenants=[TenantConfig("cold", trace, seed=3, function_duration_s=0.5,
                              max_reserve_per_tick=100_000)],
        vm_pool_size=600,
        serving=ServingConfig(herd_control=herd),
        check_partition=True,
        wave=WaveConfig(device="cpu"),
    )
h = MultiTenantReplay(burst(True)).run().per_tenant["cold"]
n = MultiTenantReplay(burst(False)).run().per_tenant["cold"]
assert h.completed == n.completed == 500, (h.completed, n.completed)
assert h.wasted_provisions < n.wasted_provisions, (
    f"serving smoke FAILED: herd wasted {h.wasted_provisions} provisions, "
    f"naive {n.wasted_provisions} — herd control is not paying"
)
assert h.provisioned < n.provisioned, (
    f"serving smoke FAILED: herd provisioned {h.provisioned} >= naive "
    f"{n.provisioned} — the admission gate is not parking the herd"
)

p99 = {}
for system in ("faasnet", "baseline"):
    cfg = serving_config(n_tenants=3, vm_pool_size=300, minutes=2,
                         failover_at=None, check_partition=True, system=system)
    cfg.wave.device = "cpu"
    res = MultiTenantReplay(cfg).run()
    p99[system] = max(tr.p99_response_s for tr in res.per_tenant.values())
elapsed = time.perf_counter() - t0
assert p99["faasnet"] < p99["baseline"], (
    f"serving smoke FAILED: faasnet p99 response {p99['faasnet']:.2f}s not "
    f"better than baseline {p99['baseline']:.2f}s"
)
budget = 10.0
assert elapsed < budget, (
    f"serving smoke FAILED: took {elapsed:.2f} s (budget {budget} s)"
)
print(
    f"serving smoke ok: herd {h.provisioned} provisioned/"
    f"{h.wasted_provisions} wasted vs naive {n.provisioned}/"
    f"{n.wasted_provisions}, faasnet p99 {p99['faasnet']:.2f}s vs baseline "
    f"{p99['baseline']:.2f}s, in {elapsed*1e3:.0f} ms"
)
PY

# Vector-engine smoke: the default vector_torch backend must stay
# bit-identical to the incremental engine — a 128-VM wave across all five systems and a
# paper-shape burst (1000 VMs, 5 fns x 500 containers) compare equal on
# latencies, event logs, and peak-egress telemetry — and must hold an
# events/s floor (measured ~84k on an idle dev box; 20k tolerates a loaded
# CI host but still catches an order-of-magnitude engine regression).
python - <<'PY'
import time
from repro_torch.sim import SYSTEMS, ScaleConfig, WaveConfig, provision_wave, run_scale

t0 = time.perf_counter()
for system in SYSTEMS:
    a = provision_wave(system, 128, WaveConfig(engine="incremental", device="cpu"))
    b = provision_wave(system, 128, WaveConfig(device="cpu"))
    assert a == b, (
        f"vector smoke FAILED: engine divergence on the 128-VM {system} wave"
    )

res = {}
for eng in ("incremental", "vector_torch"):
    cfg = ScaleConfig(churn_ops=20, seed=3, wave=WaveConfig(engine=eng, device="cpu"))
    res[eng] = run_scale(cfg)
inc, vec = res["incremental"], res["vector_torch"]
assert vec.trace == inc.trace, (
    "vector smoke FAILED: burst event logs diverge between engines"
)
assert vec.peak_registry_egress == inc.peak_registry_egress
assert vec.peak_shard_egress == inc.peak_shard_egress
elapsed = time.perf_counter() - t0
floor = 20_000.0
assert vec.events_per_s >= floor, (
    f"vector smoke FAILED: {vec.events_per_s:,.0f} events/s on the "
    f"paper-shape burst (floor {floor:,.0f}) — the vector engine has "
    f"regressed an order of magnitude"
)
budget = 10.0
assert elapsed < budget, (
    f"vector smoke FAILED: took {elapsed:.2f} s (budget {budget} s)"
)
print(
    f"vector smoke ok: 128-VM waves + paper burst bit-identical, "
    f"{vec.events_per_s:,.0f} events/s (incremental "
    f"{inc.events_per_s:,.0f}), in {elapsed*1e3:.0f} ms"
)
PY

# Block-provisioning smoke: the §3.1–§3.2 block/layer path must (a) leave
# the legacy scalar goldens bit-identical when disabled (cfg.image=None is
# the default — same WaveConfig, same engines, same numbers), (b) make layer
# sharing pay: consecutive waves from shared base images dedup in the per-VM
# block caches and beat disjoint images to runnable, and (c) keep the
# incremental and vector engines bit-identical with blocks ON.
python - <<'PY'
import time
from repro_torch.core import BlockCache, shared_base_images, disjoint_images
from repro_torch.sim import WaveConfig, block_wave, provision_wave

t0 = time.perf_counter()
legacy = {s: provision_wave(s, 32, WaveConfig(device="cpu")) for s in ("faasnet", "baseline")}
again = {s: provision_wave(s, 32, WaveConfig(image=None, device="cpu"))
         for s in ("faasnet", "baseline")}
assert legacy == again, (
    "blocks smoke FAILED: cfg.image=None perturbed the legacy scalar waves"
)

def deploy(images):
    cache = BlockCache()
    cfg = WaveConfig(container_start=0.5, device="cpu")
    return sum(
        max(v["runnable"] for v in block_wave("faasnet", 4, cfg, images=img,
                                              cache=cache).values())
        for img in images
    )

shared = deploy(shared_base_images(6, 2, image_bytes=128 << 20))
disjoint = deploy(disjoint_images(6, image_bytes=128 << 20))
assert shared < disjoint, (
    f"blocks smoke FAILED: shared bases {shared:.1f}s not faster than "
    f"disjoint {disjoint:.1f}s — block-cache dedup is not paying"
)

img = shared_base_images(1, 1, image_bytes=128 << 20)[0]
inc = block_wave("faasnet", 16, WaveConfig(engine="incremental", device="cpu"), images=img)
vec = block_wave("faasnet", 16, WaveConfig(device="cpu"), images=img)
assert inc == vec, (
    "blocks smoke FAILED: engine divergence on the block wave"
)
assert all(v["runnable"] < v["done"] for v in inc.values()), (
    "blocks smoke FAILED: runnable milestone did not precede full arrival"
)
elapsed = time.perf_counter() - t0
budget = 10.0
assert elapsed < budget, (
    f"blocks smoke FAILED: took {elapsed:.2f} s (budget {budget} s)"
)
print(
    f"blocks smoke ok: blocks-off bit-identical, shared bases "
    f"{disjoint / shared:.2f}x faster to runnable, engines match, in "
    f"{elapsed*1e3:.0f} ms"
)
PY

# Wide-front smoke: the vector engine's batched recompute must actually
# batch.  On the paper-shape burst the wide-front dispatch count must
# undercut the retired per-depth sweep by >= 1.1x (measured 1.13x on this
# workload — the stagger-serialized closures are mostly single-tree, so
# same-depth merging was already free and the wide-front gain is bounded
# by cross-depth rounds).  The vector_torch backend, its cap chain's plain
# version on the CPU here, must stay bit-identical to the numpy vector
# engine on a wave and a block wave.
python - <<'PY'
import time
from repro_torch.sim import ScaleConfig, WaveConfig, provision_wave, run_scale

t0 = time.perf_counter()
cfg = ScaleConfig(churn_ops=20, seed=3, wave=WaveConfig(device="cpu"))
res = run_scale(cfg)
ds = res.dispatch_stats
fronts = ds["fronts_scalar"] + ds["fronts_vector"]
reduction = ds["legacy_levels"] / fronts
assert reduction >= 1.1, (
    f"widefront smoke FAILED: {fronts} wide-front dispatches vs "
    f"{ds['legacy_levels']} per-depth sweeps ({reduction:.2f}x, floor 1.1x) "
    f"— the cross-tree front batching has regressed"
)
assert ds["flows_vector"] > ds["flows_scalar"], (
    f"widefront smoke FAILED: {ds['flows_vector']} flows took the vector "
    f"path vs {ds['flows_scalar']} scalar — the batched path is not "
    f"carrying the bulk of the work"
)

a = provision_wave("faasnet", 96, WaveConfig(engine="vector", device="cpu"))
b = provision_wave("faasnet", 96, WaveConfig(engine="vector_torch", device="cpu"))
assert a == b, (
    "widefront smoke FAILED: vector_torch diverged from vector on the "
    "96-VM wave"
)
from repro_torch.core import shared_base_images
from repro_torch.sim import block_wave

img = shared_base_images(1, 1, image_bytes=96 << 20)[0]
bv = block_wave("faasnet", 12, WaveConfig(engine="vector", device="cpu"), images=img)
bt = block_wave("faasnet", 12, WaveConfig(engine="vector_torch", device="cpu"), images=img)
assert bv == bt, (
    "widefront smoke FAILED: vector_torch diverged from vector on the "
    "block wave"
)
elapsed = time.perf_counter() - t0
budget = 20.0
assert elapsed < budget, (
    f"widefront smoke FAILED: took {elapsed:.2f} s (budget {budget} s)"
)
print(
    f"widefront smoke ok: {reduction:.2f}x dispatch reduction "
    f"({fronts} fronts vs {ds['legacy_levels']} per-depth sweeps), "
    f"vector_torch bit-identical on wave + block wave, in {elapsed*1e3:.0f} ms"
)
PY

export JAX_PLATFORMS="${JAX_PLATFORMS:-cpu}"  # the tests run the JAX package beside the port
exec python -m pytest -q tests/test_torch_*.py "$@"
