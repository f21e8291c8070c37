"""``benchmarks_torch/bench_scale_1000.py`` against the reference's script.

Both run at ``--quick`` (100 VMs, 250 containers; the port on
``--device cpu``) and the port's artifact must equal the reference's outside
its timing keys, with ``compare.deterministic_diff``.  The tier's main run
is the incremental engine in both packages; its twin is ``vector`` in the
reference and ``vector_torch`` in the port, whose K1 route (the plain
version on the CPU) must have rated the tier's wide fronts.
"""
from test_torch_bench_small import ROOT, check_device_block, compare, load, run_pair


def test_scale_quick_matches_reference(tmp_path, monkeypatch):
    port, ref = run_pair("bench_scale_1000", tmp_path, monkeypatch, "--quick")
    assert compare.artifact_diff("scale", port, ref) == []
    assert (port["engine"], ref["engine"]) == ("incremental", "incremental")
    assert (port["vector"]["engine"], ref["vector"]["engine"]) == ("vector_torch", "vector")
    assert port["vector"]["matches_incremental"] is True
    ds = port["vector"]["dispatch_stats"]
    assert ds["fronts_torch"] == ds["fronts_vector"] > 0
    check_device_block(port, ("main", "vector"))


def test_scale_compare_reference_matches_reference(tmp_path, monkeypatch):
    port, ref = run_pair("bench_scale_1000", tmp_path, monkeypatch, "--quick",
                         "--compare-reference", "--vms", "60")
    assert compare.artifact_diff("scale", port, ref) == []
    assert port["reference_compare"]["makespan_delta_s"] == ref["reference_compare"][
        "makespan_delta_s"]


def test_scale_tiers_keep_their_engines_and_device(monkeypatch, tmp_path):
    """``--mega`` keeps the reference's incremental engine for the tier's main
    run; ``--giga`` runs the port's giga configs on ``--device``.  The
    engines are recorded and the runs stopped before they start."""
    from repro_torch.sim import scale

    class Stop(Exception):
        pass

    seen = []

    def record(cfg, *a, **kw):
        seen.append((cfg.n_vms, cfg.wave.engine, cfg.wave.device))
        if cfg.n_vms > 1000:
            raise Stop
        return run_scale(cfg, *a, **kw)

    run_scale = scale.run_scale
    monkeypatch.setattr(scale, "run_scale", record)
    import repro_torch.sim as sim

    monkeypatch.setattr(sim, "run_scale", record)
    mod = load(ROOT / "benchmarks_torch" / "bench_scale_1000.py")
    for flag in ("--mega", "--giga"):
        try:
            mod.main(["--quick", flag, "--device", "cpu", "--out", str(tmp_path / "x.json")])
        except Stop:
            pass
    assert seen == [(100, "incremental", "cpu"), (100, "vector_torch", "cpu"),
                    (10_000, "incremental", "cpu"),
                    (100, "incremental", "cpu"), (100, "vector_torch", "cpu"),
                    (100_000, "vector_torch", "cpu")]
