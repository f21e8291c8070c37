"""The port's evaluation harness (``benchmarks_torch/``) against the reference's.

Each test loads both scripts by file path, runs the reference's ``main()``
(``sys.argv`` patched) and the port's ``main(argv)`` with ``--device cpu``
into ``tmp_path``, and holds the port's artifact field for field against the
reference's with ``compare.deterministic_diff``, which must find nothing.
This file holds the two small benches (registry sweep at its defaults,
blocks at ``--quick``), ``deterministic_diff`` itself, and the ``--device``
contract of every script; the other benches and the figures are in
``test_torch_bench_scale.py``, ``test_torch_bench_replays.py`` and
``test_torch_paper_figures.py``, which import the helpers below.
"""
import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def load(path: Path):
    """Import a script by file path, under a name of its own."""
    spec = importlib.util.spec_from_file_location(f"_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


compare = load(ROOT / "benchmarks_torch" / "compare.py")


def run_pair(script: str, tmp_path: Path, monkeypatch, *args: str) -> tuple[dict, dict]:
    """(port's artifact, reference's artifact) of ``script`` run at ``args``."""
    ref_out, port_out = tmp_path / "ref.json", tmp_path / "port.json"
    monkeypatch.setattr(sys, "argv", [script, *args, "--out", str(ref_out)])
    load(ROOT / "benchmarks" / f"{script}.py").main()
    load(ROOT / "benchmarks_torch" / f"{script}.py").main(
        [*args, "--device", "cpu", "--out", str(port_out)])
    return json.loads(port_out.read_text()), json.loads(ref_out.read_text())


def check_device_block(port: dict, runs) -> None:
    """The CPU's ``device`` block: no card, and K1 counted per run (0 on the
    CPU, whose plain version counts nothing)."""
    dev = port["device"]
    assert (dev["name"], dev["power_limit"], dev["torch"]) == ("cpu", "cpu", torch.__version__)
    assert dev["k1_launches"] == {run: 0 for run in runs}


def test_registry_sweep_matches_reference(tmp_path, monkeypatch):
    port, ref = run_pair("bench_registry_sweep", tmp_path, monkeypatch)
    assert compare.artifact_diff("registry", port, ref) == []
    assert port["checks"]["faasnet_flat_within_5pct"]
    check_device_block(port, ("faasnet", "baseline", "on_demand"))


def test_blocks_quick_matches_reference(tmp_path, monkeypatch):
    port, ref = run_pair("bench_blocks", tmp_path, monkeypatch, "--quick")
    assert compare.artifact_diff("blocks", port, ref) == []
    assert port["runnable_at_prefix"]["engines_match"] is True
    check_device_block(port, ("layer_sharing", "runnable_at_prefix.engine_check_cutoff_0"))


def test_blocks_engine_check_sends_every_front_through_k1(monkeypatch):
    """The runnable-at-prefix engine check runs vector_torch at cutoff 0, so
    each of its fronts takes K1's route (the plain version on the CPU)."""
    from repro_torch.sim import cluster

    blocks = load(ROOT / "benchmarks_torch" / "bench_blocks.py")
    sims = []

    def make(cfg, _make=cluster.make_sim, **kw):
        sims.append(_make(cfg, **kw))
        return sims[-1]

    monkeypatch.setattr(cluster, "make_sim", make)
    blocks.runnable_at_prefix(16, "cpu")
    inc, vec = sims
    assert type(inc).__name__ == "FlowSim"
    ds = vec.dispatch_stats
    assert ds["fronts_scalar"] == 0 and ds["fronts_torch"] == ds["fronts_vector"] > 0


# ----------------------------------------------------------------------
# deterministic_diff
# ----------------------------------------------------------------------
BASE = {"engine": "vector", "wall_s": 1.5, "n": 3, "xs": [1.0, 2.0],
        "sub": {"events": 10, "wall_s": 0.25, "ok": True},
        "micro": {"ft_build_s": 0.1}, "giga": {"n": 1}}
TIMING = ("wall_s", "micro")


def _diff(port, ref=BASE, timing=TIMING, design=("engine",), skip=()):
    return compare.deterministic_diff(port, ref, timing, design, skip)


def _with(path: str, value):
    out = json.loads(json.dumps(BASE))
    *head, last = path.split(".")
    node = out
    for key in head:
        node = node[key]
    if value is KeyError:
        del node[last]
    else:
        node[last] = value
    return out


@pytest.mark.parametrize("path,value,want", [
    ("n", 4, "n: 4 != 3"),
    ("sub.events", 11, "sub.events: 11 != 10"),
    ("xs", [1.0, 2.5], "xs[1]: 2.5 != 2.0"),
    ("xs", [1.0], "xs: length 1 != 2"),
    ("sub.events", KeyError, "sub.events: missing from the port"),
    ("sub.extra", 1, "sub.extra: only in the port"),
    ("n", 3.0, "n: 3.0 != 3"),
    ("sub.ok", 1, "sub.ok: 1 != True"),
])
def test_deterministic_diff_reports(path, value, want):
    """A changed value, an element, a length, a missing key, a key only the
    port writes, an int written as a float, a bool written as an int."""
    assert _diff(_with(path, value)) == [want]


def test_deterministic_diff_reports_a_timing_key_left_out_of_the_list():
    port = _with("sub.wall_s", 0.5)
    assert _diff(port) == []
    assert _diff(port, timing=("micro",)) == ["sub.wall_s: 0.5 != 0.25"]
    assert _diff(_with("micro.ft_build_s", 9.0), timing=("wall_s",)) == [
        "micro.ft_build_s: 9.0 != 0.1"]


def test_deterministic_diff_leaves_out_only_what_it_is_told():
    assert _diff(_with("engine", "vector_torch")) == []
    assert _diff(_with("engine", "vector_torch"), design=()) == [
        "engine: 'vector_torch' != 'vector'"]
    assert _diff(_with("wall_s", KeyError)) == ["wall_s: missing from the port"]
    assert _diff(_with("giga.n", 2), skip=("giga",)) == []
    assert _diff(_with("giga.n", 2), skip=("n",)) == ["giga.n: 2 != 1"]
    assert _diff(_with("n", float("nan")), _with("n", float("nan"))) == []


def test_artifact_lists_are_explicit_names():
    for name, (timing, design) in compare.ARTIFACTS.items():
        assert "device" in design, name
        assert all(isinstance(k, str) and "*" not in k for k in timing + design), name


# ----------------------------------------------------------------------
# --device: cuda by default, raising without a card
# ----------------------------------------------------------------------
SCRIPTS = ("bench_scale_1000", "bench_registry_sweep", "bench_blocks",
           "bench_trace_replay", "bench_placement", "bench_serving", "run")


@pytest.mark.parametrize("script", SCRIPTS)
def test_scripts_ask_for_the_card_by_default(script, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    monkeypatch.syspath_prepend(str(ROOT))
    mod = load(ROOT / "benchmarks_torch" / f"{script}.py")
    argv = ["--quick"] if script != "bench_registry_sweep" else []
    if script != "run":
        argv += ["--out", str(tmp_path / "x.json")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)
    assert not (tmp_path / "x.json").exists()


def test_summary_prints_the_reference_lines_and_the_device(tmp_path, capsys, monkeypatch):
    """``scripts/torch_bench_summary.py`` on the reference's artifacts (renamed,
    with a device block) prints the reference summary's lines, and one
    device line per artifact."""
    ref_dir = ROOT / "benchmarks_torch" / "reference"
    for src in sorted(ref_dir.glob("BENCH_*.json")):
        d = json.loads(src.read_text())
        d["device"] = {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W",
                       "torch": "2.x", "k1_launches": {"a": 2, "b": 3}}
        (tmp_path / src.name.replace("BENCH_", "BENCH_torch_")).write_text(json.dumps(d))
    monkeypatch.setattr(sys, "argv", ["bench_summary", "--dir", str(ref_dir)])
    load(ROOT / "scripts" / "bench_summary.py").main()
    want = capsys.readouterr().out.replace("BENCH_", "BENCH_torch_").splitlines()
    load(ROOT / "scripts" / "torch_bench_summary.py").main(["--dir", str(tmp_path)])
    got = capsys.readouterr().out.splitlines()
    device = [line for line in got if line.startswith("  device: ")]
    assert device == ["  device: NVIDIA H100 80GB HBM3, 700.00 W (torch 2.x); K1 launches 5 a=2 b=3"] * 6
    assert [line for line in got if not line.startswith("  device: ")] == want
