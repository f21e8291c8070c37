"""Every cell of BENCHMARK.json resolves to its files by name, the file keeps
to the benchmark's contract, and a cell made only of new files is found."""
from __future__ import annotations

import json
import re
import sys
import time

import pytest

from perfbench.harness import find, load_cell
from perfbench.tests.smoke import DENSE, REPO, make_root, queue_mix

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


# A cell whose files this benchmark keeps but whose entries it holds back
# (PERF.md, Open questions): these entries alone make it a cell again.
HELD_BACK = {
    "deepseek_7b.chat_backlog": {
        "workloads": [{"name": "deepseek_7b.chat_backlog", "config": "deepseek_7b",
                       "traffic": "chat_backlog", "chips": 1, "why": "a decode backlog"}],
        "end_to_end": [{"name": "output_tokens_per_s", "unit": "tokens/s", "better": "higher",
                        "bound": 0.25, "source": "host_clock",
                        "workloads": ["deepseek_7b.chat_backlog"]}],
        "per_layer": [{"name": name, "unit": "%", "better": better, "source": source,
                       "layer": layer, "moves": "output_tokens_per_s",
                       "workloads": ["deepseek_7b.chat_backlog"]}
                      for name, better, source, layer in (
                          ("engine.useful_slot_share", "higher", "program_counter",
                           "serving/engine.py"),
                          ("mfu.decode", "higher", "host_clock", "models/transformer.py"),
                          ("device.idle_share.decode", "lower", "device_trace", "device"))],
    },
}


def _root_with(tmp_path, workload):
    """The repository's root, or for a held-back cell a root whose
    BENCHMARK.json adds its entries and whose other files are the repository's."""
    if workload not in HELD_BACK:
        return REPO
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for section, entries in HELD_BACK[workload].items():
        have = {e["name"] for e in bench[section]}
        bench[section] += [e for e in entries if e["name"] not in have]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for c in bench["configs"]:
        (tmp_path / c["file"]).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / c["file"]).write_text((REPO / c["file"]).read_text())
    return tmp_path


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]]
                         + [w for w in HELD_BACK if w not in {x["name"] for x in BENCH["workloads"]}])
def test_cell_resolves_by_name(workload, tmp_path):
    root = _root_with(tmp_path, workload)
    cell = load_cell(root, workload)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.driver().drive
    assert cell.reference().served_logits
    compared = {"served_logit_gap", "served_logit_gap_mean"} & set(cell.limits)
    assert compared and all(
        cell.limits[n]["lower"] < cell.limits[n]["limit"] < cell.limits[n]["upper"]
        and cell.limits[n]["upper"] >= 3 * cell.limits[n]["lower"] for n in compared)
    for section in ("end_to_end", "per_layer"):
        for m in cell.metrics(section):
            assert find(root, "metrics", m["name"], ".py").is_file()


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and BENCH["command"][1] == "perfbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for sec in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[sec]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (REPO / c["file"]).is_file()
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
        cell = load_cell(REPO, w["name"])
        reported = {m["name"] for m in cell.metrics("end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        layer = cell.metrics("per_layer")
        assert layer and all(m["moves"] in reported for m in layer)
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e and "\n" not in m["layer"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_cell_made_only_of_new_files_is_found_and_run(tmp_path):
    """A configuration, a mix, a cell and a per-layer metric added as files
    and entries, with no file of perfbench/ edited."""
    new_metric = {"name": "engine.batches_served", "unit": "batches", "better": "higher",
                  "source": "program_counter", "layer": "serving/engine.py",
                  "moves": "setup_s"}
    root = make_root(tmp_path, {"new.cell": (dict(DENSE, name="brand_new"), queue_mix())},
                     extra_per_layer=[new_metric])
    (root / "perfbench" / "metrics").mkdir()
    (root / "perfbench/metrics/engine.batches_served.py").write_text(
        "def read(run):\n    return len(run.batches)\n")
    sys.path.insert(0, str(REPO / "src"))
    from perfbench.run import run_cell

    res, _ = run_cell(root, "new.cell", 7, 1.0, True, device="cpu", t0=time.monotonic())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] == 12
    assert res["metrics"]["engine.batches_served"]["value"] == 3
    assert list(res)[-1] == "checks"
