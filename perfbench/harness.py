"""The benchmark's core: find a cell's files by name, run its driver, read
its metrics, and build the result line.

Everything that belongs to one configuration, traffic mix, driver, metric or
cell lives in a file of its own, found by the name ``BENCHMARK.json`` gives:

=====================  ==========================================
configuration          the ``file`` of its ``configs`` entry
traffic mix            ``perfbench/traffic/<traffic>.json``
driver                 ``perfbench/drivers/<mix["driver"]>.py``
plain reference        ``perfbench/reference/<config["reference"]>.py``
metric reader          ``perfbench/metrics/<metric name>.py``
a cell's limits        ``perfbench/limits/<workload name>.json``
=====================  ==========================================

Each lookup tries ``<root>/perfbench/...`` first and then this directory, so
a root that holds only new data files still finds the shared code.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def find(root: Path, kind: str, name: str, ext: str) -> Path:
    for base in (Path(root) / "perfbench", HERE):
        path = base / kind / f"{name}{ext}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {kind} file for {name!r} ({kind}/{name}{ext})")


def load_module(path: Path) -> ModuleType:
    mod_name = "perfbench_" + "_".join(path.with_suffix("").parts[-2:]).replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded() -> list[str]:
    """Top-level module names in ``sys.modules`` that this benchmark must
    never load: JAX, its libraries, and the JAX package (whole names)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


@dataclass
class Cell:
    """One workload entry with everything it names, loaded."""
    root: Path
    bench: dict
    workload: dict
    config: dict
    mix: dict
    limits: dict

    @property
    def name(self) -> str:
        return self.workload["name"]

    def metrics(self, section: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
        return [m for m in self.bench[section]
                if "workloads" not in m or self.name in m["workloads"]]

    def driver(self) -> ModuleType:
        return load_module(find(self.root, "drivers", self.mix["driver"], ".py"))

    def reference(self) -> ModuleType:
        return load_module(find(self.root, "reference", self.config["reference"], ".py"))


def load_cell(root: Path, workload: str) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(by_name)}")
    w = by_name[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    mix = json.loads(find(root, "traffic", w["traffic"], ".json").read_text())
    limits = json.loads(find(root, "limits", workload, ".json").read_text())
    return Cell(root, bench, w, config, mix, limits)


@dataclass
class Request:
    """What the harness saw of one request."""
    due: float  # absolute host time (time.monotonic) it was due
    prompt_len: int
    max_new: int
    prompt: Any
    batch: int = -1  # index into RunRecord.batches
    t_batch_start: float = math.nan
    t_first: float = math.nan
    t_done: float = math.nan
    tokens: list = field(default_factory=list)
    token_times: list = field(default_factory=list)  # completion of each token
    finished: bool = False


@dataclass
class Batch:
    rows: list  # request indices, in the engine's row order
    t_start: float
    padded_t: int
    budget: int
    t_end: float = math.nan
    prefill_s: Optional[float] = None  # traced runs: host clock to a synchronise
    prefill_in_trace: bool = False
    step_calls: list = field(default_factory=list)  # host time of each decode call
    steps: list = field(default_factory=list)  # traced: (seconds, contexts, in_trace)


@dataclass
class RunRecord:
    """Everything a metric reader may read: spans and counters the harness
    took around its calls into the program, and the trace summary."""
    config: dict
    mix: dict
    seconds: float
    setup_s: float = math.nan
    window_open: float = math.nan
    window_close: float = math.nan
    window_end: float = math.nan  # the window's last batch done (after a drain)
    trace_start: float = math.inf  # traced runs: when the profiler started
    requests: list = field(default_factory=list)
    batches: list = field(default_factory=list)
    trace: Any = None  # trace.TraceSummary in a traced run

    @property
    def model(self) -> dict:
        return self.config["model"]


def p90(values: list[float]) -> Optional[float]:
    """Nearest-rank 90th percentile; ``None`` for no values."""
    if not values:
        return None
    vals = sorted(values)
    return vals[max(math.ceil(0.9 * len(vals)) - 1, 0)]


def read_metrics(cell: Cell, run: RunRecord, section: str) -> dict:
    out = {}
    for m in cell.metrics(section):
        value = load_module(find(cell.root, "metrics", m["name"], ".py")).read(run)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
