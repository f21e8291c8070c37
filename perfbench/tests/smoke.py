"""Small cells on the CPU for the benchmark's own tests: a root of data files
(``BENCHMARK.json``, configurations, mixes, limits) that finds the shared code
(drivers, reference, metric readers) in ``perfbench/``."""
from __future__ import annotations

import copy
import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

DENSE = {"name": "dense_smoke", "family": "dense", "n_layers": 3, "d_model": 128,
         "n_heads": 4, "n_kv_heads": 4, "d_ff": 344, "vocab_size": 512,
         "rope_theta": 10000.0, "norm": "rmsnorm", "act": "swiglu",
         "tie_embeddings": False, "compute_dtype": "bfloat16", "kv_cache_dtype": "bf16",
         "attn_impl": "pallas"}
MOE = dict(DENSE, name="moe_smoke", family="moe", n_kv_heads=2, d_ff=64, tie_embeddings=True,
           moe={"n_experts": 8, "top_k": 4, "d_expert": 64, "capacity_factor": 1.25})

# every request due at t = 0 and served to the end: the batches do not
# depend on the host's speed, so a run on a given seed is repeatable
QUEUE = {"driver": "serve", "arrival": "backlog", "requests": 12,
         "prompt_tokens": {"dist": "log_uniform", "min": 128, "max": 384, "multiple": 128},
         "new_tokens": {"dist": "log_uniform", "min": 2, "max": 6, "multiple": 1},
         "schedule_seed": 5, "shuffle_block": 4, "close": "drain", "trace_seconds": 1,
         "check_requests": 6}

# the widest served-logit gap allowed at this size: the dense smoke model in
# bf16 reads 0-0.03 against the float32 reference, its fp8 control 0.2-0.45
SMOKE_LIMIT = 0.1


def make_root(tmp: Path, cells: dict[str, tuple[dict, dict]], limit: float = SMOKE_LIMIT,
              extra_per_layer: list | None = None) -> Path:
    """A root whose BENCHMARK.json has ``cells`` ({workload: (model, mix)}),
    with the repository's metrics restricted to them."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    root = Path(tmp)
    for sub in ("configs", "traffic", "limits"):
        (root / "perfbench" / sub).mkdir(parents=True, exist_ok=True)
    bench["configs"], bench["workloads"] = [], []
    for name, (model, mix) in cells.items():
        cfg = {"name": model["name"], "source": "smoke", "reference": "decoder",
               "model": model, "deployment": {"chips": 1, "max_batch": 4, "context": 1024}}
        (root / f"perfbench/configs/{model['name']}.json").write_text(json.dumps(cfg))
        if model["name"] not in [c["name"] for c in bench["configs"]]:
            bench["configs"].append({"name": model["name"], "source": "smoke",
                                     "file": f"perfbench/configs/{model['name']}.json",
                                     "reduced": [], "why": "smoke"})
        (root / f"perfbench/traffic/{name}.json").write_text(json.dumps(mix))
        (root / f"perfbench/limits/{name}.json").write_text(
            json.dumps({"served_logit_gap": {"limit": limit}}))
        bench["workloads"].append({"name": name, "config": model["name"], "traffic": name,
                                   "chips": 1, "why": "smoke"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    bench["per_layer"] += extra_per_layer or []
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def queue_mix(**kw) -> dict:
    mix = copy.deepcopy(QUEUE)
    mix.update(kw)
    return mix
