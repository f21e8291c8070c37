"""Burst serving with FaaSNet cold starts (paper §4.2 + §4.6, end to end), on
the PyTorch + CUDA port.

    PYTHONPATH=src python examples/torch_burst_serving.py [--device cpu]

1. Trains a tiny LM briefly and checkpoints it in the block format.
2. Cold-starts a serving engine TWO ways: full restore vs FaaSNet lazy
   (on-demand) restore — printing time-to-first-weights and bytes fetched.
3. Simulates a 64-VM provisioning burst for the same checkpoint payload
   under faasnet / on-demand / baseline to show the fleet-level effect.
4. Serves a batch of requests through prefill + decode.

Everything runs on the card unless ``--device cpu`` is given (the flow
engine of step 3 included); the JAX package's ``examples/burst_serving.py``
is the same program.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ModelConfig
from repro_torch.models import model_for
from repro_torch.models.params import tree_map
from repro_torch.serving.engine import ServeEngine
from repro_torch.sim import WaveConfig, provision_wave
from repro_torch.train.loop import run_train
from repro_torch.train.step import init_train_state

CFG = ModelConfig(
    name="serve_demo", family="dense", n_layers=4, d_model=192, n_heads=6,
    n_kv_heads=2, d_ff=512, vocab_size=2048, attn_impl="full", remat="none",
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = ap.parse_args().device
    with tempfile.TemporaryDirectory(prefix="repro_torch_burst_") as tmp:
        run(os.path.join(tmp, "train"), os.path.join(tmp, "serve"), device)


def run(train_dir: str, serve_dir: str, device: str) -> None:
    print("== 1. train briefly + checkpoint (block format) ==")
    run_train(CFG, steps=12, seq_len=128, batch=4, ckpt_dir=train_dir,
              ckpt_every=12, log_every=6, device=device)
    mgr_train = CheckpointManager(train_dir)
    step = mgr_train.latest_step()
    gen = torch.Generator(device=device).manual_seed(0)
    like = model_for(CFG).init(gen)
    # export a serving checkpoint (params only) from the train checkpoint
    p0, o0 = init_train_state(CFG, gen)
    state = mgr_train.restore(step, {"params": p0, "opt": o0}, device=device)
    mgr = CheckpointManager(serve_dir)
    mgr.save(step, tree_map(lambda a, b: a.to(b.dtype), state["params"], like))

    print("== 2. cold start: full vs on-demand (lazy) restore ==")
    eng_full = ServeEngine(CFG, device=device)
    eng_full.start(mgr, step, like, lazy=False)
    print(f"  full restore: {eng_full.cold_start_stats['t_full_s']*1e3:.1f} ms")
    eng = ServeEngine(CFG, device=device)
    eng.start(mgr, step, like, lazy=True)
    s = eng.cold_start_stats
    print(f"  lazy restore: first leaves in {s['t_first_leaves_s']*1e3:.1f} ms "
          f"({s['first_fetch_compressed_bytes']/1e3:.0f} KB compressed), "
          f"full in {s['t_full_s']*1e3:.1f} ms, "
          f"read amplification {s['read_amplification']:.2f}x")

    print("== 3. fleet-level burst: provision this image to 64 VMs ==")
    ckpt_bytes = mgr._load_manifest(step)[0]["block_manifest"]["raw_size"]
    wave = WaveConfig(image_bytes=max(int(ckpt_bytes), 50_000_000),
                      container_start=0.5, device=device)
    for system in ("faasnet", "on_demand", "baseline"):
        lat = provision_wave(system, 64, wave)
        print(f"  {system:10s} mean={np.mean(list(lat.values())):6.2f}s "
              f"max={max(lat.values()):6.2f}s")

    print("== 4. serve a burst of requests ==")
    rng = np.random.default_rng(0)
    for _ in range(6):
        eng.submit(rng.integers(0, CFG.vocab_size, size=12), max_new_tokens=6)
    done = []
    while eng.queue:
        done += eng.step_batch()
    for r in done[:3]:
        print(f"  req{r.rid}: {len(r.out_tokens)} tokens "
              f"ttft={(r.t_first_token - r.t_arrival)*1e3:.0f}ms "
              f"total={(r.t_done - r.t_arrival)*1e3:.0f}ms")
    print(f"OK: served {len(done)} requests")


if __name__ == "__main__":
    main()
