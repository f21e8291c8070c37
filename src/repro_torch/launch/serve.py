"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Initialises a model from a seed, saves it as a block-format checkpoint,
cold-starts the engine from it via the FaaSNet on-demand path, and serves
synthetic batched requests, on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
import tempfile


def default_config():
    from repro_torch.configs import ModelConfig

    return ModelConfig(
        name="serve_default", family="dense", n_layers=4, d_model=192,
        n_heads=6, n_kv_heads=2, d_ff=512, vocab_size=2048,
        attn_impl="full", remat="none",
    )


def serve(cfg, *, requests: int = 8, max_new_tokens: int = 8, prompt_len: int = 16,
          ckpt_dir: str, device="cuda", seed: int = 0):
    """Save -> lazy cold start -> serve; returns (engine, finished requests)."""
    import numpy as np
    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models import model_for
    from repro_torch.models.params import MetaGenerator
    from repro_torch.serving.engine import ServeEngine

    eng = ServeEngine(cfg, max_batch=4, device=device)  # raises early without CUDA
    gen = torch.Generator(device=device).manual_seed(seed)
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(0, model_for(cfg).init(gen))  # the init params go once saved
    eng.start(mgr, 0, model_for(cfg).init(MetaGenerator()), lazy=True)
    rng = np.random.default_rng(seed)
    for _ in range(requests):
        eng.submit(rng.integers(0, cfg.vocab_size, size=prompt_len),
                   max_new_tokens=max_new_tokens)
    done = []
    while eng.queue:
        done += eng.step_batch()
    return eng, done


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="smoke config of an assigned arch")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_serve"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    import numpy as np

    from repro_torch.configs import get_smoke

    cfg = get_smoke(args.arch) if args.arch else default_config()
    if cfg.family in ("audio",):
        raise SystemExit("enc-dec serving demo requires frames; use the LM archs")
    eng, done = serve(cfg, requests=args.requests, max_new_tokens=args.max_new_tokens,
                      prompt_len=args.prompt_len, ckpt_dir=args.ckpt_dir, device=args.device)
    s = eng.cold_start_stats
    print(f"cold start (lazy): first weights {s['t_first_leaves_s']*1e3:.0f} ms, "
          f"full {s['t_full_s']*1e3:.0f} ms, "
          f"amplification {s['read_amplification']:.2f}x")
    lat = [(r.t_done - r.t_submit) * 1e3 for r in done]
    print(f"served {len(done)} requests; latency mean {np.mean(lat):.0f} ms, "
          f"p99 {np.percentile(lat, 99):.0f} ms")


if __name__ == "__main__":
    main()
