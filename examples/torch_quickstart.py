"""Quickstart: train a small LM with FaaSNet-format checkpointing, on the
PyTorch + CUDA port.

    PYTHONPATH=src python examples/torch_quickstart.py [--steps 60] [--device cpu]

Trains a ~4M-param dense transformer on the synthetic pipeline, on the card
unless ``--device cpu`` is given, saving block-format checkpoints
(compressed blocks + an offset-table manifest — the paper's I/O-efficient
format) asynchronously, and printing the loss curve.  Scale up with
``--arch`` (any decoder-only arch's smoke config) or ``--full-100m`` for a
~100M-param config.  The JAX package's ``examples/quickstart.py`` is the
same program.
"""
import argparse
import sys
import tempfile

sys.path.insert(0, "src")

from repro_torch.configs import ARCH_IDS, ModelConfig, get_smoke
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import run_train

SMALL = ModelConfig(
    name="quickstart_4m", family="dense", n_layers=4, d_model=256, n_heads=8,
    n_kv_heads=4, d_ff=683, vocab_size=4096, attn_impl="full", remat="none",
)

LM_100M = ModelConfig(
    name="quickstart_100m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=2048, vocab_size=32768,
    attn_impl="chunked", attn_chunk=256,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--arch", choices=ARCH_IDS, default=None,
                    help="train a smoke config of an assigned arch instead")
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="where checkpoints go (default: a temporary directory)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = SMALL
    if args.arch:
        cfg = get_smoke(args.arch)
    if args.full_100m:
        cfg = LM_100M
    print(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
          f"steps={args.steps} seq={args.seq_len} batch={args.batch} device={args.device}")
    with tempfile.TemporaryDirectory(prefix="repro_torch_quickstart_") as tmp:
        ckpt_dir = args.ckpt_dir or tmp
        res = run_train(
            cfg, steps=args.steps, seq_len=args.seq_len, batch=args.batch,
            ckpt_dir=ckpt_dir, ckpt_every=max(args.steps // 3, 10),
            async_save=True, log_every=max(args.steps // 12, 1),
            opt=AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps),
            device=args.device,
        )
    print("loss curve:")
    for step, loss in sorted(res.losses.items()):
        print(f"  step {step:5d}  loss {loss:.4f}")
    print(f"wall {res.wall_s:.1f}s  checkpoints in "
          f"{args.ckpt_dir or 'a temporary directory, now removed'}")
    first, last = min(res.losses), max(res.losses)
    if not res.losses[last] < res.losses[first]:
        raise SystemExit("loss did not decrease!")
    print("OK: loss decreased")


if __name__ == "__main__":
    main()
