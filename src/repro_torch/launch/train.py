"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Trains a smoke config (or, with ``--full-config``, the published one) end to
end with block-format checkpoint/restart, on the card unless ``--device cpu``
is given.  The reference's ``--mesh`` path (sharding rules over a device
mesh) is not ported.
"""
from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--full-config", action="store_true",
                    help="use the published config instead of smoke")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import run_train

    cfg = get_config(args.arch) if args.full_config else get_smoke(args.arch)
    print(f"training {cfg.name}: ~{cfg.param_count()/1e6:.1f}M params, "
          f"{args.steps} steps on {args.device}")
    res = run_train(
        cfg, steps=args.steps, seq_len=args.seq_len, batch=args.batch,
        n_micro=args.n_micro, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, fail_at_step=args.fail_at,
        opt=AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                        total_steps=args.steps),
        log_every=max(1, args.steps // 20), device=args.device,
    )
    for step, loss in sorted(res.losses.items()):
        print(f"step {step:6d}  loss {loss:.4f}")
    if res.resumed_from:
        print(f"(resumed from checkpoint step {res.resumed_from})")


if __name__ == "__main__":
    main()
