"""Loss trajectories of granite_moe_1b trained at full width on the card.

    PYTHONPATH=src python scripts/torch_train_loss_probe.py

Eight AdamW steps (warmup 2, cosine to step 8) of 8 x 512 tokens in two
microbatches over fresh ``make_batch`` batches, as ``chip_smoke.py``'s
``train`` phase runs them, for five settings: bf16 at learning rate 1e-3
with remat "block" and "none", float32 at 1e-3, and bf16 at 3e-4 and 1e-4.
Each step prints (loss, the last microbatch's cross-entropy, grad norm,
learning rate): the total loss adds the router's load-balancing term,
summed over 24 layers, to the cross-entropy.  Needs one CUDA card.
"""
import dataclasses
import sys
import time

sys.path.insert(0, "src")

import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import make_batch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step

SETTINGS = [("bfloat16", 1e-3, "block"), ("bfloat16", 1e-3, "none"), ("float32", 1e-3, "block"),
            ("bfloat16", 3e-4, "block"), ("bfloat16", 1e-4, "block")]


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    base = get_config("granite_moe_1b")
    for dtype, lr, remat in SETTINGS:
        cfg = dataclasses.replace(base, compute_dtype=dtype, remat=remat)
        params, opt = init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0))
        _, step = make_train_step(cfg, opt=AdamWConfig(lr=lr, warmup_steps=2, total_steps=8),
                                  n_micro=2)
        rows = []
        t0 = time.perf_counter()
        for s in range(8):
            b = make_batch(cfg, 512, 8, kind="train", seed=s, device="cuda")
            params, opt, m = step(params, opt, b)
            rows.append((float(m["loss"]), float(m["ce_last"]), float(m["grad_norm"]),
                         float(m["lr"])))
        torch.cuda.synchronize()
        print(dtype, lr, remat, "seconds", time.perf_counter() - t0, rows, flush=True)
        del params, opt, step
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
