"""Elastic training with FT-managed membership + tree weight broadcast, on the
PyTorch + CUDA port.

    PYTHONPATH=src python examples/torch_elastic_train.py [--device cpu]

Walks through the FaaSNet story end to end (host-level simulation + real
training on this process, on the card unless ``--device cpu`` is given):
1. 8 hosts join the elastic pool — each streams the checkpoint from its FT
   parent, never the central store (except the first).
2. Straggler + failure are injected; the FT repairs; training restarts
   from the latest block checkpoint and reproduces the reference loss.
3. The device-plane broadcast schedules are compared on serialized link
   traffic (the §Perf "paper-representative" metric), each also as the time
   it would take over one link of ``--link-bw`` bytes/s: by default 450 GB/s,
   one direction of an H100 SXM's NVLink 4 (900 GB/s bidirectional, data
   sheet).
The JAX package's ``examples/elastic_train.py`` is the same program.
"""
import argparse
import sys
import tempfile

sys.path.insert(0, "src")

from repro_torch.configs import ModelConfig
from repro_torch.distributed.broadcast import binomial_rounds, faasnet_rounds
from repro_torch.distributed.elastic import ElasticConfig, ElasticCoordinator
from repro_torch.distributed.fault import FaultCoordinator
from repro_torch.train.loop import SimulatedFailure, run_train

CFG = ModelConfig(
    name="elastic_demo", family="dense", n_layers=3, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=344, vocab_size=1024, attn_impl="full", remat="none",
)
H100_NVLINK_ONE_WAY = 450e9


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=None,
                    help="where checkpoints go (default: a fresh temporary directory)")
    ap.add_argument("--link-bw", type=float, default=H100_NVLINK_ONE_WAY,
                    help="bytes/s of one link in section 3's time model "
                         "(default: an H100's NVLink 4, one direction)")
    args = ap.parse_args(argv)

    print("== 1. elastic join: 8 hosts, weights stream down the FT ==")
    ec = ElasticCoordinator(ElasticConfig(payload_bytes=2 * 10**9))
    for i in range(8):
        r = ec.join(now=float(i))
        src = r.upstream or "CENTRAL STORE"
        print(f"  host{i}: from {src:13s} in {r.provision_latency_s:5.1f}s "
              f"(tree height {r.tree_height})")
    print(f"  mesh proposal (tp=16): data x model = {ec.propose_mesh(16)}")

    print("== 2. failure: FT repair + checkpoint restart ==")
    fc = FaultCoordinator(ec.mgr)
    for h in ec.hosts:
        fc.monitor.beat(h, 0.0)
    victim = ec.hosts[2]
    for h in ec.hosts:
        if h != victim:
            fc.monitor.beat(h, 40.0)
    actions = fc.tick(now=45.0)
    print(f"  dead={actions['dead']} -> tree repaired, "
          f"{len(ec.hosts)} hosts remain, height "
          f"{ec.mgr.trees[ec.cfg.model_id].height}")

    with tempfile.TemporaryDirectory(prefix="repro_torch_elastic_") as tmp:
        ckpt = args.ckpt_dir or tmp
        kw = dict(steps=20, seq_len=64, batch=4, ckpt_dir=ckpt, ckpt_every=10, log_every=5,
                  device=args.device)
        try:
            run_train(CFG, fail_at_step=15, **kw)
        except SimulatedFailure as e:
            print(f"  {e} -> restarting from latest checkpoint")
        res = run_train(CFG, **kw)
    print(f"  resumed from step {res.resumed_from}, finished at "
          f"{res.final_step}, loss {res.losses[20]:.4f}")

    dp, blocks = 32, 32
    print(f"== 3. device-plane broadcast schedules ({dp} DP replicas, 2 GB) ==")
    payload, bw = 2e9, args.link_bw
    named = " (one direction of an H100's NVLink 4)" if bw == H100_NVLINK_ONE_WAY else ""
    print(f"  link model: {bw / 1e9:g} GB/s a link{named}")
    for name, ser in (
        ("naive (registry analogue)", (dp - 1) * payload),
        ("allgather", dp * payload),
        ("binomial tree", len(binomial_rounds(dp)) * payload),
        ("FaaSNet pipelined tree", len(faasnet_rounds(dp, blocks)) * payload / blocks),
        ("  + int8 compression", len(faasnet_rounds(dp, blocks)) * payload / (2 * blocks)),
    ):
        print(f"  {name:28s} serialized {ser/1e9:8.4f} GB  "
              f"modeled {ser/bw*1e3:8.2f} ms")
    print("OK")


if __name__ == "__main__":
    main()
