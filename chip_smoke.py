#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, all started together; the registers, spills and SASS
of every K3, K4 and K5 instance are reported), holds each against its plain
PyTorch version on the card (K2 against ``torch.bincount`` on edge cases
and the giga plan; K3 at every head dim the configs use and at ragged
T < 128, its bf16 tensor-core instance also against
``flash_attention_tiled_ref``, which shares its rounding points; K4 at
every head dim on prefix, ring and scattered masks, its bf16 tiled
instance also against ``decode_attention_tiled_ref``, and with NaN in every
fully masked tile, which it must never read; K5 at every (P, N) it takes,
a chunk under 64 rows included, also against ``ssd_scan_tiled_ref``; the
MoE router's expert-position kernel bit for bit against the one-hot cumsum
at granite_moe_1b's and deepseek_moe_16b's full batch, the mesh's 16
routings, decode, an all-same-expert skew and one token), and drives the
port's two paths:

* provisioning: ``repro_torch.sim.run_scale`` with the ``vector_torch``
  engine on ``cuda`` at the paper tier (1,000 VMs, 5 x 500 containers) and
  the production-fleet tier (100,000 VMs, 25 x 40,000 containers), checked
  exactly against the values ``BENCH_scale.json`` records, every wide
  front through the engine's packed K1 route (one pinned copy each way);
  then the multi-tenant trace replay (``MultiTenantReplay``) on
  ``vector_torch``, ``cuda``: the two 3-tenant replay goldens (exclusive
  TickStats, serving responses) at scalar cutoffs 64 and 0, and
  ``giga_replay_config(0)`` (32 tenants, 100,000 VMs, serving + blocks + a
  failover), every field equal to a same-machine numpy ``vector`` run and
  to ``BENCH_scale.json``'s ``giga_replay`` counts;
* serving: ``ServeEngine`` at full width, random float32 master weights
  drawn on the card from a seed, answering 8 requests of 512 prompt tokens
  with 16 new tokens each, 4 to a batch:
  - ``deepseek_7b`` (30 layers, d 4096) with ``attn_impl="pallas"``,
    cold-started from its own 27.6 GB block checkpoint (saved on the
    host's cores, freed, restored with ``lazy=True`` against a ``meta``
    tree: one copy on the card; every leaf's fingerprint equal to the
    saved one's), so the flash-attention kernel (K3) runs at its serving shape; a float32
    prefill through K3 and through ``chunked`` must agree (a bf16 one is
    compared and reported); the
    decode-attention kernel (K4) runs through ``ops.decode_attention`` on
    layer 0's operands of every decode step, held against ``attend_decode``;
  - ``mamba2_130m`` (24 Mamba2 layers, d 768, d_state 128); the SSD-scan
    kernel (K5) runs through ``ops.ssd_scan`` on every layer's operands of
    the first prefill, held against the model's ``ssd_chunked``; in float32
    the decode caches must reproduce a prefill of the generated text;
  - ``granite_moe_1b`` (24 layers, 32 experts top-8, GQA at hd 64) with
    ``attn_impl="pallas"``, checked as deepseek_7b is, with the router's
    expert-position kernel launched once a layer of every prefill and
    decode step;
  - ``whisper_medium`` (24 encoder + 24 decoder layers, d 1024, 16 heads
    x 64, encoder ctx 1500) with ``attn_impl="pallas"``, through the model
    facade (``ServeEngine`` feeds no frames, in either package): 8 requests
    of (1500, 1024) frame embeddings and a 128-token prompt, 32 new tokens
    each, 4 to a batch; K3 on the decoder's prefill self-attention, 48
    launches; the param tree must hold the reference's 759,592,960; an f32
    prefill through K3 against ``chunked``; and a 2 + 2 layer cut at full
    width served 24 steps on the card against the port's CPU path;
  - ``gemma3_1b`` (26 layers, d 1152, 4 heads x 256, 22 local layers with a
    512-token window) with ``attn_impl="pallas"`` and 1,024-token prompts,
    cold-started from its 4.0 GB checkpoint, whose first fetch is a real
    prefix (the manifest's blocks for the embedding, layer 0 and the final
    norm); every leaf bit for bit the saved one; K3's windowed and global
    hd-256 instances counted apart (44 + 8); an f32 prefill through K3
    against ``chunked``;
  - and the block-checkpoint cold start (save, lazy restore, serve) on
    deepseek_7b's smoke config, card against CPU.
* training (phase ``train``; the training path launches no attention or SSD
  kernel, as the reference trains through ``full``/``chunked`` attention and
  its Pallas kernels have no backward; the MoE router's forward launches its
  expert-position kernel, whose slots carry no gradient):
  - one float32 train step of seven smoke configs (whisper_medium's
    included) on the card against the port's CPU path, from the same
    seeded params and batch;
  - the restart of ``tests/test_train.py`` on the card: a run that fails
    at step 13 and resumes from its step-10 block checkpoint must reach the
    uninterrupted run's loss at step 20 within 1e-4;
  - ``granite_moe_1b`` (1,334,628,352 parameters, remat "block") trained
    at full width through ``run_train``: 8 steps of 8 x 512 tokens in two
    microbatches, each timed; ``n_micro`` 1 against 2; a falling loss over
    one repeated batch; peak memory with and without remat; a profiled
    step;
  - ``ops.flash_attention`` under autograd on the card must refuse.
* the device-plane weight broadcast (phase ``broadcast``; no kernel, as the
  reference broadcasts through XLA collectives):
  - ``granite_moe_1b``'s full weights as one bf16 image of 32 blocks,
    streamed from position 0 to the 7 others of an (8, 1) mesh on the card
    by ``naive``, ``allgather``, ``binomial``, ``pipelined`` (the FaaSNet
    tree) and int8 ``pipelined``, from sentinel-filled buffers: every
    position bit-equal to the root, the returned tree to the cast params
    (int8: to the dequantized image), rounds, serialized and copied bytes
    as the reference's round functions give them; each timed by CUDA
    events beside its HBM bound and the link model at an H100's NVLink;
  - the smoke config on a (4, 2) mesh, card against CPU, bit for bit;
  - ``examples/torch_elastic_train.py`` on the card.
* the dry runs (phase ``dryrun``; no kernel, they trace ``chunked``):
  three production cells traced on ``meta`` through
  ``launch/dryrun.py::run_cell``, each roofline finite; then granite_moe_1b's
  train step (phase train's recipe), deepseek_7b's 4 x 512 prefill and its
  4 x 1 decode against a 1,024-slot int8 cache, each predicted on a meta
  (1, 1) mesh and run on the card: ``FlopCounterMode`` over the card's run
  equal to the meta trace's FLOPs, the arguments' bytes equal to the dry
  run's ``argument_size_in_bytes``, device ms, host wall, peak memory and
  the measured share of the roofline printed beside the prediction; and the
  broadcast dry run of granite_moe_1b on both production meshes, its rounds
  the port's round lists'.
* the paper's evaluation harness (phase ``benches``): the six scripts of
  ``benchmarks_torch/`` in-process at their defaults on the card
  (``bench_scale_1000.py --mega``; the giga tiers are the phases above),
  each artifact held field for field by ``compare.artifact_diff`` against
  the unchanged reference script's output in ``benchmarks_torch/reference/``
  (every in-bench assertion raising), K1 launched in each, each bench's
  walls printed beside the reference's CPU walls; then
  ``paper_figures.ALL`` at full size, every row of Figures 11-18 equal to
  the reference's CSV.
* the mesh layer (phase ``mesh``): ``granite_moe_1b`` at full width under
  the production (16, 16) mesh, whose 256 positions are the one card (dp
  16, so each MoE layer routes 16 shards of tokens apart):
  - one MoE layer, 4 x 512 tokens in float32: the per-shard slots equal
    ``route_topk`` on the CPU from the card's logits, bit for bit; ``y``
    within 2e-4 of max|y| of the port's CPU ``apply_moe``; dropped pairs
    per shard against the one-device branch;
  - two bf16 prefills of 4 x 512 tokens through K3 (launches counted),
    a profiled prefill, and the float32 check of K3 against ``chunked``;
  - phase train's recipe inside the context, timed, profiled and beside
    phase train's numbers; the mesh step outside the context equal to the
    ``mesh=None`` step bit for bit; a float32 smoke step in the context on
    the card against the CPU.

It then times the kernels (K1's packed engine route beside its tensor
wrapper; K2 and K4 with a cold L2, rotating through operand sets over
``COLD_BYTES`` in all, each beside its first design in the same run; K3's
bf16 and float32 instances each beside causal SDPA, also at whisper_medium's
prefill shape; K5's three passes).  Each phase prints one JSON line; any failure
raises and the script exits non-zero.  The last lines are the kernel table, the
card's name and power limit as ``nvidia-smi`` reports them, and
``{"ok": true, "device": {...}}``.  Without CUDA, or outside a checkout, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

PAPER_MAKESPAN = 12.810758878720002
GIGA_MAKESPAN = 57.796700031959624
GIGA_FRONTS = 5949
GIGA_FLOWS = 5_361_821
GIGA_MEAN_WIDTH = GIGA_FLOWS // GIGA_FRONTS  # 901
SMALL_SHA = "bb5965a1fa885edd0aaf968dfec9bad59941edf5c13a367d869ed2eea7954c82"

# The trace replay's goldens, copied from the JAX package's tests:
# GOLDEN_EXCLUSIVE_3T (tests/test_placement.py:39), the SHA-256 of the
# per-tenant TickStats streams of 3 tenants x 250 VMs x 4 min under exclusive
# placement; GOLDEN_SERVING_3T (tests/test_request_serving.py:63), the SHA-256
# of the per-tenant response streams of the 3-min serving replay.
GOLDEN_EXCLUSIVE_3T = "dfa29f6c603ea308f7675d91fbbb1b0687b14c9461c12c55288170041cc53e3a"
GOLDEN_SERVING_3T = "70edf3161d5c485b89f81d5a5bf0d8a239e48c5495c131703f9782c77f5f5ea3"
# giga_replay's counts in BENCH_scale.json, each compared exactly as stored
# (the file holds every one at full float precision, none rounded)
REPLAY_KEYS = ("n_tenants", "vm_pool_size", "duration_s", "serving", "blocks", "requests",
               "completed", "cold_starts", "failovers", "prov_makespan_s",
               "peak_registry_egress_gbps", "vm_hours", "worst_p99_response_s",
               "peak_nic_utilization")

# H100 SXM data sheet: HBM3 bandwidth, FP64 and FP32 (non-tensor) peaks,
# INT32 peak (64 INT32 lanes per SM, half the FP32 rate), dense BF16
# tensor-core peak.
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 33.5e12
BF16_OPS_PER_S = 989e12

# K3 shapes: the flash-attention sweep of tests/test_kernels.py as
# (BH, T, hd, window), one masked-row window case, every other head dim the
# configs use (stablelm_12b_smoke 16, gemma3_1b_smoke 48, stablelm_12b 160,
# gemma3_1b 256), gemma3_1b's local layer (window 512 over T 1024), ragged
# T < 128 that no 64-row tile divides (with and without a window), and the
# serving shape last.
K3_SWEEP = [(8, 256, 64, None), (2, 512, 64, None), (4, 256, 128, None),
            (4, 256, 64, 64), (1, 128, 32, 32), (2, 256, 64, 16),
            (8, 256, 16, None), (8, 256, 48, None), (4, 256, 160, None),
            (4, 256, 256, None), (4, 1024, 256, 512),
            (4, 16, 64, None), (2, 16, 256, 8), (4, 40, 128, None), (2, 40, 160, 24),
            (4, 100, 64, None), (2, 100, 128, 30)]
K3_SERVE = (128, 512, 128, None)
K3_HD256 = (16, 1024, 256)  # gemma3_1b's global layer: 4 requests x 4 heads, T 1024
GEMMA_WINDOW = 512  # and its 22 local layers' sliding window
# bf16 against the plain version: 2e-2 abs and 2e-3 + 2e-2 |want| at once
# (the second breaks when a late row, output ~0.1, loses a KV tile); against
# flash_attention_tiled_ref, which shares the kernel's rounding points,
# 1e-3 + 1e-2 |want|.  float32: 2e-4.
K3_TOL = {"bfloat16": 2e-2, "float32": 2e-4}
K3_REL = (2e-3, 2e-2)
K3_TILED = (1e-3, 1e-2)

# K4 shapes: the decode sweep of tests/test_kernels.py (B 2, H 4, hd 64) as
# (S, valid_upto), and deepseek_7b's decode shape: BH 128 (4 requests x 32
# heads), hd 128, the 528-slot cache rounded up to a multiple of 512.
K4_SWEEP = [(512, 511), (1024, 700), (2048, 1)]
K4_SERVE = (128, 1024, 128)
K4_TOL = K3_TOL
# the bf16 tiled instance against decode_attention_tiled_ref, which shares
# its tiles, skip rule and splits: 1e-3 + 1e-2 |want|
K4_TILED = (1e-3, 1e-2)
# also timed: granite_moe_1b's decode heads (4 requests x 16, hd 64) and
# gemma3_1b's (4 x 4, hd 256), at deepseek_7b's S and valid count
K4_OTHER = [(64, 64), (16, 256)]

# K5 shapes: the SSD sweep of tests/test_kernels.py as (T, H, P, G, N, chunk)
# at B 2, and mamba2_130m's full-width prefill (B 4, T 512, 24 heads x 64,
# one group, d_state 128, the model's chunk 256).  Tolerances as there:
# |got - want| <= atol + 3e-2 |want|.
K5_SWEEP = [(256, 4, 64, 1, 32, 64), (128, 2, 32, 2, 16, 32), (512, 4, 64, 1, 64, 128)]
K5_SERVE = (4, 512, 24, 64, 1, 128, 256)
K5_ATOL = {"bfloat16": 3e-2, "float32": 1e-3}
K5_RTOL = 3e-2
# against ssd_scan_tiled_ref, which shares the kernel's rounding points:
# 1e-3 + 1e-2 |want|, at every (P, N) the kernel takes, as (T, H, chunk) at
# B 1, one G: two chunks of 128, and two chunks of 48 (under the 64-row tile)
K5_TILED = (1e-3, 1e-2)
K5_PAIRS_SHAPES = [(256, 2, 128), (96, 2, 48)]

SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW, SERVE_BATCH = 8, 512, 16, 4
# The router's expert positions, (L, n, E, k, capacity, skew): granite_moe_1b's
# full batch (4 rows x 3,968 tokens) at its prefill capacity, deepseek_moe_16b's
# (E, k) at the same tokens, the (16, 16) mesh's 16 shards of it, a decode
# step (capacity n), every token choosing the same experts, one token
MOE_ROUTE_TOKENS = 15_872
MOE_ROUTE_CASES = {
    "granite_moe_1b": (1, MOE_ROUTE_TOKENS, 32, 8, 4_960, False),
    "deepseek_moe_16b": (1, MOE_ROUTE_TOKENS, 64, 6, 1_860, False),
    "mesh_16_shards": (16, MOE_ROUTE_TOKENS // 16, 32, 8, 310, False),
    "decode": (1, 4, 32, 8, 4, False),
    "skew": (1, MOE_ROUTE_TOKENS, 32, 8, 4_960, True),
    "one_token": (1, 1, 32, 8, 1, False),
}
# gemma3_1b is served with 1,024-token prompts: its 22 local layers' 512-token
# window bites (at 512 tokens it would not).
GEMMA_PROMPT = 1024
# The JAX package's init tree for gemma3_1b holds 999,826,048 parameters
# (jax.eval_shape of its model_for(cfg).init); cfg.param_count() leaves out
# the q and k norms of its 26 layers, 999,812,736.
TREE_PARAMS = {"gemma3_1b": 999_826_048}
# Block checkpoints of the full-width cold starts go under the checkout's
# gitignored build/ (the checkout's disk; deepseek_7b's is ~26 GB).
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"

# whisper_medium served through the model facade (ServeEngine feeds tokens
# only, in either package): 8 requests, 4 to a batch, each with its own
# (1500, 1024) frame embeddings and a 128-token prompt (within Whisper's
# 224-token cap on the previous-text prompt, and a multiple of K3's 128-row
# tile, which the kernel's wrapper requires of T >= 128 as the Pallas one
# does), 32 new tokens each.  The self-cache is a ring as long as the
# prompt, so decode wraps it.
WHISPER_REQUESTS, WHISPER_PROMPT, WHISPER_NEW = 8, 128, 32
# The JAX package's init tree for whisper_medium holds 759,592,960
# parameters (jax.eval_shape of its model_for(cfg).init); cfg.param_count()
# is the reference's rough enc-dec count, 707,594,240.
WHISPER_PARAMS = 759_592_960
# check (d): whisper_medium's widths and encoder_ctx at 2 + 2 layers, f32,
# a 16-token prompt and 24 decode steps on the card and on the CPU
WHISPER_CPU = dict(layers=2, batch=2, prompt=16, steps=24, limit=1e-4)
# K3 on whisper_medium's decoder prefill: 4 requests x 16 heads, T 128, hd 64
K3_WHISPER = (SERVE_BATCH * 16, WHISPER_PROMPT, 64)

# The training path.  (a) One float32 train step of each smoke config on the
# card against the port's CPU path (which the CPU tests hold against the JAX
# package), from the same seeded params and batch: two microbatches of
# 2 x 32 tokens, AdamW without warmup.  Limits: loss 1e-5 relative,
# grad_norm 1e-4, updated master 2·lr + 1e-6 absolute (step 1 of Adam is
# lr·sign(g), and a near-zero gradient may flip its sign).  (b) The restart
# test of tests/test_train.py on deepseek_7b's smoke config: 20 steps, a
# checkpoint every 10, a failure at step 13; the resumed run's loss at step
# 20 within 1e-4 of the uninterrupted one.  (c) granite_moe_1b at full width
# (remat "block", attn_impl "chunked", as its config sets them).
TRAIN_PARITY_ARCHS = ("deepseek_7b", "granite_moe_1b", "mamba2_130m", "jamba_v01_52b",
                      "gemma3_1b", "llava_next_mistral_7b", "whisper_medium")
TRAIN_PARITY = dict(seq_len=32, batch=4, n_micro=2, lr=1e-3)
TRAIN_FULL = dict(steps=8, seq_len=512, batch=8, n_micro=2)
TRAIN_FULL_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=8)

# The mesh layer (phase mesh): granite_moe_1b at full width under the port's
# production (16, 16) mesh, a description whose 256 positions are the one
# card, so dp = 16 and every MoE layer routes 16 shards of consecutive
# tokens apart, each at its own capacity.  (a) One MoE layer, 4 x 512
# tokens, float32: the card's per-shard slots equal route_topk on the CPU
# from the card's logits, bit for bit; y within MESH_MOE_TOL x max|y| of the
# port's CPU apply_moe in the same context.  (b) Two bf16 prefills of 4 x
# 512 tokens through K3 (its launches counted), and the float32 check of
# pallas against chunked.  (c) Phase train's recipe (TRAIN_FULL) inside the
# context; the mesh step outside it equal to the mesh=None step bit for bit;
# a float32 smoke step inside it on the card against the CPU, at phase
# train's parity limits.
MESH_TOKENS = dict(batch=4, seq=512)
# K3 on granite_moe_1b's prefill, served and under the mesh: 4 prompts x 16
# heads, T 512, hd 64
K3_GRANITE = (MESH_TOKENS["batch"] * 16, MESH_TOKENS["seq"], 64)
MESH_MOE_TOL = 2e-4

# The device-plane weight broadcast (phase broadcast).  (a) granite_moe_1b's
# full weights, float32 drawn on the card from seed 0, as one bf16 image of
# 32 blocks (83,414,272 bytes each, no padding) streamed from position 0 to
# the 7 others of an (8, 1) mesh on one card, by every schedule; rounds,
# serialized bytes and bytes copied as reckoned from the JAX package's own
# round functions (allgather copies as implemented: its (8, n) gather, then
# row 0 to the 7 other positions; the int8 run adds 224 four-byte scale
# sends).  (b) granite_moe_1b's smoke config plus a 3-element leaf (so the
# image is padded) on a (4, 2) mesh and 4 blocks, card against CPU.
BCAST_MESH = (8, 1)
BCAST_BLOCKS = 32
BCAST_PARAMS = 1_334_628_352
BCAST_EXPECT = {  # (schedule, compress): (rounds, serialized bytes, bytes copied on one card)
    ("naive", False): (7, 18_684_796_928, 18_684_796_928),
    ("allgather", False): (1, 21_354_053_632, 40_038_850_560),
    ("binomial", False): (3, 8_007_770_112, 18_684_796_928),
    ("pipelined", False): (66, 5_505_341_952, 18_684_796_928),
    ("pipelined", True): (66, 2_752_670_976, 9_342_398_464 + 224 * 4),
}
BCAST_REPS = 5
BCAST_SMOKE = dict(mesh=(4, 2), n_blocks=4)
# one direction of an H100 SXM's NVLink 4 (900 GB/s bidirectional, data
# sheet): the link of the reference's serialized-bytes time model
H100_NVLINK_ONE_WAY = 450e9

# The dry runs (phase dryrun; no kernel: they trace `chunked`, as the
# reference lowers it).  (a) Three production cells traced on meta through
# launch/dryrun.py::run_cell on the (16, 16) mesh, each with its collective
# bytes by source (ZeRO-1, tensor-parallel), the tensor-parallel term > 0.
# (b) Three cells at the shapes the script already runs, on a (1, 1) mesh,
# bf16 params, `chunked`: the dry run's prediction beside a measured run on
# the card, whose FlopCounterMode FLOPs must equal the meta trace's and whose
# arguments' bytes must equal argument_size_in_bytes; then deepseek_7b's
# prefill and decode at those shapes on the (16, 16) mesh: the card's real
# step under the sharding tracker, its collective records equal to the meta
# trace's.  (c) The broadcast dry run of granite_moe_1b on both production
# meshes, every schedule.
DRYRUN_CELLS = (("granite_moe_1b", "train_4k"), ("deepseek_7b", "decode_32k"),
                ("mamba2_130m", "long_500k"))
DRYRUN_MEASURED = (  # arch, (shape name, seq_len, batch, kind), n_micro
    ("granite_moe_1b", ("train_8x512", TRAIN_FULL["seq_len"], TRAIN_FULL["batch"], "train"),
     TRAIN_FULL["n_micro"]),
    ("deepseek_7b", ("prefill_4x512", 512, 4, "prefill"), None),
    ("deepseek_7b", ("decode_4x1_cache1024", 1024, 4, "decode"), None),
)
DRYRUN_TRACKED = [shape for arch, shape, _ in DRYRUN_MEASURED if arch == "deepseek_7b"]
DRYRUN_REPS = 3
BCAST_DRYRUN = (("naive", False), ("allgather", False), ("binomial", False),
                ("pipelined", False), ("pipelined", True))

# Phase benches: the six scripts of benchmarks_torch/ at their defaults on the
# card, as (artifact, script, arguments), each held by compare.artifact_diff
# against the unchanged reference script's output in
# benchmarks_torch/reference/; bench_scale_1000 with --mega and without
# --giga, whose two tiers phases giga_tier and giga_replay drive, so those two
# subtrees of the reference's artifact are left out.  Then paper_figures.ALL
# at full size: the rows of Figures 11-18 equal to the reference's CSV;
# Figures 19 and 20 time and compress urandom block stores (held in the CPU
# tests with a seeded urandom).
BENCHES = (("scale", "bench_scale_1000", ["--mega"]), ("registry", "bench_registry_sweep", []),
           ("blocks", "bench_blocks", []), ("trace", "bench_trace_replay", []),
           ("placement", "bench_placement", []), ("serving", "bench_serving", []))
BENCH_SKIP = {"scale": ("giga_burst", "giga_replay")}
HELD_FIGURES = 8  # Figures 11-18 of paper_figures.ALL

# K2 and K4 are timed with a cold L2: each call rotates through operand sets
# that together exceed this, so no launch finds its operands in the 50 MB L2
# (a served decode step's other layers evict layer 0's cache the same way).
COLD_BYTES = 150e6

CAPS = dict(
    per_stream_cap=30e6,
    in_cap=1.25e8,
    decompress_rate=2e9,
    block_size=float(512 * 1024),
)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ----------------------------------------------------------------------
# comparisons and timing
# ----------------------------------------------------------------------
def bit_mismatch(got, want) -> tuple[int, float]:
    """(lanes whose float64 bits differ, max |got - want|); NaN == NaN."""
    import torch

    got, want = got.detach().cpu(), want.detach().cpu()
    check(got.shape == want.shape and got.dtype == want.dtype, "shape or dtype differs")
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    differ = (got.view(torch.int64) != want.view(torch.int64)) & ~(nan_g & nan_w)
    n = int(differ.sum())
    if n == 0:
        return 0, 0.0
    return n, float((got[differ] - want[differ]).abs().nan_to_num(float("inf")).max())


def seeded_front(n: int, seed: int, blk_mode: str):
    """Cap-chain operands with the engine's edge lanes: inf caps, NaN, blk."""
    rng = np.random.default_rng(seed)
    n_out = rng.integers(1, 50, n)
    n_in = rng.integers(1, 50, n)
    out_cap = rng.uniform(1e6, 2e9, n)
    qps = rng.uniform(100.0, 5000.0, n)
    par = rng.uniform(1e6, 2e8, n)
    out_cap[rng.random(n) < 0.1] = np.inf
    qps[rng.random(n) < 0.3] = np.inf
    par[rng.random(n) < 0.3] = np.inf
    if n > 3:
        out_cap[n // 3] = np.nan
        par[n // 2] = np.nan
    blk = rng.random(n) < 0.5 if blk_mode == "mixed" else np.zeros(n, dtype=bool)
    return n_out, n_in, out_cap, qps, par, blk


def numpy_front_rates(ops, caps) -> np.ndarray:
    """The engine's numpy ``_front_rates`` arithmetic on gathered operands."""
    n_out, n_in, out_cap, qps, par, blk = ops
    r = np.minimum(caps["per_stream_cap"], out_cap / n_out)
    np.minimum(r, caps["in_cap"] / n_in, out=r)
    np.minimum(r, caps["decompress_rate"], out=r)
    if blk.any():
        bi = np.flatnonzero(blk)
        r[bi] = np.minimum(r[bi], caps["block_size"] * qps[bi] / n_out[bi])
    return np.minimum(r, par)


def graph_ms(fn, reps: int = 200) -> float:
    """Device time per call: ``reps`` calls captured in a CUDA graph, replayed."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def rotation(fns):
    """A callable that calls ``fns`` in turn, one per call."""
    import itertools

    it = itertools.cycle(fns)
    return lambda: next(it)()


def cold_sets(set_bytes: float) -> int:
    """Operand sets to rotate through so that each launch finds its operands
    cold: together over ``COLD_BYTES``, so the other sets touched since a
    set's last launch exceed the 50 MB L2."""
    return max(3, -(-int(COLD_BYTES) // int(set_bytes)))


def event_ms(fn, iters: int = 200) -> float:
    """Per-call time of back-to-back eager calls, by CUDA events."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 200) -> float:
    for _ in range(10):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def patched(module, name: str, make):
    """Replace ``module.name`` by ``make(original)`` for the duration."""
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def record_engine(on_engine, module=None):
    """Hand every engine that ``module`` (``run_scale``'s by default) builds
    to ``on_engine`` before it runs."""
    from repro_torch.sim import scale

    def make_and_record(make):
        def run(cfg, **kw):
            sim = make(cfg, **kw)
            on_engine(sim)
            return sim
        return run

    return patched(module or scale, "make_sim", make_and_record)


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def phase_device() -> tuple[str, str]:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    return smi, name


def ptxas_summary(log: str) -> list:
    """Registers and spill bytes of each kernel in an ``nvcc -Xptxas -v`` log."""
    import re
    import shutil

    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            rows.append({"kernel": name})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and rows:
            rows[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            rows[-1]["registers"] = int(m.group(1))
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r["kernel"] for r in rows),
                               capture_output=True, text=True, timeout=60).stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                r["kernel"] = n.replace("(anonymous namespace)::", "").split("(")[0]
    return rows


def phase_build() -> list:
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build

    names = sorted(_build.LIBRARIES)
    fresh = {n: not _build.library_path(n).exists() for n in names}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, all at once
        paths = dict(zip(names, pool.map(_build.build, names)))
    for n in names:
        _build.library(n)
    ptxas = {n: ptxas_summary(_build.build_log_path(n).read_text()) for n in names
             if _build.build_log_path(n).exists()}
    k3 = k3_instances(paths["flash_attention"], ptxas["flash_attention"])
    k2 = [r for r in ptxas["cap_chain"] if "nic_flow_counts_kernel" in r["kernel"]]
    check(len(k2) == 1, f"K2 in the ptxas log: {k2}")
    k4 = k4_instances(paths["decode_attention"], ptxas["decode_attention"])
    k5 = k5_instances(paths["ssd_scan"], ptxas["ssd_scan"])
    emit("build", seconds=time.perf_counter() - t0, compiled=fresh,
         libraries={n: str(paths[n].relative_to(ROOT)) for n in names},
         nvcc_flags={n: " ".join(_build.LIBRARIES[n][1]) for n in names}, ptxas=ptxas,
         k3_instances=k3, k4_instances=k4, k5_instances=k5)
    return {"k2": k2[0], "k3": k3, "k4": k4, "k5": k5}


SASS_OPS = {"hmma": r"\bHMMA\b", "ldgsts": r"\bLDGSTS\b", "ldsm": r"\bLDSM\b"}
# K4's bf16 instance: bulk copies (cp.async.bulk), 16-byte shared loads, and
# the instructions it must not need
K4_SASS_OPS = {"ublkcp": r"\bUBLKCP\b", "lds_128": r"\bLDS(?:\.U)?\.128\b",
               "ldgsts": r"\bLDGSTS\b", "hmma": r"\bHMMA\b"}


def sass_counts(lib_path: Path, classify, ops: dict = SASS_OPS) -> dict | None:
    """Counts of the instructions ``ops`` (name -> regex over ``cuobjdump
    -sass`` lines) in each kernel of a library that ``classify`` maps to a
    key; None without cuobjdump."""
    import os
    import re
    import shutil

    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(cuobjdump):
        return None
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    counts, key = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            key = classify(m.group(1))
            if key:
                counts[key] = dict.fromkeys(ops, 0)
            continue
        if key:
            for name, pattern in ops.items():
                if re.search(pattern, line):
                    counts[key][name] += 1
    return counts


def k4_instance(kernel_name: str) -> int | None:
    """hd of a K4 bf16 tiled kernel from its demangled or mangled name."""
    import re

    m = re.search(r"decode_tiled_kernel(?:<|ILi)(\d+)", kernel_name)
    return int(m.group(1)) if m else None


def k4_instances(lib_path: Path, ptxas: list) -> list:
    """Registers and spills (ptxas) and bulk-copy, LDS.128, LDGSTS and HMMA
    counts (``cuobjdump -sass``) of every K4 bf16 instance.  Each must issue
    bulk copies and 16-byte shared loads, and the instances at hd 64 and 128
    must not spill."""
    from repro_torch.kernels.decode_attention import SUPPORTED_HD

    rows = {}
    for r in ptxas:
        hd = k4_instance(r["kernel"])
        if hd:
            rows[hd] = {"hd": hd, "registers": r.get("registers"),
                        "spill_stores": r.get("spill_stores"), "spill_loads": r.get("spill_loads")}
    check(sorted(rows) == sorted(SUPPORTED_HD), f"K4 instances in the ptxas log: {sorted(rows)}")
    counts = sass_counts(lib_path, k4_instance, K4_SASS_OPS)
    if counts is not None:
        for hd, c in counts.items():
            rows[hd].update(c)
        for hd, r in rows.items():
            check(r.get("ublkcp", 0) > 0 and r.get("lds_128", 0) > 0, f"K4 bf16 hd {hd} SASS: {r}")
    for hd in (64, 128):
        r = rows[hd]
        check(r["spill_stores"] == 0 and r["spill_loads"] == 0, f"K4 bf16 hd {hd} spills: {r}")
    return [rows[hd] for hd in sorted(rows)]


def k3_instance(kernel_name: str) -> tuple[str, int] | None:
    """(dtype, hd) of a K3 kernel from its demangled or mangled name."""
    import re

    m = re.search(r"flash_attention_mma_kernel(?:<|ILi)(\d+)", kernel_name)
    if m:
        return "bfloat16", int(m.group(1))
    m = re.search(r"flash_attention_kernel(?:<|ILi)(\d+)", kernel_name)
    return ("float32", int(m.group(1))) if m else None


def k3_instances(lib_path: Path, ptxas: list) -> list:
    """Registers and spills (ptxas) and tensor-core, async-copy and ldmatrix
    instruction counts (``cuobjdump -sass``) of every K3 instance.  The bf16
    instances must issue HMMA and LDGSTS, the float32 ones no HMMA, and the
    bf16 instances at hd 64 and 128 must not spill."""
    from repro_torch.kernels.flash_attention import SUPPORTED_HD

    rows = {}
    for r in ptxas:
        key = k3_instance(r["kernel"])
        if key:
            rows[key] = {"dtype": key[0], "hd": key[1], "registers": r.get("registers"),
                         "spill_stores": r.get("spill_stores"), "spill_loads": r.get("spill_loads")}
    check(len(rows) == 2 * len(SUPPORTED_HD), f"K3 instances in the ptxas log: {sorted(rows)}")
    counts = sass_counts(lib_path, k3_instance)
    if counts is not None:
        for key, c in counts.items():
            rows[key].update(c)
        for (dt, hd), r in rows.items():
            if dt == "bfloat16":
                check(r.get("hmma", 0) > 0 and r.get("ldgsts", 0) > 0, f"K3 bf16 hd {hd} SASS: {r}")
            else:
                check(r.get("hmma", 1) == 0, f"K3 f32 hd {hd} SASS has HMMA: {r}")
    for hd in (64, 128):
        r = rows[("bfloat16", hd)]
        check(r["spill_stores"] == 0 and r["spill_loads"] == 0, f"K3 bf16 hd {hd} spills: {r}")
    return sorted(rows.values(), key=lambda r: (r["dtype"], r["hd"]))


def k5_instance(kernel_name: str) -> tuple[str, str, int, int] | None:
    """(dtype, pass, P, N) of a K5 pass-1 or pass-3 kernel from its demangled
    or mangled name."""
    import re

    m = re.search(r"ssd_chunk_(state|scan)_(mma|simt)(?:<|ILi)(\d+)(?:, |ELi)(\d+)", kernel_name)
    if not m:
        return None
    return ("bfloat16" if m.group(2) == "mma" else "float32", m.group(1), int(m.group(3)),
            int(m.group(4)))


def k5_instances(lib_path: Path, ptxas: list) -> list:
    """Registers, spills and SASS counts of every K5 pass-1 and pass-3
    instance.  The bf16 instances must issue HMMA and LDGSTS, the float32
    ones no HMMA, and the bf16 instances at P 64, N 128 must not spill."""
    from repro_torch.kernels.ssd_scan import SUPPORTED_N, SUPPORTED_P

    rows = {}
    for r in ptxas:
        key = k5_instance(r["kernel"])
        if key:
            rows[key] = {"dtype": key[0], "pass": key[1], "p": key[2], "n": key[3],
                         "registers": r.get("registers"), "spill_stores": r.get("spill_stores"),
                         "spill_loads": r.get("spill_loads")}
    want = 2 * 2 * len(SUPPORTED_P) * len(SUPPORTED_N)
    check(len(rows) == want, f"K5 instances in the ptxas log: {len(rows)} of {want}")
    counts = sass_counts(lib_path, k5_instance)
    if counts is not None:
        for key, c in counts.items():
            rows[key].update(c)
        for key, r in rows.items():
            if key[0] == "bfloat16":
                check(r.get("hmma", 0) > 0 and r.get("ldgsts", 0) > 0, f"K5 bf16 {key} SASS: {r}")
            else:
                check(r.get("hmma", 1) == 0, f"K5 f32 {key} SASS has HMMA: {r}")
    for stage in ("state", "scan"):
        r = rows[("bfloat16", stage, 64, 128)]
        check(r["spill_stores"] == 0 and r["spill_loads"] == 0, f"K5 bf16 {stage} P 64 N 128 spills: {r}")
    return sorted(rows.values(), key=lambda r: (r["dtype"], r["pass"], r["p"], r["n"]))


def phase_kernels_vs_plain() -> float:
    import torch

    from repro_torch.kernels import cap_chain as cc
    from repro_torch.kernels import moe_route

    worst = 0.0
    for n in (1, 255, 257, 901, 100_000):
        for blk_mode in ("mixed", "none"):
            ops = seeded_front(n, seed=n, blk_mode=blk_mode)
            dev = [torch.from_numpy(a).cuda() for a in ops]
            got = cc.cap_chain_rates(*dev, **CAPS)
            torch.cuda.synchronize()
            for ref_name, want in (
                ("plain", cc.cap_chain_rates_torch(*dev, **CAPS)),
                ("numpy", torch.from_numpy(numpy_front_rates(ops, CAPS))),
            ):
                bad, err = bit_mismatch(got, want)
                check(bad == 0, f"K1 vs {ref_name} at n={n} blk={blk_mode}: {bad} lanes, max err {err}")
                worst = max(worst, err)
    rng = np.random.default_rng(7)
    k2_cases = {  # every lane of a warp in one match group; sorted; random; odd n; n = 1
        "one_nic": np.full(100_000, 7), "sorted": np.sort(rng.integers(0, 1000, 100_001)),
        "random": rng.integers(0, 1000, 100_000), "odd": rng.integers(0, 1000, 999),
        "one_flow": np.array([999]), "offset_view": rng.integers(0, 1000, 4098)}
    for name, ids in k2_cases.items():
        nodes = torch.from_numpy(ids).cuda()
        if name == "offset_view":  # 8 bytes past a 16-byte boundary: the peeled head
            nodes = nodes[1:]
        got = cc.nic_flow_counts(nodes, 1000)
        check(torch.equal(got, cc.nic_flow_counts_torch(nodes, 1000)), f"K2 vs plain, {name}")
        check(torch.equal(got, torch.bincount(nodes, minlength=1000)), f"K2 vs bincount, {name}")
    moe_dropped = {}
    for name, (l, n, e, k, cap, skew) in MOE_ROUTE_CASES.items():
        ids = moe_route_ids(l, n, e, k, skew)
        got = moe_route.expert_slots(ids, e, cap)
        torch.cuda.synchronize()
        want = moe_route.expert_slots_torch(ids, e, cap)
        check(torch.equal(got, want), f"expert slots vs plain, {name}: "
              f"{int((got != want).sum())} of {got.numel()} differ")
        moe_dropped[name] = int((got == e * cap).sum())
    emit("kernels_vs_plain", k1_widths=[1, 255, 257, 901, 100_000], k1_bit_identical=True,
         k1_max_abs_err=worst, k2_exact=True, k2_cases=sorted(k2_cases),
         moe_route_exact=True, moe_route_cases=MOE_ROUTE_CASES, moe_route_dropped=moe_dropped)
    return worst


def moe_route_ids(l: int, n: int, e: int, k: int, skew: bool):
    """(L, n, k) int32 expert ids on the card, k distinct a token, as top-k
    gives them; with ``skew`` every token's are 0..k-1."""
    import torch

    if skew:
        return torch.arange(k, dtype=torch.int32, device="cuda").expand(l, n, k).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(n + e)
    return torch.rand((l, n, e), generator=gen, device="cuda").topk(k, dim=-1).indices.to(torch.int32)


def k2_plan_stats(src: np.ndarray) -> dict:
    """What contention K2 meets on a plan's source NICs, and the atomics its
    kernel issues: one per run of equal ids in each aligned window of 32
    consecutive flows (a warp's 64 ids, as two halves; the array starts
    16-byte aligned, as a fresh allocation does), plus one for an odd tail."""
    def runs(rows: np.ndarray) -> np.ndarray:  # runs of equal values >= 0 per row
        return (rows[:, :1] >= 0).sum(1) + ((rows[:, 1:] != rows[:, :-1]) & (rows[:, 1:] >= 0)).sum(1)

    n = src.size
    per_nic = np.bincount(src)
    distinct32 = runs(np.sort(src[:32 * (n // 32)].reshape(-1, 32), axis=1))
    paired = src[:2 * (n // 2)]
    windows = np.concatenate([paired, np.full(-len(paired) % 32, -1)]).reshape(-1, 32)
    atomics = int(runs(windows).sum()) + n % 2
    return {"max_flows_per_nic": int(per_nic.max()), "source_nics": int((per_nic > 0).sum()),
            "distinct_per_32_mean": float(distinct32.mean()),
            "distinct_per_32_median": float(np.median(distinct32)),
            "atomics": int(atomics), "atomics_per_flow": atomics / n}


def run_tier(cfg):
    import torch

    from repro_torch.kernels import cap_chain as cc
    from repro_torch.sim import run_scale

    cc.reset_launches()
    t0 = time.perf_counter()
    res = run_scale(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, cc.cap_chain_rates.launches, cc.nic_flow_counts.launches


def phase_paper_tier(bench: dict) -> dict:
    from repro_torch.sim import ScaleConfig, WaveConfig, run_scale

    shape = dict(n_vms=1000, n_functions=5, containers_per_function=500, churn_ops=100, seed=0)
    res, wall, k1, k2 = run_tier(ScaleConfig(**shape, wave=WaveConfig(engine="vector_torch", device="cuda")))
    ds = res.dispatch_stats
    check(res.provision_makespan == PAPER_MAKESPAN, f"paper makespan {res.provision_makespan!r}")
    check(res.provision_makespan == bench["provision_makespan_s"], "paper makespan vs BENCH_scale.json")
    check(res.per_function == bench["per_function_makespan_s"], "paper per_function vs BENCH_scale.json")
    check(k1 == ds["fronts_torch"] == ds["fronts_vector"] > 0, f"paper launches {k1} vs {ds}")
    vec = run_scale(ScaleConfig(**shape, wave=WaveConfig(engine="vector")))
    check(res.per_function == vec.per_function and res.trace == vec.trace, "paper tier vs numpy vector engine")
    wide, _, k1_wide, _ = run_tier(ScaleConfig(
        **shape, wave=WaveConfig(engine="vector_torch", device="cuda", vector_scalar_cutoff=0)))
    dw = wide.dispatch_stats
    check(wide.provision_makespan == res.provision_makespan and wide.per_function == res.per_function
          and wide.trace == res.trace, "paper tier changed with vector_scalar_cutoff=0")
    check(k1_wide == dw["fronts_torch"] == dw["fronts_vector"] > 0 and dw["fronts_scalar"] == 0,
          f"cutoff-0 launches {k1_wide} vs {dw}")
    small = ScaleConfig(n_vms=32, n_functions=4, containers_per_function=8, churn_ops=5, seed=3,
                        wave=WaveConfig(engine="vector_torch", device="cuda"))
    sres, _, _, _ = run_tier(small)
    digest = hashlib.sha256("\n".join(f"{t!r} {e}" for t, e in sres.trace).encode()).hexdigest()
    check(digest == SMALL_SHA, f"small-config event-log SHA {digest}")
    out = dict(provision_makespan=res.provision_makespan, wall_s=wall, engine_wall_s=res.wall_s,
               events=res.events, events_per_s=res.events_per_s,
               fronts_torch=ds["fronts_torch"], flows_torch=ds["flows_torch"],
               k1_launches=k1, k2_launches=k2, cutoff0_fronts_torch=dw["fronts_torch"],
               cutoff0_launches=k1_wide, small_sha_ok=True)
    emit("paper_tier", **out)
    return out


def phase_giga_tier(bench: dict) -> dict:
    import torch

    from repro_torch.kernels import cap_chain as cc
    from repro_torch.sim import giga_burst_config

    engines, fronts = [], {}

    def on_engine(sim):
        engines.append(sim)
        rate = sim._front_rates

        def recording(fids, src, dst):
            # keep the operands of the widest front and of the front nearest
            # the mean width, for the timing phase
            w = int(fids.size)
            best = fronts.get("mean")
            # (copies: the operands are views that the next front overwrites)
            if w > fronts.get("widest", (0,))[0]:
                fronts["widest"] = (w, tuple(a.copy() for a in sim._front_operands(fids, src, dst)))
            if best is None or abs(w - GIGA_MEAN_WIDTH) < abs(best[0] - GIGA_MEAN_WIDTH):
                fronts["mean"] = (w, tuple(a.copy() for a in sim._front_operands(fids, src, dst)))
            return rate(fids, src, dst)

        sim._front_rates = recording

    cfg = giga_burst_config()
    check(cfg.wave.engine == "vector_torch" and cfg.wave.device == "cuda", "giga tier defaults")
    with record_engine(on_engine):
        res, wall, k1, k2 = run_tier(cfg)
    ds = res.dispatch_stats
    check(res.provision_makespan == GIGA_MAKESPAN, f"giga makespan {res.provision_makespan!r}")
    check(res.per_function == bench["per_function_makespan_s"], "giga per_function vs BENCH_scale.json")
    check(ds["fronts_torch"] == ds["fronts_vector"] == GIGA_FRONTS, f"giga fronts {ds}")
    check(ds["flows_torch"] == ds["flows_vector"] == GIGA_FLOWS, f"giga flows {ds}")
    check(k1 == GIGA_FRONTS, f"giga K1 launches {k1}")
    (sim,) = engines
    # K2 on the tier's real plan: the source NIC of every one of its flows.
    n_flows, n_nodes = len(sim._flows), len(sim._nname)
    nodes = torch.from_numpy(sim._fsrc[:n_flows].copy()).cuda()
    got = cc.nic_flow_counts(nodes, n_nodes)
    check(torch.equal(got, cc.nic_flow_counts_torch(nodes, n_nodes)), "K2 vs plain on the giga plan")
    check(np.array_equal(got.cpu().numpy(), np.bincount(sim._fsrc[:n_flows], minlength=n_nodes)),
          "K2 vs numpy bincount on the giga plan")
    k2_stats = k2_plan_stats(sim._fsrc[:n_flows].copy())
    del sim, engines[:]
    # The same tier on the host-only numpy engine, on the same machine, in
    # turns (card, numpy, numpy, card): the card tier's cost or gain end to
    # end, and more exact comparisons.
    vecs = [run_tier(giga_burst_config(engine="vector"))[0] for _ in range(2)]
    again = run_tier(giga_burst_config())[0]
    for other in vecs + [again]:
        check(other.per_function == res.per_function, "giga tier vs numpy vector engine, or a rerun")
    vec = vecs[0]
    engine_walls = [res.wall_s, again.wall_s]
    vector_walls = [v.wall_s for v in vecs]
    out = dict(provision_makespan=res.provision_makespan, wall_s=wall, engine_wall_s=res.wall_s,
               build_s=res.build_s, events=res.events, events_per_s=res.events_per_s,
               n_flows=res.n_flows, fronts_torch=ds["fronts_torch"], flows_torch=ds["flows_torch"],
               fronts_scalar=ds["fronts_scalar"], k1_launches=k1, k2_launches=k2,
               mean_front=fronts["mean"][0], widest_front=fronts["widest"][0], k2_nodes=n_nodes,
               k2_plan=k2_stats,
               vector_engine_wall_s=vec.wall_s, engine_walls_abba_s=engine_walls,
               vector_engine_walls_abba_s=vector_walls,
               engine_minus_vector_engine_wall_s=(sum(engine_walls) - sum(vector_walls)) / 2,
               vector_build_s=vec.build_s, vector_events_per_s=vec.events_per_s)
    emit("giga_tier", **out)
    return out | {"fronts": fronts, "k2_nodes_tensor": nodes}


def replay_3t_cfg(kind: str, cutoff: int):
    """The configs of the two replay goldens (``_three_tenant_cfg("exclusive")``
    and ``_serving_3t_cfg()`` in the JAX package's tests), on ``vector_torch``
    on the card."""
    from repro_torch.sim import (MultiTenantConfig, ServingConfig, TenantConfig, WaveConfig,
                                 constant_trace, diurnal_trace, synthetic_gaming_trace)

    dur = (4 if kind == "exclusive" else 3) * 60
    return MultiTenantConfig(
        tenants=[TenantConfig("gaming", synthetic_gaming_trace()[600:600 + dur], seed=1),
                 TenantConfig("diurnal", diurnal_trace(duration_s=dur, phase_s=300), seed=2),
                 TenantConfig("steady", constant_trace(duration_s=dur), seed=3)],
        system="faasnet", vm_pool_size=250, idle_reclaim_s=120.0,
        placement="exclusive" if kind == "exclusive" else "shared", check_partition=True,
        serving=ServingConfig() if kind == "serving" else None,
        wave=WaveConfig(engine="vector_torch", device="cuda", vector_scalar_cutoff=cutoff))


def stream_hash(res) -> str:
    """SHA-256 of the per-tenant TickStats streams (GOLDEN_EXCLUSIVE_3T's)."""
    lines = [f"{fid} {ts!r}" for fid in sorted(res.timelines) for ts in res.timelines[fid]]
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


def response_hash(rep) -> str:
    """SHA-256 of the per-tenant response streams (GOLDEN_SERVING_3T's)."""
    lines = [f"{ts.cfg.function_id} {t!r} {lat!r}" for ts in rep.tenants for t, lat in ts.responses]
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


def run_replay(cfg):
    """One ``MultiTenantReplay`` run: (replay, result, wall s, K1 launches)."""
    import torch

    from repro_torch.kernels import cap_chain as cc
    from repro_torch.sim import MultiTenantReplay

    cc.reset_launches()
    t0 = time.perf_counter()
    rep = MultiTenantReplay(cfg)
    res = rep.run()
    torch.cuda.synchronize()
    return rep, res, time.perf_counter() - t0, cc.cap_chain_rates.launches


def phase_replay_goldens() -> dict:
    out = {}
    for kind, golden in (("exclusive", GOLDEN_EXCLUSIVE_3T), ("serving", GOLDEN_SERVING_3T)):
        for cutoff in (64, 0):
            rep, res, wall, k1 = run_replay(replay_3t_cfg(kind, cutoff))
            digest = stream_hash(res) if kind == "exclusive" else response_hash(rep)
            check(digest == golden, f"{kind} replay golden at cutoff {cutoff}: {digest}")
            ds = rep.sim.dispatch_stats
            check(k1 == ds["fronts_torch"] == ds["fronts_vector"], f"{kind} cutoff {cutoff}: {k1} vs {ds}")
            if cutoff == 0:
                check(k1 > 0 and ds["fronts_scalar"] == 0, f"{kind} cutoff 0: {k1} vs {ds}")
            out[f"{kind}_{cutoff}"] = dict(wall_s=wall, k1_launches=k1, fronts_scalar=ds["fronts_scalar"],
                                           flows_torch=ds["flows_torch"])
    emit("replay_goldens", **out)
    return out


def replay_counts(cfg, res) -> dict:
    """``giga_replay``'s keys of ``BENCH_scale.json``, computed as the JAX
    package's ``benchmarks/bench_scale_1000.py`` computes them."""
    tenants = res.per_tenant.values()
    return dict(n_tenants=len(cfg.tenants), vm_pool_size=cfg.vm_pool_size, duration_s=cfg.duration_s(),
                serving=cfg.serving is not None, blocks=cfg.images is not None,
                requests=sum(t.requests for t in tenants), completed=sum(t.completed for t in tenants),
                cold_starts=res.cold_starts, failovers=res.failovers, prov_makespan_s=res.prov_makespan_s,
                peak_registry_egress_gbps=res.peak_registry_egress * 8 / 1e9, vm_hours=res.vm_hours(),
                worst_p99_response_s=max(t.p99_response_s for t in tenants),
                peak_nic_utilization=res.peak_nic_utilization)


def phase_giga_replay(bench: dict) -> dict:
    import dataclasses

    from repro_torch.sim import multi_tenant
    from repro_torch.sim.scale import giga_replay_config

    def run(engine: str) -> dict:
        """One giga replay on ``engine``, with the host seconds its wide
        fronts spent in ``_front_rates`` (K1's route on ``vector_torch``,
        numpy's on ``vector``)."""
        engines, front_s = [], [0.0]

        def on_engine(sim):
            engines.append(sim)
            rate = sim._front_rates

            def timed(fids, src, dst):
                t0 = time.perf_counter()
                out = rate(fids, src, dst)
                front_s[0] += time.perf_counter() - t0
                return out

            sim._front_rates = timed

        cfg = giga_replay_config(0, engine=engine)
        gc.collect()  # no run pays for the garbage of the phases and runs before it
        with record_engine(on_engine, multi_tenant):
            rep, res, wall, k1 = run_replay(cfg)
        (sim,) = engines
        check(sim is rep.sim, "the replay's engine was not recorded")
        # keep the streams, not the replay: the next run should not find
        # this one's 100,000-VM state alive
        streams = [(ts.cfg.function_id, ts.timeline, ts.responses, ts.prov_latencies)
                   for ts in rep.tenants]
        return dict(cfg=cfg, res=res, streams=streams, wall=wall, k1=k1, front_s=front_s[0],
                    ds=dict(sim.dispatch_stats), engine=type(sim).__name__)

    default = giga_replay_config(0).wave
    check(default.engine == "vector_torch" and default.device == "cuda", "giga replay defaults")
    # in turns (card, numpy, numpy, card): the card engine's cost or gain end
    # to end, and more exact comparisons
    card, vec, vec2, card2 = (run(e) for e in ("vector_torch", "vector", "vector", "vector_torch"))
    k1, ds = card["k1"], card["ds"]
    check(card["engine"] == "VectorTorchFlowSim" and vec["engine"] == "VectorFlowSim", "replay engines")
    check(k1 > 0, "K1 never launched in the giga replay")
    for c in (card, card2):
        check(c["k1"] == c["ds"]["fronts_torch"] == c["ds"]["fronts_vector"] == k1,
              f"giga replay launches {c['k1']} vs {c['ds']}")
    for v in (vec, vec2):
        check(v["k1"] == 0, f"the numpy engine launched K1 {v['k1']} times")
    # every field of the results, their timelines and response streams
    res = card["res"]
    for other in (vec, vec2, card2):
        for f in dataclasses.fields(res):
            check(getattr(res, f.name) == getattr(other["res"], f.name),
                  f"giga replay {f.name}: {other['engine']} run differs")
        for a, b in zip(card["streams"], other["streams"], strict=True):
            check(a == b, f"{a[0]} streams: {other['engine']} run differs")
    got = replay_counts(card["cfg"], res)
    for key in REPLAY_KEYS:
        check(got[key] == bench[key], f"giga replay {key} {got[key]!r} vs BENCH_scale.json {bench[key]!r}")
    base = {k: v for k, v in ds.items() if k not in ("fronts_torch", "flows_torch")}
    check(base == vec["ds"], "giga replay dispatch_stats vs numpy")
    walls, vwalls = [card["wall"], card2["wall"]], [vec["wall"], vec2["wall"]]
    out = dict(wall_s=card["wall"], vector_wall_s=vec["wall"], walls_abba_s=walls,
               vector_walls_abba_s=vwalls, wall_minus_vector_wall_s=(sum(walls) - sum(vwalls)) / 2,
               front_s_abba=[card["front_s"], card2["front_s"]],
               vector_front_s_abba=[vec["front_s"], vec2["front_s"]],
               k1_launches=k1, dispatch_stats=ds, counts=got, equal_to_bench=list(REPLAY_KEYS))
    emit("giga_replay", **out)
    return out


def time_k1(ops) -> dict:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import cap_chain as cc

    n = ops[0].size
    dev = [torch.from_numpy(a).cuda() for a in ops]
    rate = torch.empty(n, dtype=torch.float64, device="cuda")
    lib = _build.library("cap_chain")
    ptrs = [t.data_ptr() for t in dev]

    def launch():
        rc = lib.repro_cap_chain_rates(*ptrs, rate.data_ptr(), n, *CAPS.values(),
                                       torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"K1 launch returned {rc}")

    def wrapper_path():  # the tensor route: six copies, the wrapper, a copy back
        put = [torch.from_numpy(a).to("cuda") for a in ops]
        return cc.cap_chain_rates(*put, **CAPS).cpu().numpy()

    # the engine's route: the front laid out once in the packed pinned buffer
    # (the engine gathers into it), then one call: copy in, K1, copy back
    staging = cc.CapChainStaging("cuda")
    for view, a in zip(staging.segments(n), ops):
        view[...] = a

    def front_path():
        return staging.rates(**CAPS)

    out = dict(
        n=n,
        ms=graph_ms(launch),
        plain_ms=graph_ms(lambda: cc.cap_chain_rates_torch(*dev, **CAPS)),
        front_ms=host_ms(front_path),
        wrapper_ms=host_ms(wrapper_path),
        numpy_ms=host_ms(lambda: numpy_front_rates(ops, CAPS)),
    )
    want = torch.from_numpy(numpy_front_rates(ops, CAPS))
    check(bit_mismatch(torch.from_numpy(wrapper_path()), want)[0] == 0,
          "K1's tensor route on a recorded giga front vs numpy")
    check(bit_mismatch(torch.from_numpy(front_path()), want)[0] == 0,
          "K1's packed route on a recorded giga front vs numpy")
    # 49 bytes a flow (two int64 counts, three doubles, one byte of blk read;
    # one double written); 12 fp64 operations a flow (two conversions,
    # three divisions, one product, six minima)
    out["bound_ms"], out["bound_by"] = bound_ms(49 * n, 12 * n, FP64_OPS_PER_S)
    return out


def time_k2(nodes, n_nodes: int) -> dict:
    """K2 on the giga plan with a cold L2 (a rotation of copies of the node
    ids, each with its own counts), ``counts.zero_()`` inside each timed
    call, and warm; the plain version and ``torch.bincount`` over the same
    rotation."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import cap_chain as cc

    n = nodes.numel()
    nsets = cold_sets(8 * n + 8 * n_nodes)
    sets = [(nodes.clone(), torch.zeros(n_nodes, dtype=torch.int64, device="cuda"))
            for _ in range(nsets)]
    lib = _build.library("cap_chain")

    def call(ids, counts):
        def launch():
            counts.zero_()
            rc = lib.repro_nic_flow_counts(ids.data_ptr(), n, counts.data_ptr(),
                                           torch.cuda.current_stream().cuda_stream)
            check(rc == 0, f"K2 launch returned {rc}")
        return launch

    launches = [call(*st) for st in sets]
    reps = nsets * 10
    cold_ms = graph_ms(rotation(launches), reps)
    want = torch.bincount(nodes, minlength=n_nodes)
    for ids, counts in sets[:2]:
        check(torch.equal(counts, want), "K2 timed output vs bincount")
    ones = torch.ones_like(nodes)

    def plain(ids):  # nic_flow_counts_torch without its host-side range check
        return lambda: torch.zeros(n_nodes, dtype=torch.int64, device="cuda").index_add_(0, ids, ones)

    out = dict(
        n=n, n_nodes=n_nodes, cold_sets=nsets, ms=cold_ms,
        warm_ms=graph_ms(launches[0], reps=100),
        plain_ms=graph_ms(rotation([plain(ids) for ids, _ in sets]), reps),
        wrapper_ms=event_ms(rotation([lambda ids=ids: cc.nic_flow_counts(ids, n_nodes)
                                      for ids, _ in sets]), iters=reps),
        library_ms=event_ms(rotation([lambda ids=ids: torch.bincount(ids, minlength=n_nodes)
                                      for ids, _ in sets]), iters=reps),
    )
    # read each int64 index once, write each int64 count once; one add a flow
    out["bound_ms"], out["bound_by"] = bound_ms(8 * n + 8 * n_nodes, n, INT32_OPS_PER_S)
    del sets
    return out


def k3_operands(bh: int, t: int, hd: int, dtype: str, seed: int):
    """q, k, v on the card: numpy normal draws rounded once to ``dtype``."""
    import torch

    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((bh, t, hd), dtype=np.float32))
            .to(device="cuda", dtype=getattr(torch, dtype)) for _ in range(3)]


def phase_k3_vs_plain() -> dict:
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_tiled_ref

    worst, worst_tiled, per_shape = {}, 0.0, []
    # the served shapes in bf16: granite_moe_1b's prefill (served and under
    # the mesh), whisper_medium's decoder prefill (one q tile against one
    # diagonal k tile) and deepseek_7b's, last
    served = {"granite_moe_1b": (*K3_GRANITE, None), "whisper_medium": (*K3_WHISPER, None)}
    cases = [(shape, dt) for dt in ("bfloat16", "float32") for shape in K3_SWEEP]
    cases += [(shape, "bfloat16") for shape in served.values()] + [(K3_SERVE, "bfloat16")]
    for (bh, t, hd, window), dt in cases:
        name = f"{(bh, t, hd, window)} {dt}"
        q, k, v = k3_operands(bh, t, hd, dt, seed=bh * 1000 + t + hd)
        got = fa.flash_attention_bhtd(q, k, v, scale=hd**-0.5, window=window)
        torch.cuda.synchronize()
        want = fa.flash_attention_torch(q, k, v, scale=hd**-0.5, window=window)
        check(got.dtype == q.dtype and got.shape == q.shape, f"K3 output at {name}")
        check(bool(torch.isfinite(got).all()), f"K3 non-finite at {name}")
        err = float((got.float() - want.float()).abs().max())
        check(err <= K3_TOL[dt], f"K3 vs plain at {name}: max err {err}")
        row = {"bh": bh, "t": t, "hd": hd, "window": window, "dtype": dt, "max_abs_err": err}
        if dt == "bfloat16":
            ok, _ = within(got, want, *K3_REL)
            check(ok, f"K3 vs plain at {name}: beyond {K3_REL[0]} + {K3_REL[1]} |want|")
            tiled = flash_attention_tiled_ref(q, k, v, scale=hd**-0.5, window=window)
            ok, err_tiled = within(got, tiled, *K3_TILED)
            check(ok, f"K3 vs the tiled version at {name}: max err {err_tiled}")
            row["max_abs_err_vs_tiled"] = err_tiled
            worst_tiled = max(worst_tiled, err_tiled)
        worst[dt] = max(worst.get(dt, 0.0), err)
        per_shape.append(row)
    emit("k3_vs_plain", tolerances=K3_TOL, rel_bound=K3_REL, tiled_bound=K3_TILED, worst=worst,
         worst_vs_tiled=worst_tiled, shapes=per_shape)
    rows = {(r["bh"], r["t"], r["hd"], r["window"], r["dtype"]): r for r in per_shape}
    out = {"worst": worst, "serve_err": per_shape[-1]["max_abs_err"]}
    for arch, shape in served.items():
        row = rows[(*shape, "bfloat16")]
        out[arch] = {"max_abs_err": row["max_abs_err"],
                     "max_abs_err_vs_tiled": row["max_abs_err_vs_tiled"]}
    return out


def within(got, want, atol: float, rtol: float) -> tuple[bool, float]:
    """(|got - want| <= atol + rtol |want| everywhere, max |got - want|), in float32."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return bool((diff <= atol + rtol * w.abs()).all()), float(diff.max())


def k4_operands(bh: int, s: int, hd: int, dtype: str, seed: int):
    """q (BH, 1, hd), k and v (BH, S, hd) on the card: numpy normal draws."""
    import torch

    rng = np.random.default_rng(seed)
    shapes = [(bh, 1, hd), (bh, s, hd), (bh, s, hd)]
    return [torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
            .to(device="cuda", dtype=getattr(torch, dtype)) for sh in shapes]


def phase_k4_vs_plain() -> dict:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import decode_attention_tiled_ref

    worst, per_case = {}, []

    def run(name, q, k, v, valid, dt):
        scale = q.shape[-1] ** -0.5
        got = da.decode_attention_bhsd(q, k, v, valid, scale=scale)
        torch.cuda.synchronize()
        want = da.decode_attention_torch(q, k, v, valid, scale=scale)
        check(got.dtype == q.dtype and got.shape == q.shape, f"K4 output at {name}")
        check(bool(torch.isfinite(got).all()), f"K4 non-finite at {name} {dt}")
        ok, err = within(got, want, K4_TOL[dt], K4_TOL[dt])
        check(ok, f"K4 vs plain at {name} {dt}: max err {err}")
        worst[dt] = max(worst.get(dt, 0.0), err)
        per_case.append({"case": name, "bh": q.shape[0], "s": k.shape[1], "hd": q.shape[2],
                         "dtype": dt, "max_abs_err": err})
        return got

    for dt in ("bfloat16", "float32"):
        for s, upto in K4_SWEEP:
            q, k, v = k4_operands(8, s, 64, dt, seed=s)
            # through ops.decode_attention with a 1-D valid, as tests/test_kernels.py
            valid = (torch.arange(s, device="cuda") <= upto).to(torch.int32)
            got = ops.decode_attention(q.view(2, 4, 1, 64), k.view(2, 4, s, 64),
                                       v.view(2, 4, s, 64), valid, scale=0.125)
            run(f"sweep S={s} valid<={upto}", q, k, v, valid[None].expand(8, s).contiguous(), dt)
            check(torch.equal(got.view(8, 1, 64), da.decode_attention_bhsd(
                q, k, v, valid[None].expand(8, s).contiguous(), scale=0.125)),
                f"ops.decode_attention vs the wrapper at S={s}")
        # rows 1 and 5 have no valid slot: the uniform mean of v, finite
        q, k, v = k4_operands(8, 1024, 64, dt, seed=3)
        valid = torch.from_numpy(np.random.default_rng(3).random((8, 1024)) < 0.3).to(
            device="cuda", dtype=torch.int32)
        valid[1] = 0
        valid[5] = 0
        got = run("no-valid-slot rows 1, 5", q, k, v, valid, dt)
        for r in (1, 5):
            ok, err = within(got[r, 0], v[r].float().mean(0), K4_TOL[dt], K4_TOL[dt])
            check(ok, f"K4 no-valid row {r} vs the mean of v: {err}")
    # every head dim of the bf16 tiled instance (and the float32 instance at
    # the same hd) on prefix, ring and scattered masks; bf16 also against
    # decode_attention_tiled_ref
    worst_tiled = 0.0
    for hd in da.SUPPORTED_HD:
        for dt in ("bfloat16", "float32"):
            for kind in ("prefix", "ring", "scattered"):
                q, k, v = k4_operands(32, 1024, hd, dt, seed=hd)
                valid = k4_mask(kind, 32, 1024, seed=hd)
                got = run(f"{kind} hd {hd}", q, k, v, valid, dt)
                if dt == "bfloat16":
                    tiled = decode_attention_tiled_ref(q, k, v, valid, scale=hd**-0.5)
                    ok, err = within(got, tiled, *K4_TILED)
                    check(ok, f"K4 vs the tiled version, {kind} hd {hd}: max err {err}")
                    worst_tiled = max(worst_tiled, err)
    # NaN in k and v of every tile with no valid key, in rows that have one:
    # the output must be finite and equal the plain version on the same
    # operands with those slots zeroed (such tiles are never read)
    nan_rows = []
    for hd in da.SUPPORTED_HD:
        q, k, v = k4_operands(128, 1024, hd, "bfloat16", seed=3 * hd)
        valid = k4_mask("ring", 128, 1024, seed=hd)
        dead = (~valid.view(128, 16, 64).bool().any(-1)).repeat_interleave(64, dim=1)
        k_nan, v_nan, k0, v0 = k.clone(), v.clone(), k.clone(), v.clone()
        k_nan[dead], v_nan[dead], k0[dead], v0[dead] = float("nan"), float("nan"), 0, 0
        got = da.decode_attention_bhsd(q, k_nan, v_nan, valid, scale=hd**-0.5)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K4 read a fully masked tile at hd {hd}")
        ok, err = within(got, da.decode_attention_torch(q, k0, v0, valid, scale=hd**-0.5),
                         K4_TOL["bfloat16"], K4_TOL["bfloat16"])
        check(ok, f"K4 with NaN in fully masked tiles at hd {hd}: max err {err}")
        nan_rows.append({"hd": hd, "nan_slots": int(dead.sum()), "max_abs_err": err})
    # split counts other than the plan's, through the C entry: long rows,
    # so each split refills its 3-stage ring many times
    lib = _build.library("decode_attention")
    q, k, v = k4_operands(8, 4096, 128, "bfloat16", seed=41)
    valid = k4_mask("scattered", 8, 4096, seed=41)
    for nsplit in (1, 3, 64):
        o = torch.empty_like(q)
        k4_tiled_call(lib, q, k, v, valid, o, nsplit)()
        torch.cuda.synchronize()
        ok, err = within(o, decode_attention_tiled_ref(q, k, v, valid, scale=128**-0.5,
                                                       nsplit=nsplit), *K4_TILED)
        check(ok, f"K4 at nsplit {nsplit} vs the tiled version: max err {err}")
        worst_tiled = max(worst_tiled, err)
    bh, s, hd = K4_SERVE
    q, k, v = k4_operands(bh, s, hd, "bfloat16", seed=7)
    valid = (torch.arange(s, device="cuda") < 528).to(torch.int32)[None].expand(bh, s).contiguous()
    run("deepseek_7b decode", q, k, v, valid, "bfloat16")
    emit("k4_vs_plain", tolerances=K4_TOL, tiled_bound=K4_TILED, worst=worst,
         worst_vs_tiled=worst_tiled, nan_in_masked_tiles=nan_rows, cases=per_case)
    return {"worst": worst, "serve_err": per_case[-1]["max_abs_err"]}


def k4_mask(kind: str, bh: int, s: int, seed: int):
    """(BH, S) int32 masks on the card: a prefix, a ring run that may wrap
    past S, or scattered slots, each row its own length or draw."""
    import torch

    rng = np.random.default_rng(seed)
    valid = np.zeros((bh, s), np.int32)
    for r in range(bh):
        n = int(rng.integers(1, s + 1))
        if kind == "prefix":
            valid[r, :n] = 1
        elif kind == "ring":
            valid[r, (int(rng.integers(0, s)) + np.arange(n)) % s] = 1
        else:
            valid[r] = rng.random(s) < 0.2
    return torch.from_numpy(valid).cuda()


def k4_tiled_call(lib, q, k, v, valid, o, nsplit: int):
    """A launch of K4's bf16 instance at a given split count, through its C
    entry (with its own workspace: partials, then the per-row counters), as
    a closure."""
    import torch

    bh, s, hd = k.shape
    ws = torch.empty(bh * nsplit * (hd + 2) + bh, dtype=torch.float32, device="cuda")

    def launch():
        rc = lib.repro_decode_attention_tiled(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), o.data_ptr(),
            ws.data_ptr(), bh, s, hd, nsplit, hd**-0.5, torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"K4 launch returned {rc}")
    return launch


def k5_operands(b: int, t: int, h: int, p: int, g: int, n: int, dtype: str, seed: int):
    """x, dt, a, B, C on the card as tests/test_kernels.py draws them, with numpy."""
    import torch

    rng = np.random.default_rng(seed)
    tdt = getattr(torch, dtype)

    def dev(a, dt=tdt):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device="cuda", dtype=dt)

    x = dev(rng.standard_normal((b, t, h, p)))
    dt = dev(np.logaddexp(rng.standard_normal((b, t, h)), 0.0) * 0.1, torch.float32)
    a = dev(-np.exp(rng.standard_normal(h)), torch.float32)
    bm = dev(rng.standard_normal((b, t, g, n)))
    cm = dev(rng.standard_normal((b, t, g, n)))
    return x, dt, a, bm, cm


def ssd_flat(x, dt, a, bm, cm):
    """The (BH, ...) operands ``ops.ssd_scan`` hands the kernel wrapper."""
    import torch

    b, t, h, p = x.shape
    rep = h // bm.shape[2]

    def heads(m):
        return torch.repeat_interleave(m, rep, dim=2).permute(0, 2, 1, 3).reshape(b * h, t, -1)

    return (x.permute(0, 2, 1, 3).reshape(b * h, t, p), dt.permute(0, 2, 1).reshape(b * h, t, 1),
            a[None].expand(b, h).reshape(b * h, 1), heads(bm), heads(cm))


def phase_k5_vs_plain() -> dict:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels.ref import ssd_scan_tiled_ref
    from repro_torch.models.mamba2 import ssd_chunked

    worst, worst_tiled, per_case = {}, 0.0, []
    cases = [((2, *shape), dt) for dt in ("bfloat16", "float32") for shape in K5_SWEEP]
    cases += [((1, t, h, p, 1, n, chunk), dt) for dt in ("bfloat16", "float32")
              for p in ss.SUPPORTED_P for n in ss.SUPPORTED_N for t, h, chunk in K5_PAIRS_SHAPES]
    cases += [(K5_SERVE, dt) for dt in ("bfloat16", "float32")]
    for (b, t, h, p, g, n, chunk), dt in cases:
        x, dtv, a, bm, cm = k5_operands(b, t, h, p, g, n, dt, seed=t + h + n)
        got = ops.ssd_scan(x, dtv, a, bm, cm, chunk=chunk)
        torch.cuda.synchronize()
        flat = ssd_flat(x, dtv, a, bm, cm)
        want = ss.ssd_scan_torch(*flat).reshape(b, h, t, p).permute(0, 2, 1, 3)
        name = (b, t, h, p, g, n, chunk)
        check(got.dtype == x.dtype and got.shape == x.shape, f"K5 output at {name}")
        check(bool(torch.isfinite(got).all()), f"K5 non-finite at {name} {dt}")
        ok, err = within(got, want, K5_ATOL[dt], K5_RTOL)
        check(ok, f"K5 vs plain at {name} {dt}: max err {err}")
        tiled = ssd_scan_tiled_ref(*flat, q=chunk).reshape(b, h, t, p).permute(0, 2, 1, 3)
        ok, err_tiled = within(got, tiled, *K5_TILED)
        check(ok, f"K5 vs the tiled version at {name} {dt}: max err {err_tiled}")
        worst[dt] = max(worst.get(dt, 0.0), err)
        worst_tiled = max(worst_tiled, err_tiled)
        per_case.append({"b": b, "t": t, "h": h, "p": p, "g": g, "n": n, "chunk": chunk,
                         "dtype": dt, "max_abs_err": err, "max_abs_err_vs_tiled": err_tiled,
                         "max_abs_y": float(want.float().abs().max())})
    # the model's chunked SSD, as tests/test_kernels.py holds the Pallas kernel to it
    x, dtv, a, bm, cm = k5_operands(1, 128, 2, 32, 1, 16, "float32", seed=0)
    y_model, _ = ssd_chunked(x, dtv, a, bm, cm, chunk=32)
    ok, err_model = within(ops.ssd_scan(x, dtv, a, bm, cm, chunk=32), y_model, 1e-3, 1e-3)
    check(ok, f"K5 vs ssd_chunked: max err {err_model}")
    emit("k5_vs_plain", atol=K5_ATOL, rtol=K5_RTOL, tiled_bound=K5_TILED, worst=worst,
         worst_vs_tiled=worst_tiled, cases=per_case, vs_ssd_chunked_max_abs_err=err_model)
    serve = [c for c in per_case if (c["b"], c["t"], c["h"], c["p"], c["g"], c["n"], c["chunk"])
             == K5_SERVE and c["dtype"] == "bfloat16"]
    return {"worst": worst, "worst_vs_tiled": worst_tiled, "serve_err": serve[0]["max_abs_err"]}


def serve_prompts(cfg, n: int, length: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=length) for _ in range(n)]


def check_train_launches(launches: dict, where: str, moe: bool) -> None:
    """No attention or SSD kernel on a training or dry-run path (their Pallas
    kernels have no backward); the router's expert positions launch in every
    forward of a model with MoE layers, and only there."""
    others = {k: v for k, v in launches.items() if k != "expert_slots" and v}
    check(not others, f"a kernel launched on {where}: {launches}")
    check((launches["expert_slots"] > 0) == moe, f"expert-slot launches on {where}: {launches}")


def launch_counts() -> dict:
    from repro_torch.kernels import cap_chain, decode_attention, flash_attention, moe_route, ssd_scan

    return {"cap_chain_rates": cap_chain.cap_chain_rates.launches,
            "nic_flow_counts": cap_chain.nic_flow_counts.launches,
            "flash_attention_bhtd": flash_attention.flash_attention_bhtd.launches,
            "decode_attention_bhsd": decode_attention.decode_attention_bhsd.launches,
            "ssd_scan_bhtpn": ssd_scan.ssd_scan_bhtpn.launches,
            "expert_slots": moe_route.expert_slots.launches}


def host_rss_bytes() -> int:
    import os

    return int(Path("/proc/self/statm").read_text().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def release_host_memory() -> tuple[int, int]:
    """The resident bytes, then those after glibc's ``malloc_trim`` hands the
    heap's free pages back to the system (freed blocks of a restore may stay
    in its arenas otherwise; a no-op where there is no glibc)."""
    import ctypes

    before = host_rss_bytes()
    with contextlib.suppress(OSError, AttributeError):
        ctypes.CDLL(None).malloc_trim(0)
    return before, host_rss_bytes()


class HostPeak:
    """The process's largest resident set while the block runs, sampled every
    10 ms from ``/proc/self/statm`` (resetting the kernel's own high-water
    mark through ``/proc/self/clear_refs`` may be refused)."""

    def __enter__(self) -> "HostPeak":
        import threading

        self.start = self.bytes = host_rss_bytes()  # at entry, and the largest since
        self._stop = threading.Event()

        def sample() -> None:
            while not self._stop.wait(0.01):
                self.bytes = max(self.bytes, host_rss_bytes())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()


def fingerprint(x) -> int:
    """A 64-bit sum of a tensor's 16- or 32-bit words on its device, word i
    weighted by the odd 2i + 1: a change in any one word always changes it,
    and unrelated contents collide with chance ~2**-64."""
    import torch

    flat = x.detach().reshape(-1)
    check(flat.element_size() in (2, 4), f"fingerprint of {flat.dtype}")
    words = flat.view(torch.int32 if flat.element_size() == 4 else torch.int16)
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    step = 1 << 26
    for lo in range(0, words.numel(), step):
        w = words[lo:lo + step].to(torch.int64)
        weight = torch.arange(2 * lo + 1, 2 * (lo + w.numel()) + 1, 2, dtype=torch.int64, device=x.device)
        total += (w * weight).sum()
    return int(total)


def first_fetch_bytes(doc: dict, first) -> int:
    """The compressed bytes of the blocks that the checkpoint manifest ``doc``
    says cover the leaves matching ``first``."""
    m = doc["block_manifest"]
    bs, offsets = m["block_size"], m["offsets"]
    blocks = set()
    for leaf in doc["leaves"]:
        if first(leaf["path"]) and leaf["nbytes"] > 0:
            blocks.update(range(leaf["offset"] // bs, (leaf["offset"] + leaf["nbytes"] - 1) // bs + 1))
    return sum(offsets[i + 1] - offsets[i] for i in blocks)


def cold_start_engine(cfg, seed: int, ckpt_dir: Path, exact: bool) -> tuple:
    """``launch/serve.py``'s flow on the card: ``cfg``'s float32 master weights
    drawn on the card from ``seed``, saved as a block checkpoint in
    ``ckpt_dir``, freed, and a ServeEngine cold-started from the checkpoint
    with ``lazy=True`` against a ``meta`` tree, so the card holds one copy.
    Every restored leaf must equal the saved one: by fingerprint, and with
    ``exact`` also bit for bit against a host copy of the saved leaves.
    The first fetch must be the blocks the manifest says cover the first
    leaves, the total every block.  Returns (engine, fields)."""
    import shutil

    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.blockstore import default_workers
    from repro_torch.models.params import MetaGenerator, tree_leaves_with_path
    from repro_torch.serving.engine import FIRST_LEAF_PRED, ServeEngine

    eng = ServeEngine(cfg, max_batch=SERVE_BATCH, device="cuda")
    t0 = time.perf_counter()
    params = eng.model.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = [x for _, x in tree_leaves_with_path(params)]
    n_params = sum(x.numel() for x in leaves)
    want = TREE_PARAMS.get(cfg.name, cfg.param_count())
    check(n_params == want, f"param count {n_params} vs {want}")
    raw_bytes = sum(x.numel() * x.element_size() for x in leaves)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(ckpt_dir).free
    check(free >= raw_bytes, f"{ckpt_dir} has {free:,} bytes free; the checkpoint needs about {raw_bytes:,}")
    saved = [fingerprint(x) for x in leaves]
    mgr = CheckpointManager(str(ckpt_dir))
    with HostPeak() as save_peak:
        t0 = time.perf_counter()
        mgr.save(0, params)
        save_s = time.perf_counter() - t0
    # (after the save, so that its host peak is the save's own; the restore's
    # then includes this copy)
    host_copy = [x.cpu() for x in leaves] if exact else []
    del leaves, params
    gc.collect()
    torch.cuda.empty_cache()
    doc = json.loads((ckpt_dir / "ckpt_00000000.json").read_text())
    compressed = doc["block_manifest"]["offsets"][-1]
    check(doc["block_manifest"]["raw_size"] == raw_bytes, "checkpoint raw size")
    like = eng.model.init(MetaGenerator())
    torch.cuda.reset_peak_memory_stats()
    with HostPeak() as restore_peak:
        eng.start(mgr, 0, like, lazy=True)
        torch.cuda.synchronize()
    restore_device_peak = torch.cuda.max_memory_allocated()
    stats = eng.cold_start_stats
    want_first = first_fetch_bytes(doc, FIRST_LEAF_PRED)
    check(stats["first_fetch_compressed_bytes"] == want_first,
          f"first fetch {stats['first_fetch_compressed_bytes']} vs the manifest's {want_first}")
    check(stats["total_fetch_compressed_bytes"] == compressed,
          f"total fetch {stats['total_fetch_compressed_bytes']} vs {compressed}")
    got = [x for _, x in tree_leaves_with_path(eng.params)]
    check(all(x.is_cuda for x in got), "restored leaves on the card")
    check([fingerprint(x) for x in got] == saved, "restored leaves' fingerprints vs the saved ones")
    if exact:
        for i, (g, w) in enumerate(zip(got, host_copy, strict=True)):
            check(g.dtype == w.dtype and torch.equal(g.cpu().view(-1).view(torch.uint8),
                                                      w.view(-1).view(torch.uint8)),
                  f"restored leaf {i} vs the saved one, bit for bit")
    host_copy_bytes = sum(x.numel() * x.element_size() for x in host_copy)
    del got, host_copy
    gc.collect()
    rss_after, rss_trimmed = release_host_memory()
    first_leaves = [m["path"] for m in doc["leaves"] if FIRST_LEAF_PRED(m["path"])]
    fields = dict(
        weights_init_s=init_s, save_s=save_s, save_mb_per_s=raw_bytes / save_s / 1e6,
        host_threads=default_workers(), raw_bytes=raw_bytes, compressed_bytes=compressed,
        compression_ratio=compressed / raw_bytes, n_blocks=doc["block_manifest"]["n_blocks"],
        codec=doc["block_manifest"]["codec"], first_leaves=len(first_leaves), leaves=len(doc["leaves"]),
        first_fetch_share=stats["first_fetch_compressed_bytes"] / compressed,
        cold_start_stats=stats, restore_mb_per_s=raw_bytes / stats["t_full_s"] / 1e6,
        save_host_peak_bytes=save_peak.bytes, save_host_rss_before_bytes=save_peak.start,
        restore_host_peak_bytes=restore_peak.bytes, restore_host_rss_before_bytes=restore_peak.start,
        restore_device_peak_bytes=restore_device_peak,
        host_copy_bytes=host_copy_bytes, host_rss_after_start_bytes=rss_after,
        host_rss_after_malloc_trim_bytes=rss_trimmed,
        leaves_checked="fingerprint + bit for bit" if exact else "fingerprint",
    )
    return eng, fields


def serve_traffic(cfg, seed: int = 0, prompt_len: int = SERVE_PROMPT, cold_start: bool = False,
                  exact: bool = False) -> dict:
    """``cfg`` at full width through ServeEngine on the card: float32 master
    weights drawn on the card from ``seed`` (with ``cold_start``, saved and
    cold-started from their block checkpoint, ``cold_start_engine``), then 8
    requests of ``prompt_len`` tokens and 16 new tokens, 4 to a batch.  Every
    kernel count is set to 0 just before the requests are submitted and read
    just after the last finishes."""
    import dataclasses
    import shutil

    import torch

    from repro_torch import kernels
    from repro_torch.models.params import tree_leaves_with_path
    from repro_torch.serving.engine import ServeEngine

    torch.cuda.reset_peak_memory_stats()
    cold = {}
    if cold_start:
        ckpt_dir = CKPT_DIR / cfg.name
        try:
            eng, cold = cold_start_engine(cfg, seed, ckpt_dir, exact)
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        # the cold path: the restore (ServeEngine.start), then the first token
        params, ready_s = eng.params, cold["cold_start_stats"]["t_full_s"]
        n_params = sum(x.numel() for _, x in tree_leaves_with_path(params))
    else:
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, max_batch=SERVE_BATCH, device="cuda")
        params = eng.model.init(torch.Generator(device="cuda").manual_seed(seed))
        eng.set_params(params)
        torch.cuda.synchronize()
        ready_s = time.perf_counter() - t0
        cold["weights_init_s"] = ready_s
        n_params = sum(x.numel() for _, x in tree_leaves_with_path(params))
        check(n_params == cfg.param_count(), f"param count {n_params} vs {cfg.param_count()}")

    walls = {"prefill": [], "decode": []}

    def timed(kind, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            walls[kind].append(time.perf_counter() - t)
            return out
        return run

    model = eng.model
    eng.model = dataclasses.replace(model, prefill=timed("prefill", model.prefill),
                                    decode_step=timed("decode", model.decode_step))
    prompts = serve_prompts(cfg, SERVE_REQUESTS, prompt_len, seed=seed)
    kernels.reset_launches()
    t_serve = time.perf_counter()
    for pr in prompts:
        eng.submit(pr, max_new_tokens=SERVE_NEW)
    done = []
    while eng.queue:
        done += eng.step_batch()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t_serve
    launches = launch_counts()
    n_prefills = -(-SERVE_REQUESTS // SERVE_BATCH)
    check(len(walls["prefill"]) == n_prefills, f"prefills {len(walls['prefill'])}")
    check(len(walls["decode"]) == n_prefills * (SERVE_NEW - 1), f"decode steps {len(walls['decode'])}")
    check(all(len(r.out_tokens) == SERVE_NEW for r in done) and len(done) == SERVE_REQUESTS,
          "every request got its tokens")
    check(all(0 <= tok < cfg.vocab_size for r in done for tok in r.out_tokens), "token ids in range")
    ttft = [r.t_first_token - r.t_arrival for r in done]
    out = dict(
        arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model, params=n_params,
        compute_dtype=cfg.compute_dtype, attn_impl=cfg.attn_impl,
        requests=SERVE_REQUESTS, prompt_len=prompt_len, new_tokens=SERVE_NEW,
        max_batch=SERVE_BATCH, launches=launches, prefills=n_prefills,
        decode_steps=len(walls["decode"]), cold_path_ttft_s=ready_s + ttft[0], ttft_s=ttft,
        latency_s=[r.t_done - r.t_arrival for r in done],
        serve_wall_s=serve_s, prefill_wall_s=walls["prefill"], decode_wall_s=sum(walls["decode"]),
        decode_step_mean_s=sum(walls["decode"]) / len(walls["decode"]),
        tokens_per_s=SERVE_REQUESTS * SERVE_NEW / serve_s,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        first_tokens=[r.out_tokens[:4] for r in done], **cold,
    )
    return {"out": out, "model": model, "params": params, "prompts": prompts}


def phase_serve_full_width() -> dict:
    """deepseek_7b at full width through ServeEngine on the card, cold-started
    from its own 27.6 GB block checkpoint, with K3, and K4 on the layer-0
    decode operands of every decode step."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import attention

    cfg = dataclasses.replace(get_config("deepseek_7b"), attn_impl="pallas")
    calls, steps = [0], []

    def record(fn):
        def run(q, k_cache, v_cache, k_new, v_new, k_valid, scale):
            if calls[0] % cfg.n_layers == 0:  # layer 0 of a decode step
                steps.append([x.clone() for x in (q, k_cache, v_cache, k_new, v_new, k_valid)])
            calls[0] += 1
            return fn(q, k_cache, v_cache, k_new, v_new, k_valid, scale)
        return run

    with patched(attention, "attend_decode_plus_new", record):
        served = serve_traffic(cfg, cold_start=True)
    out, params = served["out"], served["params"]
    # every deepseek_7b layer folds into stages/0, so the "first" fetch is the
    # whole checkpoint (the reference's FIRST_LEAF_PRED; ROADMAP Queue 3)
    stats = out["cold_start_stats"]
    check(stats["first_fetch_compressed_bytes"] == stats["total_fetch_compressed_bytes"],
          f"deepseek_7b's first fetch is not the whole checkpoint: {stats}")
    check(out["peak_memory_bytes"] < 2 * out["raw_bytes"],
          f"device peak {out['peak_memory_bytes']} from the restore on, two copies {2 * out['raw_bytes']}")
    k3 = out["launches"]["flash_attention_bhtd"]
    check(k3 == cfg.n_layers * out["prefills"], f"K3 launches {k3} vs {cfg.n_layers} x {out['prefills']}")
    check(len(steps) == out["decode_steps"], f"recorded decode steps {len(steps)}")
    out["k3_launches"] = k3
    out["k4_path"] = k4_on_decode_steps(steps, scale=cfg.hd**-0.5)
    check(out["k4_path"]["launches"] == len(steps) > 0,
          f"K4 launches on the decode steps: {out['k4_path']['launches']} of {len(steps)}")
    del steps
    out["profile"] = profile_prefill_and_decode(served["model"], params, served["prompts"][:SERVE_BATCH])
    out["f32_check"] = f32_pallas_vs_chunked(cfg, params, served["prompts"][:SERVE_BATCH])
    # reported, not gated: both bf16 paths round, at different points
    out["bf16_vs_chunked"] = pallas_vs_chunked(cfg, params, served["prompts"][:SERVE_BATCH],
                                               cfg.compute_dtype)
    emit("serve_full_width", **out)
    del served, params
    torch.cuda.empty_cache()
    return out


def phase_serve_gemma3_1b() -> dict:
    """gemma3_1b at full width, cold-started from its block checkpoint, whose
    first fetch is a real prefix (the tied embedding, layer 0, the final
    norm), through ServeEngine on the card with 1,024-token prompts: K3's
    sliding-window (512) and global instances at hd 256, counted apart."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(get_config("gemma3_1b"), attn_impl="pallas")
    calls = {"windowed": 0, "global": 0}

    def count(fn):
        def run(q, k, v, *, window=None, **kw):
            calls["global" if window is None else "windowed"] += 1
            return fn(q, k, v, window=window, **kw)
        return run

    with patched(ops, "flash_attention", count):
        served = serve_traffic(cfg, prompt_len=GEMMA_PROMPT, cold_start=True, exact=True)
    out, params = served["out"], served["params"]
    stats = out["cold_start_stats"]
    check(stats["first_fetch_compressed_bytes"] < stats["total_fetch_compressed_bytes"],
          f"gemma3_1b's first fetch is the whole checkpoint: {stats}")
    specs = cfg.layer_specs()
    want = {"windowed": sum(not s.is_global for s in specs) * out["prefills"],
            "global": sum(s.is_global for s in specs) * out["prefills"]}
    k3 = out["launches"]["flash_attention_bhtd"]
    check(calls == want and k3 == cfg.n_layers * out["prefills"],
          f"K3 launches {k3}, by kind {calls}, vs {want}")
    out["k3_launches"] = k3
    out["k3_launches_by_kind"] = calls
    out["window"] = cfg.sliding_window
    out["f32_check"] = f32_pallas_vs_chunked(cfg, params, served["prompts"][:SERVE_BATCH])
    emit("serve_gemma3_1b", **out)
    del served, params
    torch.cuda.empty_cache()
    return out


def k4_on_decode_steps(steps, scale: float) -> dict:
    """K4's main path: ``ops.decode_attention`` on the layer-0 operands of each
    decode step of the deepseek_7b serve (the cache after the step's write,
    padded with invalid slots to a multiple of 512), each held against the
    port's ``attend_decode`` on the unpadded cache."""
    import torch

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.models.attention import attend_decode

    da.reset_launches()
    worst, s_pad = 0.0, 0
    for q, k_old, v_old, k_new, v_new, valid in steps:
        s = k_old.shape[2]
        # the write that follows attention: this step's key and value land at
        # the first slot the old-cache mask leaves out (pos, or pos % S once
        # the ring is warm)
        slot = int(torch.nonzero(~valid)[0])
        k, v, ok = k_old.clone(), v_old.clone(), valid.clone()
        k[:, :, slot], v[:, :, slot], ok[slot] = k_new[:, :, 0], v_new[:, :, 0], True
        s_pad = -(-s // 512) * 512
        pad = (0, 0, 0, s_pad - s)
        got = ops.decode_attention(q, torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad),
                                   torch.nn.functional.pad(ok, (0, s_pad - s)).to(torch.int32),
                                   scale=scale)
        want = attend_decode(q, k, v, ok, scale)
        good, err = within(got, want, K4_TOL["bfloat16"], K4_TOL["bfloat16"])
        check(good, f"K4 on a served decode step vs attend_decode: max err {err}")
        worst = max(worst, err)
    torch.cuda.synchronize()
    return {"launches": da.decode_attention_bhsd.launches, "steps": len(steps),
            "shape": [int(q.shape[0] * q.shape[1]), s_pad, int(q.shape[3])],
            "max_abs_err": worst, "tolerance": K4_TOL["bfloat16"]}


def phase_serve_mamba2_130m() -> dict:
    """mamba2_130m at full width through ServeEngine on the card; K5 on the SSD
    operands of every layer of the first prefill; a float32 check that the
    decode caches reproduce a prefill of the generated text."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import mamba2

    cfg = get_config("mamba2_130m")
    rec = []

    def record(fn):
        def run(x, dt, A, Bm, Cm, *, chunk, **kw):
            y, final = fn(x, dt, A, Bm, Cm, chunk=chunk, **kw)
            if len(rec) < cfg.n_layers:  # every layer of the first prefill
                rec.append(([t.clone() for t in (x, dt, A, Bm, Cm)], chunk, y.clone()))
            return y, final
        return run

    with patched(mamba2, "ssd_chunked", record):
        served = serve_traffic(cfg)
    out, params = served["out"], served["params"]
    check(len(rec) == cfg.n_layers, f"recorded SSD calls {len(rec)}")
    check(out["launches"]["flash_attention_bhtd"] == 0, "an attention-free model launched K3")
    # K5's main path: ops.ssd_scan on each layer's operands as the model made them
    ss.reset_launches()
    worst_model, worst_f32, scale_f32 = 0.0, 0.0, 0.0
    for i, (ops_in, chunk, y_model) in enumerate(rec):
        got = ops.ssd_scan(*ops_in, chunk=chunk)
        check(got.dtype == y_model.dtype and got.shape == y_model.shape, f"K5 layer {i} output")
        err = float((got.float() - y_model.float()).abs().max())
        top = float(y_model.float().abs().max())
        check(err <= K5_ATOL["bfloat16"] * top, f"K5 vs ssd_chunked at layer {i}: {err} at max |y| {top}")
        worst_model = max(worst_model, err / top)
    torch.cuda.synchronize()
    k5 = ss.ssd_scan_bhtpn.launches
    check(k5 == cfg.n_layers, f"K5 launches {k5}")
    # layer 0 in float32, through K5 and through ssd_chunked
    x, dt, A, Bm, Cm = (t.float() for t in rec[0][0])
    y_k = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=rec[0][1])
    y_c, _ = mamba2.ssd_chunked(x, dt, A, Bm, Cm, chunk=rec[0][1])
    worst_f32, scale_f32 = float((y_k - y_c).abs().max()), float(y_c.abs().max())
    check(worst_f32 <= 1e-3 * scale_f32, f"K5 vs ssd_chunked in f32: {worst_f32} at max |y| {scale_f32}")
    b, t, h, p = x.shape
    out["k5_path"] = {"launches": k5, "layers": len(rec), "shape": [b * h, t, p, Bm.shape[3]],
                      "chunk": rec[0][1], "dtype": str(rec[0][0][0].dtype).split(".")[1],
                      "max_rel_err_vs_model": worst_model, "f32_layer0_max_abs_diff": worst_f32,
                      "f32_layer0_max_abs_y": scale_f32, "f32_limit": 1e-3}
    del rec
    out["profile"] = profile_prefill_and_decode(served["model"], params, served["prompts"][:SERVE_BATCH])
    out["f32_decode_check"] = f32_decode_consistency(cfg, params, served["prompts"][:SERVE_BATCH])
    emit("serve_mamba2_130m", **out)
    del served, params
    torch.cuda.empty_cache()
    return out


def f32_decode_consistency(cfg, params, prompts) -> dict:
    """In float32: the greedy tokens of a prefill and 15 decode steps equal the
    argmax of one prefill of the prompt followed by those tokens, at each
    generated position (the conv and SSM caches on the card are right)."""
    import dataclasses

    import torch

    from repro_torch.models import model_for

    m = model_for(dataclasses.replace(cfg, compute_dtype="float32"))
    toks = torch.from_numpy(np.stack(prompts).astype(np.int32)).cuda()
    t = toks.shape[1]
    logits, cache = m.prefill(params, {"tokens": toks}, cache_len=t + SERVE_NEW)
    steps = [logits[:, -1]]
    for k in range(1, SERVE_NEW):
        nxt = steps[-1].argmax(-1)[:, None].to(torch.int32)
        logits, cache = m.decode_step(params, {"tokens": nxt, "pos": t + k - 1}, cache)
        steps.append(logits[:, -1])
    step_logits = torch.stack(steps, dim=1)  # (B, new, V)
    gen = step_logits.argmax(-1)
    full, _ = m.prefill(params, {"tokens": torch.cat([toks, gen[:, :-1].to(torch.int32)], dim=1)})
    full = full[:, t - 1:]
    check(torch.equal(full.argmax(-1), gen), "f32 decode tokens vs a prefill of the generated text")
    diff = float((full - step_logits).abs().max())
    top = float(full.abs().max())
    check(diff <= 1e-3 * top, f"f32 decode logits vs prefill: {diff} at max |logit| {top}")
    return {"positions": list(gen.shape), "tokens_equal": True, "max_abs_logit_diff": diff,
            "max_abs_logit": top, "limit_rel": 1e-3}


def phase_serve_granite_moe_1b() -> dict:
    """granite_moe_1b at full width through ServeEngine on the card, with K3 at
    hd 64 under GQA; counts the (token, choice) pairs dropped at capacity."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config("granite_moe_1b"), attn_impl="pallas")
    drops = {"dropped": torch.zeros((), dtype=torch.int64, device="cuda"), "choices": 0, "calls": 0}

    def count(fn):
        def run(logits, k, capacity):
            slot, gate, eids, aux = fn(logits, k, capacity)
            if logits.shape[0] > SERVE_BATCH:  # a prefill: decode capacity drops nothing
                drops["dropped"] += (slot == logits.shape[1] * capacity).sum()
                drops["choices"] += slot.numel()
                drops["calls"] += 1
            return slot, gate, eids, aux
        return run

    with patched(moe, "route_topk", count):
        served = serve_traffic(cfg)
    out, params = served["out"], served["params"]
    k3 = out["launches"]["flash_attention_bhtd"]
    check(k3 == cfg.n_layers * out["prefills"], f"K3 launches {k3} vs {cfg.n_layers} x {out['prefills']}")
    out["k3_launches"] = k3
    # every layer is a MoE layer: one expert-position launch a layer of each
    # prefill and decode step
    slots = out["launches"]["expert_slots"]
    steps = out["prefills"] + out["decode_steps"]
    check(slots == cfg.n_layers * steps, f"expert-slot launches {slots} vs {cfg.n_layers} x {steps}")
    out["moe_route_launches"] = slots
    out["moe_drops"] = {"capacity_factor": cfg.moe.capacity_factor, "prefill_layers": drops["calls"],
                        "choices": drops["choices"], "dropped": int(drops["dropped"]),
                        "dropped_share": int(drops["dropped"]) / max(drops["choices"], 1)}
    out["profile"] = profile_prefill_and_decode(served["model"], params, served["prompts"][:SERVE_BATCH])
    out["f32_check"] = f32_pallas_vs_chunked(cfg, params, served["prompts"][:SERVE_BATCH])
    emit("serve_granite_moe_1b", **out)
    del served, params
    torch.cuda.empty_cache()
    return out


def profile_prefill_and_decode(model, params, prompts, extra=None) -> dict:
    """Device busy time against wall time for one prefill and one decode step
    of a full batch, from a ``torch.profiler`` trace (kernel events only).
    ``extra`` adds inputs to the prefill batch (whisper's frames)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    toks = torch.from_numpy(np.stack(prompts).astype(np.int32)).cuda()
    out = {}
    cache = None
    for kind in ("prefill", "decode"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if kind == "prefill":
                logits, cache = model.prefill(params, {"tokens": toks, **(extra or {})},
                                              cache_len=toks.shape[1] + 1)
            else:
                nxt = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
                logits, cache = model.decode_step(params, {"tokens": nxt, "pos": toks.shape[1]}, cache)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[kind] = device_summary(prof, wall, top=6)
    return out


def device_summary(prof, wall_s: float, top: int) -> dict:
    """Device busy ms (kernel events), idle share of ``wall_s``, kernel count
    and the ``top`` device ops by time, from a ``torch.profiler`` trace."""
    import torch

    by_name: dict = {}
    n = n_scans = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            n += 1
            n_scans += "scan" in e.name.lower()
    busy = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # every device kernel with "scan" in its name: any cumsum, and K5's passes
    # (the router's positions are no scan: its kernel counts and ranks)
    scan_ms = sum(ms for name, ms in by_name.items() if "scan" in name.lower())
    return dict(wall_ms=wall_s * 1e3, device_busy_ms=busy, idle_share=1 - busy / (wall_s * 1e3),
                kernels=n, top_ms=[[name[:80], ms] for name, ms in ranked],
                scan_kernels_ms=scan_ms, scan_kernel_calls=n_scans)


def pallas_vs_chunked(cfg, params, prompts, dtype: str, extra=None) -> dict:
    """One full-width prefill in ``dtype`` through K3 and through ``chunked``:
    the largest |logit| difference, the largest |logit|, and the share of
    positions whose argmax agrees."""
    import dataclasses

    import torch

    from repro_torch.models import model_for

    toks = torch.from_numpy(np.stack(prompts).astype(np.int32)).cuda()
    logits = {}
    for impl in ("pallas", "chunked"):
        m = model_for(dataclasses.replace(cfg, compute_dtype=dtype, attn_impl=impl))
        out, _ = m.prefill(params, {"tokens": toks, **(extra or {})})
        logits[impl] = out.float()
        torch.cuda.synchronize()
    lp, lc = logits["pallas"], logits["chunked"]
    check(bool(torch.isfinite(lp).all()), f"{dtype} pallas logits finite")
    diff = float((lp - lc).abs().max())
    scale = float(lc.abs().max())
    return dict(dtype=dtype, shape=list(lp.shape), max_abs_diff=diff, max_abs_logit=scale,
                rel_diff=diff / scale, greedy_tokens=lp[:, -1].argmax(-1).tolist(),
                greedy_tokens_chunked=lc[:, -1].argmax(-1).tolist(),
                argmax_agreement_all_positions=float((lp.argmax(-1) == lc.argmax(-1)).float().mean()))


def f32_pallas_vs_chunked(cfg, params, prompts, extra=None) -> dict:
    """In float32 the two paths agree within 1e-3 of the largest |logit|, with
    the same greedy tokens."""
    out = pallas_vs_chunked(cfg, params, prompts, "float32", extra)
    check(out["greedy_tokens"] == out["greedy_tokens_chunked"],
          f"f32 greedy tokens differ: {out['greedy_tokens']} vs {out['greedy_tokens_chunked']}")
    check(out["rel_diff"] <= 1e-3,
          f"f32 pallas vs chunked: max diff {out['max_abs_diff']} at max |logit| {out['max_abs_logit']}")
    return out | {"limit": 1e-3}


def whisper_inputs(cfg, n: int, prompt_len: int, seed: int, device: str):
    """``n`` prompts and ``n`` frame embeddings, drawn with numpy from
    ``seed``; the frames rounded to bf16 as ``make_batch`` rounds them."""
    import torch

    rng = np.random.default_rng(seed)
    e = cfg.encdec
    prompts = [rng.integers(0, cfg.vocab_size, size=prompt_len) for _ in range(n)]
    frames = torch.from_numpy(rng.standard_normal((n, e.encoder_ctx, e.d_frontend))).to(
        device=device, dtype=torch.bfloat16)
    return prompts, frames


def whisper_serve(model, params, prompts, frames, batch: int, new: int, device: str,
                  keep_logits: bool = False) -> dict:
    """``ServeEngine.step_batch``'s loop, with frames: up to ``batch``
    requests a batch, left-padded with token 0, one prefill, then greedy
    decode steps at ``pos = t + k - 1``.  Each call's host wall is taken
    where its tokens reach the host.  With ``keep_logits`` each step's last
    logits are copied to the host, per batch."""
    import torch

    walls = {"prefill": [], "decode": []}
    tokens, ttft, latency, step_logits = [], [], [], []
    finite = torch.ones((), dtype=torch.bool, device=device)
    t_submit = time.perf_counter()
    for i in range(0, len(prompts), batch):
        reqs = prompts[i:i + batch]
        t = max(len(p) for p in reqs)
        toks = np.zeros((len(reqs), t), np.int32)
        for j, p in enumerate(reqs):
            toks[j, t - len(p):] = p
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": torch.from_numpy(toks).to(device),
                                               "frames": frames[i:i + batch]})
        last = logits[:, -1].argmax(dim=-1)
        finite &= torch.isfinite(logits[:, -1]).all()
        out = [[tok] for tok in last.tolist()]
        now = time.perf_counter()
        walls["prefill"].append(now - t0)
        ttft.append(now - t_submit)
        step_logits.append([logits[:, -1].float().cpu()] if keep_logits else [])
        for k in range(1, new):
            t0 = time.perf_counter()
            logits, cache = model.decode_step(
                params, {"tokens": last[:, None].to(torch.int32), "pos": t + k - 1}, cache)
            last = logits[:, -1].argmax(dim=-1)
            finite &= torch.isfinite(logits[:, -1]).all()
            for row, tok in zip(out, last.tolist()):
                row.append(tok)
            walls["decode"].append(time.perf_counter() - t0)
            if keep_logits:
                step_logits[-1].append(logits[:, -1].float().cpu())
        latency.append(time.perf_counter() - t_submit)
        tokens += out
    return dict(walls=walls, tokens=tokens, ttft=ttft, latency=latency,
                serve_s=time.perf_counter() - t_submit, step_logits=step_logits,
                finite=bool(finite))


def whisper_cpu_parity() -> dict:
    """Check (d): whisper_medium's widths and full encoder_ctx at 2 encoder
    and 2 decoder layers, f32, from params drawn on the CPU: a 16-token
    prompt and 24 greedy decode steps (pos 16-39, so the 16-slot ring wraps)
    on the card and on the port's CPU path.  Every step's logits within 1e-4
    of the largest |logit|, and the same greedy tokens."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model_for
    from repro_torch.models.params import tree_map

    full = get_config("whisper_medium")
    n = WHISPER_CPU["layers"]
    cfg = dataclasses.replace(full, n_layers=n, compute_dtype="float32", attn_impl="pallas",
                              encdec=dataclasses.replace(full.encdec, encoder_layers=n))
    model = model_for(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompts, frames = whisper_inputs(cfg, WHISPER_CPU["batch"], WHISPER_CPU["prompt"], seed=2,
                                     device="cpu")
    runs = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else tree_map(lambda x: x.to(dev), params)
        runs[dev] = whisper_serve(model, p, prompts, frames.to(dev), WHISPER_CPU["batch"],
                                  WHISPER_CPU["steps"] + 1, dev, keep_logits=True)
    worst = 0.0
    for got, want in zip(runs["cuda"]["step_logits"][0], runs["cpu"]["step_logits"][0]):
        top = float(want.abs().max())
        diff = float((got - want).abs().max())
        check(diff <= WHISPER_CPU["limit"] * top,
              f"whisper cuda vs cpu: logits differ by {diff} at max |logit| {top}")
        worst = max(worst, diff / top)
    check(runs["cuda"]["tokens"] == runs["cpu"]["tokens"],
          f"whisper greedy tokens: cuda {runs['cuda']['tokens']} vs cpu {runs['cpu']['tokens']}")
    return dict(layers=n, d_model=cfg.d_model, encoder_ctx=cfg.encdec.encoder_ctx,
                batch=WHISPER_CPU["batch"], prompt_len=WHISPER_CPU["prompt"],
                decode_steps=WHISPER_CPU["steps"],
                positions=[WHISPER_CPU["prompt"], WHISPER_CPU["prompt"] + WHISPER_CPU["steps"] - 1],
                max_rel_logit_diff=worst, limit_rel=WHISPER_CPU["limit"], tokens_equal=True)


def phase_serve_whisper_medium() -> dict:
    """whisper_medium at full width, 24 + 24 layers, through the model facade
    on the card with K3 on its decoder's prefill self-attention: (a) the
    params tree holds the reference's 759,592,960 parameters; (b) K3
    launches 24 layers x 2 batches, the encoder none; (c) an f32 prefill
    through K3 within 1e-3 of ``chunked``'s largest |logit|; (d) a 2 + 2
    layer cut on the card against the CPU (``whisper_cpu_parity``)."""
    import dataclasses

    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import model_for
    from repro_torch.models.params import tree_leaves_with_path

    cfg = dataclasses.replace(get_config("whisper_medium"), attn_impl="pallas")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = model_for(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for _, x in tree_leaves_with_path(params))
    check(n_params == WHISPER_PARAMS, f"whisper param count {n_params} vs {WHISPER_PARAMS}")
    prompts, frames = whisper_inputs(cfg, WHISPER_REQUESTS, WHISPER_PROMPT, seed=0, device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launches()
    served = whisper_serve(model, params, prompts, frames, SERVE_BATCH, WHISPER_NEW, "cuda")
    torch.cuda.synchronize()
    launches = launch_counts()
    walls = served["walls"]
    n_batches = -(-WHISPER_REQUESTS // SERVE_BATCH)
    k3 = launches["flash_attention_bhtd"]
    check(k3 == cfg.n_layers * n_batches, f"whisper K3 launches {k3} vs {cfg.n_layers} x {n_batches}")
    check(len(walls["decode"]) == n_batches * (WHISPER_NEW - 1), f"decode steps {len(walls['decode'])}")
    check(len(served["tokens"]) == WHISPER_REQUESTS
          and all(len(r) == WHISPER_NEW for r in served["tokens"]), "every request got its tokens")
    check(all(0 <= tok < cfg.vocab_size for r in served["tokens"] for tok in r), "token ids in range")
    check(served["finite"], "whisper serve: every step's last logits finite")
    out = dict(
        arch=cfg.name, n_layers=cfg.n_layers, encoder_layers=cfg.encdec.encoder_layers,
        d_model=cfg.d_model, n_heads=cfg.n_heads, hd=cfg.hd, encoder_ctx=cfg.encdec.encoder_ctx,
        vocab=cfg.vocab_size, params=n_params, param_count_rough=cfg.param_count(),
        compute_dtype=cfg.compute_dtype, attn_impl=cfg.attn_impl, requests=WHISPER_REQUESTS,
        prompt_len=WHISPER_PROMPT, new_tokens=WHISPER_NEW, max_batch=SERVE_BATCH,
        launches=launches, k3_launches=k3, prefills=n_batches, decode_steps=len(walls["decode"]),
        weights_init_s=init_s, prefill_wall_s=walls["prefill"],
        decode_step_mean_s=sum(walls["decode"]) / len(walls["decode"]),
        decode_wall_s=sum(walls["decode"]), serve_wall_s=served["serve_s"],
        tokens_per_s=WHISPER_REQUESTS * WHISPER_NEW / served["serve_s"],
        ttft_s=served["ttft"], latency_s=served["latency"],
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        first_tokens=[r[:4] for r in served["tokens"]],
    )
    del served
    first = {"frames": frames[:SERVE_BATCH]}
    out["profile"] = profile_prefill_and_decode(model, params, prompts[:SERVE_BATCH], first)
    out["f32_check"] = f32_pallas_vs_chunked(cfg, params, prompts[:SERVE_BATCH], first)
    del params, frames
    torch.cuda.empty_cache()
    out["cpu_parity"] = whisper_cpu_parity()
    emit("serve_whisper_medium", **out)
    torch.cuda.empty_cache()
    return out


def phase_cold_start() -> dict:
    """launch/serve's flow on deepseek_7b's smoke config: save, lazy start, serve."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import serve
    from repro_torch.serving.engine import ServeEngine

    cfg = dataclasses.replace(get_smoke("deepseek_7b"), attn_impl="pallas", compute_dtype="float32")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        fa.reset_launches()
        eng, done = serve(cfg, requests=8, max_new_tokens=8, prompt_len=16,
                          ckpt_dir=ckpt_dir, device="cuda", seed=0)
        torch.cuda.synchronize()
        launches = fa.flash_attention_bhtd.launches
        check(launches == cfg.n_layers * 2, f"cold-start K3 launches {launches}")
        stats = eng.cold_start_stats
        check(0 < stats["first_fetch_compressed_bytes"] <= stats["total_fetch_compressed_bytes"],
              f"cold-start fetch stats {stats}")
        # The same checkpoint served on the CPU (plain versions) gives the same tokens.
        cpu = ServeEngine(cfg, max_batch=4, device="cpu")
        cpu.start(CheckpointManager(ckpt_dir), 0, eng.params, lazy=True)
        check({k: cpu.cold_start_stats[k] for k in ("first_fetch_compressed_bytes", "read_amplification")}
              == {k: stats[k] for k in ("first_fetch_compressed_bytes", "read_amplification")},
              "cold-start stats on cpu vs cuda")
        for pr in serve_prompts(cfg, 8, 16, seed=0):
            cpu.submit(pr, max_new_tokens=8)
        cpu_done = []
        while cpu.queue:
            cpu_done += cpu.step_batch()
        check([r.out_tokens for r in done] == [r.out_tokens for r in cpu_done],
              "cold-start tokens on the card vs the CPU")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    out = dict(arch=cfg.name, k3_launches=launches, requests=len(done),
               tokens_equal_cpu=True, **{k: v for k, v in stats.items()})
    emit("cold_start", **out)
    return out


def train_parity(arch: str, mesh=None) -> dict:
    """One float32 train step of ``arch``'s smoke config on the card and on
    the CPU, from params drawn on the CPU from seed 0; with ``mesh``, both
    steps are the mesh step inside its sharding context."""
    import dataclasses

    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.data.synthetic import make_batch
    from repro_torch.distributed.api import sharding_context
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.models.params import tree_leaves_with_path, tree_map
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    lr = TRAIN_PARITY["lr"]
    _, step = make_train_step(cfg, mesh, opt=AdamWConfig(lr=lr, warmup_steps=0, total_steps=10),
                              n_micro=TRAIN_PARITY["n_micro"])
    runs = {}
    for dev in ("cpu", "cuda"):
        state = init_train_state(cfg, torch.Generator().manual_seed(0))
        params, opt_state = tree_map(lambda x: x.to(dev), state)
        batch = make_batch(cfg, TRAIN_PARITY["seq_len"], TRAIN_PARITY["batch"], kind="train",
                           seed=1, device=dev)
        with (sharding_context(mesh, ShardingRules(cfg, mesh).logical_mapping())
              if mesh is not None else contextlib.nullcontext()):
            _, opt_state, metrics = step(params, opt_state, batch)
        runs[dev] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                     [x.cpu() for _, x in tree_leaves_with_path(opt_state["master"])])
    (lc, gc_, mc), (lg, gg, mg) = runs["cpu"], runs["cuda"]
    loss_rel, gnorm_rel = abs(lg - lc) / abs(lc), abs(gg - gc_) / gc_
    master_err = max(float((a - b).abs().max()) for a, b in zip(mc, mg))
    out = dict(arch=cfg.name, remat=cfg.remat, loss=lg, loss_rel=loss_rel,
               grad_norm=gg, grad_norm_rel=gnorm_rel, master_max_abs_diff=master_err,
               mesh=None if mesh is None else dict(mesh.shape))
    check(loss_rel <= 1e-5, f"train parity {arch}: loss {lg} on cuda vs {lc} on cpu")
    check(gnorm_rel <= 1e-4, f"train parity {arch}: grad_norm {gg} on cuda vs {gc_} on cpu")
    check(master_err <= 2 * lr + 1e-6, f"train parity {arch}: master differs by {master_err}")
    return out


def train_restart() -> dict:
    """tests/test_train.py's restart on deepseek_7b's smoke config, on the card."""
    import shutil
    import tempfile

    from repro_torch.configs import get_smoke
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import SimulatedFailure, run_train

    cfg = get_smoke("deepseek_7b")
    kw = dict(steps=20, seq_len=32, batch=4, ckpt_every=10, log_every=1, device="cuda",
              opt=AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=20))
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        ref = run_train(cfg, ckpt_dir=f"{root}/ref", **kw)
        try:
            run_train(cfg, ckpt_dir=f"{root}/ft", fail_at_step=13, async_save=True, **kw)
            check(False, "fail_at_step=13 raised no SimulatedFailure")
        except SimulatedFailure:
            pass
        res = run_train(cfg, ckpt_dir=f"{root}/ft", **kw)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    diff = abs(res.losses[20] - ref.losses[20])
    check(res.resumed_from == 10 and res.steps_run == 10, f"resumed from {res.resumed_from}")
    check(diff <= 1e-4, f"restart: loss[20] {res.losses[20]} vs {ref.losses[20]}")
    return dict(arch=cfg.name, resumed_from=res.resumed_from, loss_20=res.losses[20],
                loss_20_uninterrupted=ref.losses[20], abs_diff=diff,
                equal_losses_11_20=all(res.losses[s] == ref.losses[s] for s in range(11, 21)))


def profile_train_step(step, params, opt_state, batch) -> dict:
    """Device busy time against wall time for one train step, from a
    ``torch.profiler`` trace (kernel events only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt_state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return device_summary(prof, wall, top=5)


def train_full_width() -> dict:
    """granite_moe_1b at full width: run_train for 8 steps (each synchronised
    and timed; every loss finite), then n_micro 1 against 2 from one state,
    8 steps over one batch whose loss must fall, a profiled step, and the
    peak memory of a step with and without remat.

    The run's own loss is reported, not gated: in 8 steps of fresh batches
    over a 49,155-token vocabulary the cross-entropy barely moves, and the
    router's load-balancing term (summed over 24 layers) rises as the
    routers leave their initial balance, in float32 as in bf16 and at
    learning rates 1e-4 to 1e-3."""
    import dataclasses

    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.params import tree_leaves_with_path
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import loop
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = get_config("granite_moe_1b")
    opt = AdamWConfig(**TRAIN_FULL_OPT)
    tokens = TRAIN_FULL["batch"] * TRAIN_FULL["seq_len"]
    walls = []

    def timed(make):
        def make_timed(*a, **kw):
            model, step = make(*a, **kw)

            def run(*args):
                t = time.perf_counter()
                out = step(*args)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
                return out
            return model, run
        return make_timed

    def fresh_state():
        gc.collect()
        torch.cuda.empty_cache()
        return init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0))

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with patched(loop, "make_train_step", timed):
        res = loop.run_train(cfg, log_every=1, opt=opt, device="cuda", **TRAIN_FULL)
    launches = launch_counts()
    peak_block = torch.cuda.max_memory_allocated()
    losses = [res.losses[s] for s in range(1, TRAIN_FULL["steps"] + 1)]
    check(all(np.isfinite(losses)), f"granite losses {losses}")
    check_train_launches(launches, "the training path", moe=True)

    # n_micro 1 against 2 from one state and batch; then the n_micro=2 run
    # goes on over the same batch, whose loss must fall, and one more step
    # is traced
    batch = make_batch(cfg, TRAIN_FULL["seq_len"], TRAIN_FULL["batch"], kind="train", seed=0,
                       device="cuda")
    new = {}
    for n_micro in (1, 2):
        params, opt_state = fresh_state()
        _, step = make_train_step(cfg, opt=opt, n_micro=n_micro)
        params, opt_state, m = step(params, opt_state, batch)
        new[n_micro] = [x.clone() for _, x in tree_leaves_with_path(params)], float(m["loss"])
        if n_micro == 1:
            del params, opt_state, m
    micro_diff = max(float((a.float() - b.float()).abs().max())
                     for a, b in zip(new[1][0], new[2][0]))
    check(micro_diff <= 2e-2, f"n_micro 1 vs 2: params differ by {micro_diff}")
    micro_losses = {n: new[n][1] for n in new}
    del new
    same_batch = [micro_losses[2]]
    for _ in range(TRAIN_FULL["steps"] - 1):
        params, opt_state, m = step(params, opt_state, batch)
        same_batch.append(float(m["loss"]))
    check(all(np.isfinite(same_batch)) and same_batch[-1] < same_batch[0],
          f"granite loss over one repeated batch did not fall: {same_batch}")
    prof = profile_train_step(step, params, opt_state, batch)
    del params, opt_state, step, m

    params, opt_state = fresh_state()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, step = make_train_step(dataclasses.replace(cfg, remat="none"), opt=opt,
                              n_micro=TRAIN_FULL["n_micro"])
    step(params, opt_state, batch)
    torch.cuda.synchronize()
    peak_none = torch.cuda.max_memory_allocated()
    _, step = make_train_step(cfg, opt=opt, n_micro=TRAIN_FULL["n_micro"])
    torch.cuda.reset_peak_memory_stats()
    step(params, opt_state, batch)
    torch.cuda.synchronize()
    peak_block_step = torch.cuda.max_memory_allocated()
    del params, opt_state, step
    gc.collect()
    torch.cuda.empty_cache()

    n_params = cfg.param_count()
    return dict(
        arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model, params=n_params,
        experts=cfg.moe.n_experts, top_k=cfg.moe.top_k, remat=cfg.remat,
        attn_impl=cfg.attn_impl, compute_dtype=cfg.compute_dtype, **TRAIN_FULL, opt=TRAIN_FULL_OPT,
        launches=launches, losses=losses, loss_fell=losses[-1] < losses[0],
        same_batch_losses=same_batch, step_wall_s=walls,
        step_wall_mean_s_after_first=sum(walls[1:]) / len(walls[1:]),
        tokens_per_s=tokens * len(walls[1:]) / sum(walls[1:]), run_wall_s=res.wall_s,
        peak_memory_bytes_remat_block=peak_block, peak_memory_bytes_step_remat_block=peak_block_step,
        peak_memory_bytes_step_remat_none=peak_none, state_bytes_before_step=base,
        n_micro_1_vs_2_max_abs_param_diff=micro_diff, n_micro_losses=micro_losses,
        profile=prof,
    )


def phase_train() -> dict:
    """The training path on the card: (a) CPU parity on seven smoke configs,
    (b) exact restart, (c) granite_moe_1b at full width, (d) the kernel
    wrappers refuse autograd."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    out = {"parity": [train_parity(arch) for arch in TRAIN_PARITY_ARCHS],
           "restart": train_restart(), "full_width": train_full_width()}
    q = torch.randn(1, 2, 128, 64, device="cuda", requires_grad=True)
    k, v = torch.randn(2, 1, 2, 128, 64, device="cuda")
    before = fa.flash_attention_bhtd.launches
    try:
        ops.flash_attention(q, k, v, scale=0.125)
        refused = False
    except NotImplementedError:
        refused = True
    check(refused and fa.flash_attention_bhtd.launches == before,
          "ops.flash_attention under autograd on cuda did not refuse")
    with torch.no_grad():
        check(bool(torch.isfinite(ops.flash_attention(q, k, v, scale=0.125)).all()),
              "ops.flash_attention under no_grad")
    out["autograd_refused"] = refused
    emit("train", **out)
    return out


def mesh_moe_layer(mesh, mapping) -> dict:
    """(a) One granite_moe_1b MoE layer at full width, float32, inside the
    context: the card's per-shard slots against route_topk on the CPU from
    the card's own logits, y against the port's CPU apply_moe."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.api import sharding_context
    from repro_torch.models import moe
    from repro_torch.models.params import tree_map

    cfg = get_config("granite_moe_1b")
    m = cfg.moe
    b, t = MESH_TOKENS["batch"], MESH_TOKENS["seq"]
    n_tok = b * t
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = moe.init_moe(gen, cfg)
    x = torch.randn(b, t, cfg.d_model, generator=gen, device="cuda")
    seen = []

    def record(fn):
        def run(logits, k, capacity):
            out = fn(logits, k, capacity)
            seen.append((logits.cpu(), out[0].cpu(), capacity))
            return out
        return run

    with sharding_context(mesh, mapping):
        dp = moe.data_shards(n_tok)
        with patched(moe, "route_topk", record):
            y, aux = moe.apply_moe(p, x, cfg)
            torch.cuda.synchronize()
        y_cpu, aux_cpu = moe.apply_moe(tree_map(lambda a: a.cpu(), p), x.cpu(), cfg)
    check(len(seen) == 1, f"route_topk calls: {len(seen)}")
    (logits, slots, cap), = seen
    check(dp > 1 and tuple(logits.shape) == (dp, n_tok // dp, m.n_experts),
          f"per-shard routing not taken: dp {dp}, logits {tuple(logits.shape)}")
    mismatched = sum(int((moe.route_topk(logits[i], m.top_k, cap)[0] != slots[i]).sum())
                     for i in range(dp))
    check(mismatched == 0, f"{mismatched} per-shard slots differ from route_topk on the CPU")
    shard_drop = (slots == m.n_experts * cap).reshape(n_tok, m.top_k)
    g_cap = max(int(n_tok * m.top_k / m.n_experts * m.capacity_factor), m.top_k)
    g_slot = moe.route_topk(logits.reshape(n_tok, m.n_experts), m.top_k, g_cap)[0]
    global_drop = g_slot == m.n_experts * g_cap
    err = float((y.cpu() - y_cpu).abs().max())
    scale = float(y_cpu.abs().max())
    check(bool(torch.isfinite(y).all()) and err <= MESH_MOE_TOL * scale,
          f"MoE layer under the mesh: card vs CPU {err} at max |y| {scale}")
    return dict(tokens=n_tok, dp=dp, capacity_per_shard=cap, capacity_global=g_cap,
                choices=n_tok * m.top_k, slots_mismatched=mismatched,
                dropped_per_shard=int(shard_drop.sum()), dropped_global=int(global_drop.sum()),
                dropped_both=int((shard_drop & global_drop).sum()),
                dropped_by_shard=shard_drop.reshape(dp, -1).sum(1).tolist(),
                y_max_abs_diff=err, y_max_abs=scale, limit=MESH_MOE_TOL * scale,
                aux=float(aux), aux_cpu=float(aux_cpu), aux_abs_diff=abs(float(aux) - float(aux_cpu)))


def mesh_prefill(mesh, mapping) -> dict:
    """(b) Two bf16 prefills of 4 x 512 tokens inside the context through K3
    (the main path: every kernel count set to 0 just before, read just
    after), then a profiled prefill and K3 against ``chunked`` in float32."""
    import dataclasses

    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.distributed.api import sharding_context
    from repro_torch.models import model_for, moe

    cfg = dataclasses.replace(get_config("granite_moe_1b"), attn_impl="pallas")
    model = model_for(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    prompts = serve_prompts(cfg, MESH_TOKENS["batch"], MESH_TOKENS["seq"], seed=0)
    toks = torch.from_numpy(np.stack(prompts).astype(np.int32)).cuda()
    drops = {"dropped": torch.zeros((), dtype=torch.int64, device="cuda"), "choices": 0,
             "calls": 0, "shards": set(), "logits": []}

    def count(fn):
        def run(logits, k, capacity):
            slot, gate, eids, aux = fn(logits, k, capacity)
            drops["dropped"] += (slot == logits.shape[-1] * capacity).sum()
            drops["choices"] += slot.numel()
            drops["calls"] += 1
            drops["shards"].add(logits.shape[0] if logits.dim() == 3 else 1)
            if drops["calls"] <= cfg.n_layers:  # the first prefill's, for the one-device drops
                drops["logits"].append(logits.clone())
            return slot, gate, eids, aux
        return run

    walls = []
    with sharding_context(mesh, mapping):
        with patched(moe, "route_topk", count):
            kernels.reset_launches()
            for _ in range(2):
                t0 = time.perf_counter()
                logits, _ = model.prefill(params, {"tokens": toks}, cache_len=toks.shape[1] + 1)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            launches = launch_counts()
        check(bool(torch.isfinite(logits.float()).all()), "mesh prefill logits finite")
        k3 = launches["flash_attention_bhtd"]
        check(k3 == 2 * cfg.n_layers and k3 > 0, f"K3 launches on the mesh prefill: {k3}")
        check(drops["shards"] == {mesh.shape["data"]}, f"routed shards {drops['shards']}")
        prof = profile_prefill_and_decode(model, params, prompts)
        f32 = f32_pallas_vs_chunked(cfg, params, prompts)
    # the first prefill's router logits routed as the one-device branch would
    m = cfg.moe
    n_tok = toks.numel()
    g_cap = max(int(n_tok * m.top_k / m.n_experts * m.capacity_factor), m.top_k)
    one_device = sum(int((moe.route_topk(lg.reshape(n_tok, -1), m.top_k, g_cap)[0]
                          == m.n_experts * g_cap).sum()) for lg in drops["logits"])
    del params, drops["logits"]
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, batch=MESH_TOKENS["batch"], prompt_len=MESH_TOKENS["seq"],
                compute_dtype=cfg.compute_dtype, prefill_wall_s=walls, launches=launches,
                k3_launches=k3, shards=sorted(drops["shards"]), router_calls=drops["calls"],
                choices=drops["choices"], dropped=int(drops["dropped"]),
                dropped_share=int(drops["dropped"]) / max(drops["choices"], 1),
                first_prefill_dropped_one_device_branch=one_device,
                first_prefill_choices=n_tok * m.top_k * cfg.n_layers,
                profile=prof, f32_check=f32)


def mesh_train(mesh, mapping) -> dict:
    """(c) granite_moe_1b's full-width step with phase train's recipe: the mesh
    step outside the context against the mesh=None step, bit for bit; then
    TRAIN_FULL's steps inside the context, each synchronised and timed, over
    fresh batches, its peak memory and a profiled step; then the float32
    smoke step inside the context, card against CPU."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.distributed.api import sharding_context
    from repro_torch.models.params import tree_leaves_with_path
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = get_config("granite_moe_1b")
    opt = AdamWConfig(**TRAIN_FULL_OPT)
    seq, bsz, n_micro = TRAIN_FULL["seq_len"], TRAIN_FULL["batch"], TRAIN_FULL["n_micro"]

    def fresh_state():
        gc.collect()
        torch.cuda.empty_cache()
        return init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0))

    def leaves(tree):
        return [x for _, x in tree_leaves_with_path(tree)]

    batch = make_batch(cfg, seq, bsz, kind="train", seed=0, device="cuda")
    params, opt_state = fresh_state()
    _, plain = make_train_step(cfg, None, opt=opt, n_micro=n_micro)
    params, opt_state, m = plain(params, opt_state, batch)
    want = ([x.clone() for x in leaves(params)], [x.clone() for x in leaves(opt_state["master"])],
            {k: m[k].clone() for k in ("loss", "grad_norm", "ce_last")})
    del params, opt_state, m, plain
    params, opt_state = fresh_state()
    _, step = make_train_step(cfg, mesh, opt=opt, n_micro=n_micro)
    params, opt_state, m = step(params, opt_state, batch)
    same = (all(torch.equal(a, b) for a, b in zip(want[0], leaves(params)))
            and all(torch.equal(a, b) for a, b in zip(want[1], leaves(opt_state["master"])))
            and all(torch.equal(want[2][k], m[k]) for k in want[2]))
    check(same, "the mesh step outside the context differs from the mesh=None step")
    del want

    walls, losses = [], []
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with sharding_context(mesh, mapping):
        kernels.reset_launches()
        for s in range(TRAIN_FULL["steps"]):
            batch = make_batch(cfg, seq, bsz, kind="train", seed=s + 1, device="cuda")
            t0 = time.perf_counter()
            params, opt_state, m = step(params, opt_state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        prof = profile_train_step(step, params, opt_state, batch)
    check(all(np.isfinite(losses)), f"granite losses under the mesh {losses}")
    check_train_launches(launches, "the mesh training path", moe=True)
    del params, opt_state, step, m
    gc.collect()
    torch.cuda.empty_cache()
    tokens = bsz * seq
    return dict(arch=cfg.name, params=cfg.param_count(), remat=cfg.remat, attn_impl=cfg.attn_impl,
                compute_dtype=cfg.compute_dtype, **TRAIN_FULL, opt=TRAIN_FULL_OPT,
                mesh_step_without_context_bit_equal=same, launches=launches, losses=losses,
                step_wall_s=walls, step_wall_mean_s_after_first=sum(walls[1:]) / len(walls[1:]),
                tokens_per_s=tokens * len(walls[1:]) / sum(walls[1:]),
                peak_memory_bytes_steps=peak, profile=prof,
                parity_f32_smoke=train_parity("granite_moe_1b", mesh))


def phase_mesh(train: dict) -> dict:
    """granite_moe_1b at full width under the production (16, 16) mesh on the
    card: (a) one MoE layer, (b) the prefill through K3, (c) the train step;
    each beside phase train's numbers from this run."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import ShardingRules, axis_size, data_axes
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh()
    mapping = ShardingRules(get_config("granite_moe_1b"), mesh).logical_mapping()
    check(axis_size(mesh, data_axes(mesh)) == 16 and mapping == {"data": ("data",), "model": ("model",)},
          f"production mesh {mesh.shape}, mapping {mapping}")
    full = train["full_width"]
    out = {"mesh": dict(mesh.shape), "moe_layer": mesh_moe_layer(mesh, mapping),
           "prefill": mesh_prefill(mesh, mapping), "train": mesh_train(mesh, mapping)}
    out["train_phase"] = {k: full[k] for k in (
        "step_wall_mean_s_after_first", "tokens_per_s", "peak_memory_bytes_step_remat_block",
        "profile")}
    emit("mesh", **out)
    return out


def sentinel_buffer(like, device):
    """A non-root position's buffer before the broadcast, every byte 0xFF
    (NaN in bf16 and f32, -1 in int8), in place of ``torch.empty``."""
    import torch

    buf = torch.empty(like.shape, dtype=like.dtype, device=device)
    buf.view(torch.uint8).fill_(0xFF)
    return buf


def same_bytes(a, b) -> bool:
    import torch

    return a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def positions_equal_root(columns) -> bool:
    """Every position of every column bit-equal to its column's root."""
    return all(same_bytes(b, col[0]) for col in columns for b in col[1:])


def broadcast_variant(params, mesh, schedule: str, compress: bool) -> dict:
    """One schedule at full width: a checked run from sentinel buffers, then
    an unpatched run timed by the host clock with its peak memory, then the
    position-buffer copies alone timed by CUDA events."""
    import torch

    from repro_torch.distributed import broadcast as bc
    from repro_torch.models.params import tree_leaves_with_path
    from repro_torch.optim.compress import dequantize_int8, quantize_int8

    rounds, ser, copied_want = BCAST_EXPECT[(schedule, compress)]
    kw = dict(schedule=schedule, n_blocks=BCAST_BLOCKS, compress=compress, return_buffers=True)
    with patched(bc, "_stale_buffer", lambda _: sentinel_buffer):
        res, rep, (bufs, scale_bufs) = bc.tree_broadcast(params, mesh, **kw)
    check((rep.rounds, rep.serialized_bytes) == (rounds, ser),
          f"broadcast {schedule}: rounds {rep.rounds}, serialized {rep.serialized_bytes}")
    check(positions_equal_root(bufs + (scale_bufs or [])),
          f"broadcast {schedule}: a position differs from the root")
    leaves = [x for _, x in tree_leaves_with_path(params)]
    got = [x for _, x in tree_leaves_with_path(res)]
    if compress:
        flat, spec = bc.flatten_pytree(params, pad_to=BCAST_BLOCKS)
        q, scale = quantize_int8(flat.view(BCAST_BLOCKS, -1))
        check(same_bytes(bufs[0][0], q.reshape(-1)) and same_bytes(scale_bufs[0][0], scale),
              "broadcast int8: the root's payload or scales differ from quantize_int8")
        del flat
        want = bc.unflatten_pytree(dequantize_int8(q, scale).reshape(-1), spec)
        want = [x for _, x in tree_leaves_with_path(want)]
        del q
    else:
        want = [x.to(torch.bfloat16).to(x.dtype) for x in leaves]
    check(len(got) == len(want) and all(same_bytes(g, w) for g, w in zip(got, want)),
          f"broadcast {schedule} compress={compress}: the returned tree differs")
    del res, bufs, scale_bufs, got, want
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res, rep, (bufs, scale_bufs) = bc.tree_broadcast(params, mesh, **kw)
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    del res
    dp = len(bufs[0])
    info = {"binomial": bc.binomial_rounds(dp),
            "pipelined": bc.faasnet_rounds(dp, BCAST_BLOCKS)}.get(schedule)

    def copies():
        return sum(bc.broadcast_buffers(col, dp=dp, schedule=schedule, n_blocks=BCAST_BLOCKS,
                                        rounds_info=info) for col in bufs + (scale_bufs or []))

    copied = copies()  # warm
    check(copied == copied_want, f"broadcast {schedule}: {copied} bytes copied")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(BCAST_REPS):
        start.record()
        copies()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    del bufs, scale_bufs
    gc.collect()
    torch.cuda.empty_cache()
    ms = float(np.median(times))
    bound = 2 * copied / HBM_BYTES_PER_S * 1e3
    return dict(schedule=schedule, compress=compress, rounds=rep.rounds, dp=rep.dp,
                n_blocks=rep.n_blocks, payload_bytes=rep.payload_bytes,
                serialized_bytes=rep.serialized_bytes, bytes_copied=copied,
                device_ms=ms, device_ms_reps=times, hbm_bound_ms=bound,
                achieved_bytes_per_s=2 * copied / (ms * 1e-3),
                modeled_ms_h100_nvlink_one_way=rep.modeled_time_s(H100_NVLINK_ONE_WAY) * 1e3,
                host_ms_tree_broadcast=host, peak_memory_bytes=peak,
                memory_before_bytes=base)


def broadcast_full_width() -> dict:
    """granite_moe_1b's full weights to the 8 positions of an (8, 1) mesh on
    one card, by every schedule and by int8 ``pipelined``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model_for
    from repro_torch.models.params import tree_leaves_with_path

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("granite_moe_1b")
    params = model_for(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    n = sum(x.numel() for _, x in tree_leaves_with_path(params))
    check(n == BCAST_PARAMS, f"granite_moe_1b has {n} parameters")
    mesh = make_mesh(BCAST_MESH, ("data", "model"), device="cuda")
    runs = [broadcast_variant(params, mesh, s, c) for s, c in BCAST_EXPECT]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, params=n, mesh=list(BCAST_MESH), n_blocks=BCAST_BLOCKS,
                block_bytes=2 * n // BCAST_BLOCKS, link_bw=H100_NVLINK_ONE_WAY,
                hbm_bytes_per_s=HBM_BYTES_PER_S, runs=runs)


def broadcast_smoke_vs_cpu() -> dict:
    """The smoke config (and a 3-element leaf, so the image is padded) on a
    (4, 2) mesh: every position's buffers and the returned tree bit-equal on
    the card and on the CPU, for every variant."""
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.distributed import broadcast as bc
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model_for
    from repro_torch.models.params import tree_leaves_with_path, tree_map

    gen = torch.Generator().manual_seed(0)
    params = {"model": model_for(get_smoke("granite_moe_1b")).init(gen),
              "odd": torch.randn(3, generator=gen)}
    _, spec = bc.flatten_pytree(params, pad_to=BCAST_SMOKE["n_blocks"])
    check(spec.pad > 0, "smoke broadcast: the image is not padded")
    runs = {}
    for schedule, compress in BCAST_EXPECT:
        got = {}
        for dev in ("cpu", "cuda"):
            mesh = make_mesh(BCAST_SMOKE["mesh"], ("data", "model"), device=dev)
            p = tree_map(lambda x: x.to(dev), params)
            with patched(bc, "_stale_buffer", lambda _: sentinel_buffer):
                res, rep, (bufs, scale_bufs) = bc.tree_broadcast(
                    p, mesh, schedule=schedule, n_blocks=BCAST_SMOKE["n_blocks"],
                    compress=compress, return_buffers=True)
            got[dev] = ([x.cpu() for _, x in tree_leaves_with_path(res)],
                        [b.cpu() for col in bufs + (scale_bufs or []) for b in col], rep)
            check(positions_equal_root(bufs + (scale_bufs or [])),
                  f"smoke broadcast {schedule} on {dev}: a position differs from the root")
        (lc, bc_, rc), (lg, bg, rg) = got["cpu"], got["cuda"]
        equal = (rc == rg and len(bc_) == len(bg) and all(map(same_bytes, bc_, bg))
                 and len(lc) == len(lg) and all(map(same_bytes, lc, lg)))
        check(equal, f"smoke broadcast {schedule} compress={compress}: card and CPU differ")
        runs[f"{schedule}{'_int8' if compress else ''}"] = dict(
            rounds=rg.rounds, serialized_bytes=rg.serialized_bytes, buffers=len(bg),
            equal_to_cpu=equal)
    return dict(arch="granite_moe_1b_smoke", leaves=len(spec.sizes), total=spec.total, pad=spec.pad,
                **BCAST_SMOKE, runs=runs)


def elastic_example() -> dict:
    """``examples/torch_elastic_train.py`` on the card, in a process of its own."""
    proc = subprocess.run([sys.executable, "examples/torch_elastic_train.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"torch_elastic_train.py exited {proc.returncode}: "
                                f"{proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    resumed = [ln for ln in lines if "resumed from step" in ln]
    check(lines[-1] == "OK" and len(resumed) == 1, "torch_elastic_train.py did not end with OK")
    words = resumed[0].split()
    step, loss = int(words[3].rstrip(",")), float(words[-1])
    check(step == 10 and np.isfinite(loss), f"elastic example: {resumed[0]}")
    return dict(resumed_from=step, loss_20=loss,
                section_3=[ln.strip() for ln in lines if "serialized" in ln or "link model" in ln])


def phase_broadcast() -> dict:
    """The device-plane weight broadcast: (a) granite_moe_1b's full weights,
    (b) the smoke config card against CPU, (c) the elastic-training example on
    the card.  No kernel launches on this path."""
    from repro_torch import kernels

    kernels.reset_launches()
    out = {"full_width": broadcast_full_width(), "smoke_vs_cpu": broadcast_smoke_vs_cpu(),
           "elastic_example": elastic_example()}
    launches = launch_counts()
    check(not any(launches.values()), f"a kernel launched on the broadcast path: {launches}")
    out["launches"] = launches
    emit("broadcast", **out)
    return out


def dryrun_production_cells(outdir: Path) -> list:
    """(a) Three production cells traced on meta, each roofline and its
    collective bytes by source printed; the tensor-parallel term is > 0 in
    each (mamba2_130m splits no param over tp 16, but its logits' padded
    vocab split is gathered on the way out)."""
    from repro_torch.launch import dryrun

    out = []
    for arch, shape in DRYRUN_CELLS:
        t0 = time.perf_counter()
        r = dryrun.run_cell(arch, shape, "single", str(outdir))
        host_s = time.perf_counter() - t0
        roof = r["roofline"]
        terms = [roof[k] for k in ("compute_s", "memory_s", "collective_s", "bound_s",
                                   "roofline_fraction")]
        check(all(np.isfinite(terms)) and r["memory"]["argument_size_in_bytes"] > 0,
              f"dry run {arch} {shape}: roofline {roof}, memory {r['memory']}")
        by_source = {src: v["bytes_by_kind"] for src, v in r["collectives"]["by_source"].items()}
        tp = r["collectives"]["by_source"]["tp"]["collective_bytes"]
        check(r["collectives"]["collective_model"] == "zero1+tp" and tp > 0,
              f"dry run {arch} {shape}: tensor-parallel bytes {tp}")
        out.append({"arch": arch, "shape": shape, "host_s": host_s, "traces": r["traces"],
                    "program": r["program"], "memory": r["memory"], "roofline": roof,
                    "collectives": r["collectives"]["bytes_by_kind"], "by_source": by_source})
    return out


def measured_cell(arch: str, shape_args, n_micro, params_cache: dict) -> dict:
    """(b) One cell's dry-run prediction on a meta (1, 1) mesh beside the
    same step run on the card: FLOPs by FlopCounterMode equal to the meta
    trace's, the arguments' bytes equal to argument_size_in_bytes; device ms
    by CUDA events (median of DRYRUN_REPS after a warm-up), host wall, peak
    memory, and the measured share of the roofline."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import kernels
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.synthetic import make_batch
    from repro_torch.distributed.api import sharding_context
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import PEAK_FLOPS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model_for
    from repro_torch.models.params import tree_leaves_with_path
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.step import make_train_step

    shape = ShapeConfig(*shape_args)
    axes = ("data", "model")
    meta_mesh = make_mesh((1, 1), axes, device="meta")
    lowered, meta, cfg = dryrun.lower_cell(arch, shape, meta_mesh, n_micro=n_micro)
    t0 = time.perf_counter()
    pred = dryrun.analyze(lowered, meta, cfg, meta_mesh)
    predict_s = time.perf_counter() - t0

    mesh = make_mesh((1, 1), axes)
    model = model_for(cfg)
    if arch not in params_cache:  # bf16 params drawn on the card from seed 0
        params_cache.clear()
        gc.collect()
        torch.cuda.empty_cache()
        params_cache[arch] = dryrun.bf16_struct(
            model.init(torch.Generator(device="cuda").manual_seed(0)))
    params = params_cache[arch]
    batch = make_batch(cfg, shape.seq_len, shape.global_batch, kind=shape.kind, device="cuda")
    if shape.kind == "train":
        _, step = make_train_step(cfg, mesh, n_micro=n_micro)
        args = (params, init_opt_state(params), batch)
    elif shape.kind == "prefill":
        step, args = model.prefill, (params, batch)
    else:
        step = model.decode_step
        args = (params, batch, model.init_cache(shape.global_batch, shape.seq_len,
                                                device="cuda"))
    arg_bytes = sum(x.numel() * x.element_size() for a in args
                    for _, x in tree_leaves_with_path(a))

    def run():
        with sharding_context(mesh, lowered.rules.logical_mapping()):
            return step(*args)

    kernels.reset_launches()
    with FlopCounterMode(display=False) as fc:
        run()
        torch.cuda.synchronize()
    card_flops = fc.get_total_flops()
    run()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    device_ms, host_s = [], []
    for _ in range(DRYRUN_REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        host_s.append(time.perf_counter() - t0)
        device_ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    launches = launch_counts()
    del args, batch
    gc.collect()
    torch.cuda.empty_cache()

    check(card_flops == pred["program"]["flops"],
          f"{arch} {shape.name}: FlopCounterMode on the card {card_flops}, "
          f"the meta trace {pred['program']['flops']}")
    check(arg_bytes == pred["memory"]["argument_size_in_bytes"],
          f"{arch} {shape.name}: arguments {arg_bytes} bytes, the dry run "
          f"{pred['memory']['argument_size_in_bytes']}")
    check_train_launches(launches, f"{arch} {shape.name}", moe=cfg.moe is not None)
    roof = pred["roofline"]
    measured_s = float(np.median(device_ms)) / 1e3
    basis = pred["model_flops_basis"]
    model_flops = basis["multiplier"] * basis["active_params"] * basis["tokens"]
    return {"arch": arch, "shape": shape.name, "kind": shape.kind, "seq_len": shape.seq_len,
            "batch": shape.global_batch, "n_micro": n_micro, "attn_impl": cfg.attn_impl,
            "kv_cache_dtype": cfg.kv_cache_dtype, "predict_s": predict_s,
            "traces": pred["traces"], "flops": card_flops, "flops_equal": True,
            "argument_bytes": arg_bytes, "argument_bytes_equal": True,
            "program_bytes": pred["program"]["bytes_accessed"],
            "prediction": {k: roof[k] for k in roof if k != "hlo_flops_per_device"},
            "device_ms": device_ms, "device_ms_median": measured_s * 1e3, "host_s": host_s,
            "peak_memory_bytes": peak, "model_flops": model_flops,
            "measured_share": model_flops / (measured_s * PEAK_FLOPS),
            "roofline_fraction": roof["roofline_fraction"],
            "measured_over_bound": measured_s / roof["bound_s"]}


def tracked_on_card(shape_args, params) -> dict:
    """(b) deepseek_7b's step at one of DRYRUN_MEASURED's shapes on the
    production (16, 16) mesh: traced on meta (unscaled), then the card's real
    step run once inside the mesh's sharding_context under the sharding
    tracker, seeded with the card's tensors.  The collective records must be
    equal, kind, shape, dtype, layout and op: the tracker reads shapes and
    layouts, not the meta device."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.data.synthetic import make_batch
    from repro_torch.distributed.api import sharding_context
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import DATA, MODEL, analyze_callable
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import model_for

    shape = ShapeConfig(*shape_args)
    lowered, _, cfg = dryrun.lower_cell("deepseek_7b", shape, make_production_mesh(device="meta"))
    t0 = time.perf_counter()
    want = lowered.trace(lowered.layer_counts(), lowered.n_micro)[3]
    meta_s = time.perf_counter() - t0
    model = model_for(cfg)
    batch = make_batch(cfg, shape.seq_len, shape.global_batch, kind=shape.kind, device="cuda")
    if shape.kind == "prefill":
        step, args = model.prefill, (params, batch)
    else:
        step = model.decode_step
        args = (params, batch, model.init_cache(shape.global_batch, shape.seq_len,
                                                device="cuda"))
    tracker = lowered.tracker(args)
    t0 = time.perf_counter()
    with sharding_context(make_production_mesh(), lowered.rules.logical_mapping()):
        analyze_callable(step, *args, tracker=tracker)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    got = tracker.collectives
    del args, batch
    check(got == want and len(got) > 0,
          f"deepseek_7b {shape.name} on (16, 16): {len(got)} collectives on the card, "
          f"{len(want)} on meta; first difference "
          f"{next(((a, b) for a, b in zip(got, want) if a != b), None)}")
    sizes = {DATA: lowered.rules.dp_size, MODEL: lowered.rules.tp}
    kinds: dict = {}
    for c in got:
        kinds[c.kind] = kinds.get(c.kind, 0) + c.shard_bytes(sizes)
    return {"shape": shape.name, "collectives": len(got), "bytes_by_kind": kinds,
            "equal": True, "meta_s": meta_s, "card_s": card_s}


def broadcast_dryrun_cells(outdir: Path) -> list:
    """(c) The broadcast dry run of granite_moe_1b, both meshes, every
    schedule, its rounds equal to the port's round lists."""
    from repro_torch.distributed.broadcast import binomial_rounds, faasnet_rounds
    from repro_torch.launch import broadcast_dryrun

    out = []
    for mesh_kind, dp in (("single", 16), ("multi", 32)):
        want = {"naive": dp - 1, "allgather": 1, "binomial": len(binomial_rounds(dp)),
                "pipelined": len(faasnet_rounds(dp, BCAST_BLOCKS))}
        for schedule, compress in BCAST_DRYRUN:
            r = broadcast_dryrun.run_one("granite_moe_1b", mesh_kind, schedule, BCAST_BLOCKS,
                                         str(outdir), compress=compress)
            check(r["dp"] == dp and r["rounds"] == want[schedule],
                  f"broadcast dry run {mesh_kind} {r['schedule']}: dp {r['dp']}, "
                  f"rounds {r['rounds']}, want {want[schedule]}")
            out.append({k: r[k] for k in ("mesh", "schedule", "dp", "rounds", "collective_bytes",
                                          "collective_ops", "serialized_bytes_per_link")}
                       | {"modeled_ms": r["modeled_time_s"] * 1e3})
    return out


def phase_dryrun() -> dict:
    """The dry runs: (a) production cells on meta, (b) predictions against
    measured runs on the card, (c) the broadcast dry run."""
    outdir = ROOT / "results"
    t0 = time.perf_counter()
    out = {"production": dryrun_production_cells(outdir / "dryrun_torch")}
    out["production_s"] = time.perf_counter() - t0
    params_cache: dict = {}
    out["measured"] = [measured_cell(arch, shape, n_micro, params_cache)
                       for arch, shape, n_micro in DRYRUN_MEASURED]
    out["tracked"] = [tracked_on_card(shape, params_cache["deepseek_7b"])
                      for shape in DRYRUN_TRACKED]
    params_cache.clear()
    out["broadcast"] = broadcast_dryrun_cells(outdir / "broadcast_torch")
    emit("dryrun", **out)
    return out


def load_script(path: Path):
    """A ``benchmarks_torch/`` file, imported by its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"_benchmarks_torch_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def walls(port, ref, path: str = "") -> dict:
    """Every ``*wall_s`` key of the reference's artifact that the card's also
    has: path -> (the card's seconds, the reference's CPU seconds)."""
    out = {}
    if isinstance(ref, dict) and isinstance(port, dict):
        for key, val in ref.items():
            sub = f"{path}.{key}" if path else key
            if key not in port:
                continue
            if key.endswith("wall_s") and isinstance(val, float):
                out[sub] = (port[key], val)
            else:
                out.update(walls(port[key], val, sub))
    return out


def phase_benches() -> dict:
    """The paper's evaluation harness on the card, held against the
    reference scripts' outputs."""
    import torch

    from repro_torch.kernels import cap_chain as cc

    bench_dir, ref_dir = ROOT / "benchmarks_torch", ROOT / "benchmarks_torch" / "reference"
    compare = load_script(bench_dir / "compare.py")
    outdir = ROOT / "results" / "benches_torch"
    outdir.mkdir(parents=True, exist_ok=True)
    out = {"benches": {}, "figures": {}}
    for name, script, argv in BENCHES:
        mod = load_script(bench_dir / f"{script}.py")
        path = outdir / f"BENCH_torch_{name}.json"
        gc.collect()
        cc.reset_launches()
        t0 = time.perf_counter()
        mod.main([*argv, "--out", str(path)])  # in-bench assertions raise
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1 = cc.cap_chain_rates.launches
        port = json.loads(path.read_text())
        ref = json.loads((ref_dir / f"BENCH_{name}.json").read_text())
        diff = compare.artifact_diff(name, port, ref, skip=BENCH_SKIP.get(name, ()))
        check(diff == [], f"bench {name}: {len(diff)} fields differ from the reference: {diff[:5]}")
        check(k1 > 0, f"bench {name}: K1 never launched")
        dev = port["device"]
        check(sum(dev["k1_launches"].values()) == k1 and dev["power_limit"] != "cpu",
              f"bench {name}: device block {dev} vs {k1} launches")
        row = dict(script_wall_s=wall, k1_launches=k1, runs=dev["k1_launches"])
        emit("bench", name=name, card_script_wall_s=wall, k1_launches=k1,
             walls_card_vs_reference_cpu_s=walls(port, ref))
        out["benches"][name] = row

    figures = load_script(bench_dir / "paper_figures.py")
    want = (ref_dir / "paper_figures.csv").read_text().splitlines()
    for i, fn in enumerate(figures.ALL):
        cc.reset_launches()
        t0 = time.perf_counter()
        rows = fn()
        wall = time.perf_counter() - t0
        lines = [f"{name},{value:.4f},{derived}" for name, value, derived in rows]
        if i < HELD_FIGURES:  # every row, in the reference's order
            prefix = fn.__name__.split("_", 1)[0] + "/"
            ref_rows = [line for line in want if line.startswith(prefix)]
            check(lines == ref_rows, f"{fn.__name__}: {lines} vs the reference CSV's {ref_rows}")
        out["figures"][fn.__name__] = dict(wall_s=wall, k1_launches=cc.cap_chain_rates.launches,
                                           rows=len(rows), held=i < HELD_FIGURES)
    check(sum(f["k1_launches"] for f in out["figures"].values()) > 0, "K1 never launched in the figures")
    emit("benches", **out)
    return out


def time_k3(bh: int, t: int, hd: int, dtype: str = "bfloat16", window: int | None = None) -> dict:
    """K3 at one shape: the bf16 tensor-core instance or the float32 SIMT one,
    beside causal SDPA on the same inputs (with a ``window``, SDPA with the
    sliding-window mask as a boolean mask)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    q, k, v = k3_operands(bh, t, hd, dtype, seed=1)
    o = torch.empty_like(q)
    lib = _build.library("flash_attention")
    scale = hd**-0.5
    code = {"float32": 0, "bfloat16": 1}[dtype]

    def launch():
        rc = lib.repro_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                       bh, t, hd, code, scale, 2**31 - 1 if window is None else window,
                                       torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"K3 launch returned {rc}")

    b4 = [x.view(4, bh // 4, t, hd) for x in (q, k, v)]
    if window is None:
        sdpa = dict(is_causal=True)
    else:
        i = torch.arange(t, device="cuda")
        sdpa = dict(attn_mask=(i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window))
    out = dict(
        bh=bh, t=t, hd=hd, dtype=dtype, window=window,
        ms=graph_ms(launch, reps=50),
        plain_ms=event_ms(lambda: fa.flash_attention_torch(q, k, v, scale=scale, window=window), iters=20),
        wrapper_ms=event_ms(lambda: ops.flash_attention(*b4, scale=scale, window=window), iters=50),
        library_ms=event_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            *b4, scale=scale, **sdpa), iters=50),
    )
    # 4 BH hd flops a (query, key) pair the mask keeps (causal: about T^2 / 2
    # pairs), at the bf16 tensor rate or the f32 FMA rate (the f32 instance
    # runs no tensor core); q, k, v, o once each
    pairs = t * t / 2 if window is None else sum(min(r + 1, window) for r in range(t))
    width = q.element_size()
    out["bound_ms"], out["bound_by"] = bound_ms(
        4 * bh * t * hd * width, 4 * bh * pairs * hd,
        BF16_OPS_PER_S if dtype == "bfloat16" else FP32_OPS_PER_S)
    out["vs_library"] = out["ms"] / out["library_ms"]
    return out


def time_k4(bh: int, hd: int, sweep: bool = False) -> dict:
    """K4 at one decode shape, S 1024 with 528 slots valid, bf16, with a cold
    L2 (a rotation of operand sets): the tiled instance at the plan's split
    count, the first design (the generic instance, every slot) through its
    own C entry, in turns (new, old, old, new), each also warm (one set
    replayed); the plain version, the wrapper and SDPA with a boolean mask
    over the same rotation.  ``sweep`` adds the tiled instance at other
    split counts."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import decode_split_plan

    s = 1024
    n_valid = SERVE_PROMPT + SERVE_NEW
    nsets = cold_sets(2 * bh * s * hd * 2)
    valid1 = (torch.arange(s, device="cuda") < n_valid).to(torch.int32)
    sets = []
    for i in range(nsets):
        q, k, v = k4_operands(bh, s, hd, "bfloat16", seed=2 + i)
        sets.append((q, k, v, valid1[None].expand(bh, s).contiguous(), torch.empty_like(q)))
    lib = _build.library("decode_attention")
    scale = hd**-0.5
    nsplit = decode_split_plan(bh, s)[1]
    new = [k4_tiled_call(lib, q, k, v, valid, o, nsplit) for q, k, v, valid, o in sets]
    ws_old = torch.empty(bh * -(-s // da.GENERIC_SPLIT) * (hd + 2), dtype=torch.float32,
                         device="cuda")

    def old_call(q, k, v, valid, o):
        def launch():
            rc = lib.repro_decode_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), o.data_ptr(),
                ws_old.data_ptr(), bh, s, hd, da.GENERIC_SPLIT, 1, scale,
                torch.cuda.current_stream().cuda_stream)
            check(rc == 0, f"K4 generic launch returned {rc}")
        return launch

    old = [old_call(*st) for st in sets]
    reps = nsets * 20
    runs = [graph_ms(rotation(new), reps), graph_ms(rotation(old), reps),
            graph_ms(rotation(old), reps), graph_ms(rotation(new), reps)]
    # the timed launches computed the right thing
    for q, k, v, valid, o in sets[:1]:
        ok, err = within(o, da.decode_attention_torch(q, k, v, valid, scale=scale),
                         K4_TOL["bfloat16"], K4_TOL["bfloat16"])
        check(ok, f"K4 timed output at BH {bh} hd {hd}: max err {err}")
    b4 = [[x.view(4, bh // 4, x.shape[1], hd) for x in st[:3]] for st in sets]
    out = dict(
        bh=bh, s=s, hd=hd, valid_slots=n_valid, dtype="bfloat16", nsplit=nsplit,
        cold_sets=nsets, cold_bytes=nsets * 2 * bh * s * hd * 2,
        ms=(runs[0] + runs[3]) / 2, old_design_ms=(runs[1] + runs[2]) / 2, abba_ms=runs,
        warm_ms=graph_ms(new[0], reps=100), old_design_warm_ms=graph_ms(old[0], reps=100),
        plain_ms=event_ms(rotation([lambda st=st: da.decode_attention_torch(
            *st[:4], scale=scale) for st in sets]), iters=nsets * 5),
        wrapper_ms=event_ms(rotation([lambda x=x: ops.decode_attention(*x, valid1, scale=scale)
                                      for x in b4]), iters=reps),
        library_ms=event_ms(rotation([lambda st=st: torch.nn.functional.scaled_dot_product_attention(
            *st[:3], attn_mask=st[3].bool()[:, None, :], scale=scale) for st in sets]), iters=reps),
    )
    if sweep:
        out["nsplit_sweep_ms"] = {n: graph_ms(rotation([
            k4_tiled_call(lib, *st, n) for st in sets]), reps) for n in (1, 2, 3, 4, 6, 8, 16)}
    # q, the mask and o once; k and v of the valid slots only (the output does
    # not depend on the others); 4 BH S hd flops over the valid slots
    n_bytes = bh * hd * 2 * 2 + bh * s * 4 + 2 * bh * n_valid * hd * 2
    out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, 4 * bh * n_valid * hd, BF16_OPS_PER_S)
    del sets, b4
    torch.cuda.empty_cache()
    return out


def time_k5(dtype: str = "bfloat16") -> dict:
    """K5's three passes at mamba2_130m's full-width prefill shape: the bf16
    tensor-core instance, as the model runs it, or the float32 SIMT one."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss

    b, t, h, p, g, n, chunk = K5_SERVE
    ins = k5_operands(b, t, h, p, g, n, dtype, seed=5)
    x, dt, a, bm, cm = ssd_flat(*ins)
    dt, a = dt.contiguous(), a.contiguous()
    y = torch.empty_like(x)
    lib = _build.library("ssd_scan")
    bh = b * h
    ws = torch.empty(ss.workspace_floats(bh, t, p, n, chunk), dtype=torch.float32, device="cuda")

    def launch():  # the three passes
        rc = lib.repro_ssd_scan(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
                                cm.data_ptr(), y.data_ptr(), ws.data_ptr(), bh, t, p, n, chunk,
                                {"float32": 0, "bfloat16": 1}[dtype],
                                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"K5 launch returned {rc}")

    out = dict(
        bh=bh, t=t, p=p, n=n, chunk=chunk, dtype=dtype,
        ms=graph_ms(launch, reps=20),
        plain_ms=event_ms(lambda: ss.ssd_scan_torch(x, dt, a, bm, cm, q=chunk), iters=3),
        wrapper_ms=event_ms(lambda: ops.ssd_scan(*ins, chunk=chunk), iters=20),
        library_ms=None,  # no one PyTorch call computes the SSD scan
        passes_ms=pass_times(launch),
    )
    # x, B, C and y in their dtype, dt and a in f32, once each; per chunk of Q
    # the lower triangle of C B^T (N) and of G dtx (P), the state term and the
    # state update (2 Q P N each), 2 flops a multiply-add, at the bf16 tensor
    # rate or the f32 FMA rate
    q = chunk
    n_bytes = bh * t * (2 * p + 2 * n) * x.element_size() + bh * t * 4 + bh * 4
    tri = q * (q + 1) / 2
    n_ops = bh * (t // q) * (2 * tri * n + 2 * tri * p + 4 * q * p * n)
    out["bound_ms"], out["bound_by"] = bound_ms(
        n_bytes, n_ops, BF16_OPS_PER_S if dtype == "bfloat16" else FP32_OPS_PER_S)
    return out


def time_moe_route() -> dict:
    """The router's expert positions at granite_moe_1b's full batch: the
    kernel's two bare launches, the wrapper, and the plain one-hot cumsum."""
    import torch

    from repro_torch.kernels import _build, moe_route

    l, n, e, k, cap, _ = MOE_ROUTE_CASES["granite_moe_1b"]
    ids = moe_route_ids(l, n, e, k, skew=False)
    slot = torch.empty_like(ids)
    lib = _build.library("moe_route")
    counts = torch.empty(l * -(-n * k // lib.repro_expert_slots_tile()) * e, dtype=torch.int32,
                         device="cuda")

    def launch():
        rc = lib.repro_expert_slots(ids.data_ptr(), slot.data_ptr(), counts.data_ptr(), l, n * k,
                                    e, cap, torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"expert-slot launch returned {rc}")

    out = dict(l=l, n=n, e=e, k=k, capacity=cap, ms=graph_ms(launch),
               wrapper_ms=event_ms(lambda: moe_route.expert_slots(ids, e, cap)),
               plain_ms=event_ms(lambda: moe_route.expert_slots_torch(ids, e, cap), iters=20))
    # the ids in and the slots out, int32 each
    out["bound_ms"], out["bound_by"] = bound_ms(8 * l * n * k, 0, BF16_OPS_PER_S)
    return out


def pass_times(launch, reps: int = 10) -> dict:
    """Device ms a call of each of K5's three passes, from a ``torch.profiler``
    trace of ``reps`` calls of ``launch``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = next((k for k in ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")
                         if k in e.name), e.name[:60])
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return out


def phase_timings(giga: dict) -> dict:
    out = {
        "k1": {name: time_k1(ops) for name, (_, ops) in giga["fronts"].items()},
        "k2": time_k2(giga["k2_nodes_tensor"], giga["k2_nodes"]),
        "k3": time_k3(*K3_SERVE[:3]),
        "k3_hd256": time_k3(*K3_HD256),
        "k3_hd256_window": time_k3(*K3_HD256, window=GEMMA_WINDOW),
        "k3_f32": time_k3(*K3_SERVE[:3], dtype="float32"),
        "k3_f32_hd256": time_k3(*K3_HD256, dtype="float32"),
        "k3_whisper": time_k3(*K3_WHISPER),
        "k3_granite": time_k3(*K3_GRANITE),
        "k4": time_k4(*K4_SERVE[::2], sweep=True),
        "k4_other": [time_k4(bh, hd, sweep=True) for bh, hd in K4_OTHER],
        "k5": time_k5(),
        "k5_f32": time_k5("float32"),
        "moe_route": time_moe_route(),
    }
    emit("timings", **out)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir() or not (ROOT / "BENCH_scale.json").is_file():
        print(f"chip_smoke: run from the root of a checkout ({ROOT} has no src/repro_torch)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    bench = json.loads((ROOT / "BENCH_scale.json").read_text())
    t_start = time.perf_counter()

    # float32 products in full float32 (the defaults, stated): the f32 check
    # compares two attention paths, not TF32 rounding
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_s = {}

    def timed(phase, *args):  # seconds of each phase, for the script's time limit
        t0 = time.perf_counter()
        out = phase(*args)
        phase_s[phase.__name__.removeprefix("phase_")] = time.perf_counter() - t0
        return out

    smi, name = timed(phase_device)
    build = timed(phase_build)
    k1_err = timed(phase_kernels_vs_plain)
    k3_check = timed(phase_k3_vs_plain)
    k4_check = timed(phase_k4_vs_plain)
    k5_check = timed(phase_k5_vs_plain)
    paper = timed(phase_paper_tier, bench)
    giga = timed(phase_giga_tier, bench["giga_burst"])
    goldens = timed(phase_replay_goldens)
    replay = timed(phase_giga_replay, bench["giga_replay"])
    serve = timed(phase_serve_full_width)
    gemma = timed(phase_serve_gemma3_1b)
    mamba = timed(phase_serve_mamba2_130m)
    granite = timed(phase_serve_granite_moe_1b)
    whisper = timed(phase_serve_whisper_medium)
    cold = timed(phase_cold_start)
    train = timed(phase_train)
    mesh = timed(phase_mesh, train)
    timed(phase_broadcast)
    timed(phase_dryrun)
    benches = timed(phase_benches)
    times = timed(phase_timings, giga)

    src = "src/repro_torch/kernels/csrc/cap_chain.cu"
    mean, k2_t, k3_t, k4_t, k5_t = (times["k1"]["mean"], times["k2"], times["k3"], times["k4"],
                                    times["k5"])
    csrc = "src/repro_torch/kernels/csrc/"
    kernels = [
        {"name": "cap_chain_rates", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/cap_chain.py:102",
         "launches": giga["k1_launches"], "max_abs_err": k1_err,
         "ms": mean["ms"], "plain_ms": mean["plain_ms"],
         "bound_ms": mean["bound_ms"], "bound_by": mean["bound_by"], "library_ms": None,
         "on_main_path": True, "n": mean["n"], "front_ms": mean["front_ms"],
         "wrapper_ms": mean["wrapper_ms"], "widest": times["k1"]["widest"],
         "numpy_ms": mean["numpy_ms"], "paper_tier_launches": paper["k1_launches"],
         "replay_launches": replay["k1_launches"],
         "bench_launches": {k: v["k1_launches"] for k, v in benches["benches"].items()},
         "bench_launches_by_run": {k: v["runs"] for k, v in benches["benches"].items()},
         "figure_launches": {k: v["k1_launches"] for k, v in benches["figures"].items()},
         "replay_golden_launches": {k: v["k1_launches"] for k, v in goldens.items()}},
        {"name": "nic_flow_counts", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/cap_chain.py:137",
         "launches": giga["k2_launches"], "max_abs_err": 0.0,
         "ms": k2_t["ms"], "plain_ms": k2_t["plain_ms"],
         "bound_ms": k2_t["bound_ms"], "bound_by": k2_t["bound_by"],
         "library_ms": k2_t["library_ms"],
         "on_main_path": False, "n": k2_t["n"], "wrapper_ms": k2_t["wrapper_ms"],
         "timing": "cold L2", "warm_ms": k2_t["warm_ms"],
         "giga_plan": giga["k2_plan"], "registers": build["k2"].get("registers"),
         "spill_stores": build["k2"].get("spill_stores")},
        {"name": "flash_attention_bhtd", "route": "cuda", "source": csrc + "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:25",
         "launches": serve["k3_launches"], "max_abs_err": k3_check["serve_err"],
         "ms": k3_t["ms"], "plain_ms": k3_t["plain_ms"],
         "bound_ms": k3_t["bound_ms"], "bound_by": k3_t["bound_by"],
         "library_ms": k3_t["library_ms"], "library": "scaled_dot_product_attention",
         "on_main_path": True, "shape": [k3_t["bh"], k3_t["t"], k3_t["hd"]], "dtype": "bfloat16",
         "wrapper_ms": k3_t["wrapper_ms"], "granite_moe_1b_launches": granite["k3_launches"],
         "whisper_medium_launches": whisper["k3_launches"],
         "gemma3_1b_launches": gemma["k3_launches_by_kind"],
         "whisper_medium": {**times["k3_whisper"], **k3_check["whisper_medium"]},
         "cold_start_launches": cold["k3_launches"],
         "mesh_prefill_launches": mesh["prefill"]["k3_launches"],
         "granite_moe_1b": {**times["k3_granite"], **k3_check["granite_moe_1b"]},
         "hd256": times["k3_hd256"], "hd256_window": times["k3_hd256_window"],
         "f32": times["k3_f32"], "f32_hd256": times["k3_f32_hd256"], "instances": build["k3"]},
        {"name": "decode_attention_bhsd", "route": "cuda", "source": csrc + "decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:22",
         "launches": serve["launches"]["decode_attention_bhsd"], "max_abs_err": k4_check["serve_err"],
         "ms": k4_t["ms"], "plain_ms": k4_t["plain_ms"],
         "bound_ms": k4_t["bound_ms"], "bound_by": k4_t["bound_by"],
         "library_ms": k4_t["library_ms"], "library": "scaled_dot_product_attention (bool mask)",
         "on_main_path": False, "served_operand_launches": serve["k4_path"]["launches"],
         "shape": [k4_t["bh"], k4_t["s"], k4_t["hd"]], "dtype": "bfloat16",
         "wrapper_ms": k4_t["wrapper_ms"], "served_max_abs_err": serve["k4_path"]["max_abs_err"],
         "timing": "cold L2", "old_design_ms": k4_t["old_design_ms"], "warm_ms": k4_t["warm_ms"],
         "old_design_warm_ms": k4_t["old_design_warm_ms"], "abba_ms": k4_t["abba_ms"],
         "nsplit": k4_t["nsplit"], "nsplit_sweep_ms": k4_t["nsplit_sweep_ms"],
         "other_shapes": times["k4_other"], "instances": build["k4"]},
        {"name": "ssd_scan_bhtpn", "route": "cuda", "source": csrc + "ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:22",
         "launches": mamba["launches"]["ssd_scan_bhtpn"], "max_abs_err": k5_check["serve_err"],
         "ms": k5_t["ms"], "plain_ms": k5_t["plain_ms"],
         "bound_ms": k5_t["bound_ms"], "bound_by": k5_t["bound_by"], "library_ms": None,
         "on_main_path": False, "served_operand_launches": mamba["k5_path"]["launches"],
         "shape": [k5_t["bh"], k5_t["t"], k5_t["p"], k5_t["n"]],
         "chunk": k5_t["chunk"], "dtype": "bfloat16", "wrapper_ms": k5_t["wrapper_ms"],
         "served_max_rel_err": mamba["k5_path"]["max_rel_err_vs_model"],
         "worst_vs_tiled": k5_check["worst_vs_tiled"], "f32": times["k5_f32"],
         "instances": build["k5"]},
        {"name": "expert_slots", "route": "cuda", "source": csrc + "moe_route.cu",
         "replaces": None, "launches": granite["moe_route_launches"], "max_abs_err": 0.0,
         "ms": times["moe_route"]["ms"], "plain_ms": times["moe_route"]["plain_ms"],
         "bound_ms": times["moe_route"]["bound_ms"], "bound_by": times["moe_route"]["bound_by"],
         "library_ms": None, "on_main_path": True,
         "shape": [times["moe_route"][x] for x in ("l", "n", "k", "e", "capacity")],
         "dtype": "int32", "wrapper_ms": times["moe_route"]["wrapper_ms"]},
    ]
    # The engine keeps its per-NIC counts incrementally and never calls K2,
    # as in the JAX package; no model calls K4 or K5 (ops.py), which run on
    # operands recorded from the serves instead.  Every kernel a path calls
    # must have launched on it, and K4 and K5 on the recorded operands.
    for k in kernels:
        check(not k["on_main_path"] or k["launches"] > 0, f"{k['name']} never launched on the main path")
        check(k.get("served_operand_launches", 1) > 0, f"{k['name']} never launched on served operands")
        check(k.get("replay_launches", 1) > 0, f"{k['name']} never launched in the giga replay")
        check(all(n > 0 for n in k.get("bench_launches", {}).values()),
              f"{k['name']} never launched in a bench")
    emit("done", seconds=time.perf_counter() - t_start, phase_seconds=phase_s)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
