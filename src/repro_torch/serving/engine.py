"""Batched serving engine with FaaSNet cold-start integration.

A minimal-but-real batching server, as in the JAX package:
  * requests enter a queue; the batcher packs up to ``max_batch`` prompts
    (left-padded with token 0 to the longest, no padding mask) per prefill;
  * decode proceeds in lockstep for the batch until each request has its
    ``max_new_tokens``; the next token is the greedy argmax (first maximum);
  * **cold start** uses the paper's on-demand path: ``start()`` lazily
    restores only the leaves needed to begin (embedding + first stage +
    head) from the block checkpoint, then completes the restore (here
    synchronously; the fetch statistics show how many bytes the fast path
    needed — the Fig. 20 measurement on a real model).  One copy of the
    weights is held on the device: ``like`` may be a ``meta`` tree, and the
    partial tree's zeros are dropped before the rest is decoded.

The engine runs on ``device`` (the card by default; ``device="cpu"`` runs
the kernels' plain versions).  ``device="cuda"`` without CUDA raises.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.models import model_for

PyTree = Any


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (T,) int32
    max_new_tokens: int = 8
    out_tokens: list[int] = field(default_factory=list)
    t_submit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0


FIRST_LEAF_PRED = (
    lambda p: p.startswith("embed")
    or p.startswith("stages/0")
    or p.startswith("lm_head")
    or p.startswith("final_norm")
)


class ServeEngine:
    def __init__(self, cfg, *, max_batch: int = 4, max_len: int = 128,
                 device="cuda") -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ServeEngine(device='cuda'): CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        self.cfg = cfg
        self.model = model_for(cfg)
        self.max_batch = max_batch
        self.max_len = max_len
        self.params: Optional[PyTree] = None
        self.queue: deque[Request] = deque()
        self.done: list[Request] = []
        self.cold_start_stats: dict = {}
        self._rid = 0

    # ------------------------------------------------------------------
    # Cold start (paper §3.5 on-demand I/O applied to a model checkpoint)
    # ------------------------------------------------------------------
    def start(self, ckpt: CheckpointManager, step: int, like: PyTree,
              *, lazy: bool = True) -> None:
        t0 = time.monotonic()
        if lazy:
            partial_params, finish, reader = ckpt.restore_lazy(
                step, like, FIRST_LEAF_PRED, device=self.device
            )
            t_first = time.monotonic() - t0
            first_bytes = reader.stats.fetched_compressed
            del partial_params  # its zeros go before finish() decodes the rest
            self.params = finish()
            self.cold_start_stats = {
                "t_first_leaves_s": t_first,
                "t_full_s": time.monotonic() - t0,
                "first_fetch_compressed_bytes": first_bytes,
                "total_fetch_compressed_bytes": reader.stats.fetched_compressed,
                "read_amplification": reader.stats.amplification(),
            }
            reader.close()
        else:
            self.params = ckpt.restore(step, like, device=self.device)
            self.cold_start_stats = {"t_full_s": time.monotonic() - t0}

    def set_params(self, params: PyTree) -> None:
        self.params = params

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 8) -> int:
        self._rid += 1
        self.queue.append(
            Request(self._rid, np.asarray(prompt, np.int32), max_new_tokens,
                    t_submit=time.monotonic())
        )
        return self._rid

    def step_batch(self) -> list[Request]:
        """Serve one batch from the queue to completion. Returns finished."""
        assert self.params is not None, "engine not started"
        batch_reqs = [self.queue.popleft()
                      for _ in range(min(self.max_batch, len(self.queue)))]
        if not batch_reqs:
            return []
        t = max(len(r.prompt) for r in batch_reqs)
        b = len(batch_reqs)
        toks = np.zeros((b, t), np.int32)
        for i, r in enumerate(batch_reqs):
            toks[i, t - len(r.prompt):] = r.prompt  # left-pad
        budget = max(r.max_new_tokens for r in batch_reqs)
        cache_len = t + budget
        logits, cache = self.model.prefill(
            self.params, {"tokens": torch.from_numpy(toks).to(self.device)},
            cache_len=cache_len,
        )
        last = logits[:, -1].argmax(dim=-1)
        first = last.tolist()  # waits for the device: the first token exists now
        now = time.monotonic()
        for i, r in enumerate(batch_reqs):
            r.out_tokens.append(first[i])
            r.t_first_token = now
        for k in range(1, budget):
            batch_in = {"tokens": last[:, None].to(torch.int32), "pos": t + k - 1}
            logits, cache = self.model.decode_step(self.params, batch_in, cache)
            last = logits[:, -1].argmax(dim=-1)
            step = last.tolist()
            for i, r in enumerate(batch_reqs):
                if len(r.out_tokens) < r.max_new_tokens:
                    r.out_tokens.append(step[i])
        for r in batch_reqs:
            r.t_done = time.monotonic()
        self.done += batch_reqs
        return batch_reqs
