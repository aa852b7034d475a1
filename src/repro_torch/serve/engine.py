"""Batched serving engine of the port: continuous prefill + decode over a
request queue (the JAX package's ``repro/serve/engine.py``).

A fixed-width decode batch is continuously refilled from a pending-request
queue: each incoming request is prefilled *solo* (exact prompt length, no
padding), its KV cache scattered into a free batch row, and the decode
loop samples every live row per step, retiring rows on EOS/max-tokens and
refilling them from the queue.

* **Batch isolation** — a request's greedy output is the same whether it
  is served alone or batched: solo prefill assigns true positions, and
  decode runs with per-row positions (``Model.decode_step`` with a ``[B]``
  pos), so each row attends only over its own written slots.
* **Budget validation** — ``len(prompt) + max_new_tokens`` over
  ``max_len`` raises up front (default) or marks the request
  ``truncated`` (``overflow="truncate"``).
* **EOS exclusion** — a sampled EOS ends the request and is not returned.

Sampling draws from ``np.random.default_rng(seed)`` exactly as the JAX
engine does, so sampled output matches too.  The engine rejects
sliding-window configs: per-row positions need slot == position.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..models.model import Model, Params


@dataclass
class Request:
    request_id: int
    prompt: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 = greedy
    generated: List[int] = field(default_factory=list)
    done: bool = False
    truncated: bool = False  # budget was capped (overflow="truncate")


class ServeEngine:
    def __init__(
        self,
        cfg: ArchConfig,
        params: Params,
        max_len: int = 512,
        eos_id: Optional[int] = None,
        seed: int = 0,
        batch_size: int = 8,
        overflow: str = "error",  # or "truncate"
        device: Union[str, torch.device] = "cuda",
    ):
        if cfg.sliding_window is not None:
            raise NotImplementedError(
                "ServeEngine's per-row decode positions require "
                "sliding_window=None (ring wrap breaks the slot == "
                "position invariant)"
            )
        if overflow not in ("error", "truncate"):
            raise ValueError(
                f"overflow must be 'error' or 'truncate', got {overflow!r}"
            )
        self.cfg = cfg
        self.model = Model(cfg, device)
        self.device = self.model.device
        self.params = params
        self.max_len = max_len
        self.eos_id = eos_id
        self.batch_size = batch_size
        self.overflow = overflow
        self._rng = np.random.default_rng(seed)
        # Host seconds of each prefill and decode call of the last
        # generate(), logits readback (which waits for the device) included.
        self.call_seconds: Dict[str, List[float]] = {"prefill": [], "decode": []}

    def _sample(self, logits: np.ndarray, temperature: float) -> int:
        logits = np.asarray(logits, dtype=np.float64)
        logits[self.cfg.vocab_size :] = -1e30  # mask padded vocab
        if temperature <= 0:
            return int(np.argmax(logits))
        p = np.exp((logits - logits.max()) / temperature)
        p /= p.sum()
        return int(self._rng.choice(len(p), p=p))

    def cache_dtype(self) -> torch.dtype:
        return torch.float32 if self.cfg.dtype == "float32" else torch.bfloat16

    def _budget(self, r: Request) -> int:
        """Validated per-request token budget: raises on over-budget
        requests unless the engine was built with ``overflow="truncate"``,
        which caps the budget and marks the request."""
        if not r.prompt:
            raise ValueError(f"request {r.request_id}: empty prompt")
        if r.max_new_tokens < 1:
            raise ValueError(
                f"request {r.request_id}: max_new_tokens must be >= 1"
            )
        if len(r.prompt) >= self.max_len:
            raise ValueError(
                f"request {r.request_id}: prompt length {len(r.prompt)} "
                f"leaves no room to generate within max_len={self.max_len}"
            )
        budget = r.max_new_tokens
        if len(r.prompt) + budget > self.max_len:
            if self.overflow == "error":
                raise ValueError(
                    f"request {r.request_id}: prompt ({len(r.prompt)}) + "
                    f"max_new_tokens ({budget}) exceeds "
                    f"max_len={self.max_len}; shorten the request or build "
                    f"the engine with overflow='truncate'"
                )
            budget = self.max_len - len(r.prompt)
            r.truncated = True
        return budget

    @staticmethod
    def insert_row(cache: Params, row_cache: Params, row: int) -> Params:
        """Scatter a solo-prefilled (B=1) cache into batch row ``row``, in
        place.  k/v and Mamba conv/ssm leaves ``[n_blocks, B, ...]``: the
        whole row is replaced, clearing any previous occupant.  The shared
        attention ``pos`` leaf ``[n_blocks, 1, W]`` merges by max: values
        are slot-or--1, and every row writes position == slot."""
        for sub, leaves in cache.items():
            for name, t in leaves.items():
                r = row_cache[sub][name]
                if name == "pos":
                    torch.maximum(t, r, out=t)
                else:
                    t[:, row] = r[:, 0]
        return cache

    def _logits_to_host(self, logits: torch.Tensor) -> np.ndarray:
        return logits[:, 0, :].float().cpu().numpy()

    def generate(
        self, requests: List[Request], batch_size: Optional[int] = None
    ) -> Dict[int, List[int]]:
        """Serve requests to completion with continuous batch refill."""
        self.call_seconds = {"prefill": [], "decode": []}
        if not requests:
            return {}
        budgets = {i: self._budget(r) for i, r in enumerate(requests)}
        pending = deque(range(len(requests)))
        B = max(1, min(batch_size or self.batch_size, len(requests)))
        dt = self.cache_dtype()
        cache = self.model.init_cache(B, self.max_len, dtype=dt)
        row_req: List[Optional[int]] = [None] * B  # request index per row
        row_pos = np.zeros(B, dtype=np.int64)  # next write position
        tok = np.zeros((B, 1), dtype=np.int32)
        last: List[Optional[np.ndarray]] = [None] * B

        while True:
            # Refill retired/empty rows: solo prefill (exact length, true
            # positions), then scatter the row cache into the batch.
            for b in range(B):
                if row_req[b] is None and pending:
                    ri = pending.popleft()
                    r = requests[ri]
                    t0 = time.perf_counter()
                    logits, row_cache = self.model.prefill(
                        self.params,
                        {"tokens": torch.tensor([r.prompt], dtype=torch.int32, device=self.device)},
                        self.model.init_cache(1, self.max_len, dtype=dt),
                    )
                    last[b] = self._logits_to_host(logits)[0]
                    self.call_seconds["prefill"].append(time.perf_counter() - t0)
                    self.insert_row(cache, row_cache, b)
                    row_req[b] = ri
                    row_pos[b] = len(r.prompt)
            live = [b for b in range(B) if row_req[b] is not None]
            if not live:
                break

            for b in live:
                ri = row_req[b]
                r = requests[ri]
                t = self._sample(last[b], r.temperature)
                if self.eos_id is not None and t == self.eos_id:
                    r.done = True  # EOS consumed, not returned
                    row_req[b] = None
                    continue
                r.generated.append(t)
                tok[b, 0] = t
                if len(r.generated) >= budgets[ri]:
                    r.done = True
                    row_req[b] = None

            if all(ri is None for ri in row_req) and not pending:
                break
            # Retired rows ride along as dummies (their stale token at a
            # clamped position): writes stay confined to their own cache
            # row and are replaced wholesale on refill.
            t0 = time.perf_counter()
            logits, cache = self.model.decode_step(
                self.params, cache,
                torch.from_numpy(tok).to(self.device),
                torch.from_numpy(
                    np.minimum(row_pos, self.max_len - 1).astype(np.int32)
                ).to(self.device),
            )
            arr = self._logits_to_host(logits)
            self.call_seconds["decode"].append(time.perf_counter() - t0)
            for b in range(B):
                if row_req[b] is not None:
                    last[b] = arr[b]
                    row_pos[b] += 1
        return {r.request_id: r.generated for r in requests}
