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

While a profiler is active ``generate`` records its spans
(``repro_torch.spans``): one ``serve.request`` a request, from its arrival
in ``generate`` to its retirement; each solo ``serve.prefill`` and its
``serve.insert_row``; each step's ``serve.sample`` and ``serve.decode``.
While a routing recorder is active (``moe.record_routing``) each model
call tags its routing calls (``moe.tag_routing``): a prefill ``"prefill"``
with its one request's id, a decode step ``"decode"`` with the request id
of each row, None for a row that rides along retired or empty.

With ``cuda_graphs`` on a CUDA device the model calls replay CUDA graphs
(``models.graphs``), the same kernels on the same inputs, so that the
host's launches no longer set their pace: a decode step each attention
sub-layer and each mixture-of-experts layer, captured at the first step
of a batch width; a prefill the whole model call, captured at the first
prompt of its length (up to ``PREFILL_GRAPHS`` lengths; longer-tailed
traffic prefills the other lengths eagerly).  The graphs hold the
caches' pointers, so the engine keeps one batch cache a width and one
one-row prefill cache, cleared before each use as a new one would be.
The routing read-out is kept (copies of the graphs' tensors); a replayed
prefill opens no spans inside ``serve.forward``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import spans
from ..configs.base import ArchConfig
from ..models import graphs, moe
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


PREFILL_GRAPHS = 64  # prompt lengths whose prefills replay a graph


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
        cuda_graphs: bool = False,
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
        cuda = cuda_graphs and self.device.type == "cuda"
        # the decode steps' graphs and the prefills', each store in one memory pool
        self._graphs = graphs.Graphs() if cuda else None
        self._prefills = graphs.Graphs() if cuda else None
        self._caches: Dict[Tuple[str, int, torch.dtype], Params] = {}  # kept for the graphs
        # Host seconds of each prefill and decode call of the last
        # generate(), logits readback (which waits for the device) included:
        # the serve.prefill and serve.decode spans' durations.
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

    def _cache(self, use: str, B: int, dt: torch.dtype) -> Params:
        """An empty cache of ``B`` rows for ``use`` ("prefill", "batch"): a
        new one, or with graphs the engine's own, cleared as ``init_cache``
        makes it."""
        if self._graphs is None:
            return self.model.init_cache(B, self.max_len, dtype=dt)
        cache = self._caches.get((use, B, dt))
        if cache is None:
            cache = self._caches[(use, B, dt)] = self.model.init_cache(B, self.max_len, dtype=dt)
        else:
            for leaves in cache.values():
                for name, t in leaves.items():
                    t.fill_(-1 if name == "pos" else 0)
        return cache

    def _logits_to_host(self, logits: torch.Tensor) -> np.ndarray:
        return logits[:, 0, :].float().cpu().numpy()

    def _prefill(self, r: Request, dt: torch.dtype) -> Tuple[np.ndarray, Params]:
        """Solo prefill of ``r`` (exact length, true positions) into a fresh
        one-row cache: its last position's logits on the host, and the
        cache."""
        t0 = spans.now()
        call = spans.begin(
            "serve.prefill", start=t0, request_id=r.request_id, prompt_len=len(r.prompt)
        )
        part = spans.begin("serve.cache_init", call)
        tokens = torch.tensor([r.prompt], dtype=torch.int32, device=self.device)
        cache = self._cache("prefill", 1, dt)
        spans.end(part)
        part = spans.begin("serve.forward", call)
        key = (len(r.prompt), dt)
        if self._prefills is None or (key not in self._prefills and len(self._prefills) >= PREFILL_GRAPHS):
            logits, cache = self.model.prefill(self.params, {"tokens": tokens}, cache)
        else:
            def build(store):
                with moe.capture_routing() as routed:
                    got = graphs.Captured(
                        lambda t: self.model.prefill(self.params, {"tokens": t}, cache)[:1], (tokens,), store)
                    self._cache("prefill", 1, dt)  # the warm-up wrote it
                return got, routed

            got, routed = self._prefills.get(key, build)
            (logits,) = got.replay((tokens,))
            moe.replayed(routed)
        spans.end(part)
        return self._read_back(logits, call, t0, "prefill")[0], cache

    def _decode(
        self, cache: Params, tok: np.ndarray, pos: np.ndarray
    ) -> Tuple[np.ndarray, Params]:
        """One decode step of every row (``tok`` ``[B,1]`` at ``pos``
        ``[B]``): the logits on the host, and the cache."""
        t0 = spans.now()
        call = spans.begin("serve.decode", start=t0, rows=len(pos))
        if call is not None:  # row b's attention visits its keys at slots 0..pos[b]
            call.attrs["keys"] = int(pos.sum()) + len(pos)
        part = spans.begin("serve.forward", call)
        with graphs.replaying(self._graphs):
            logits, cache = self.model.decode_step(
                self.params, cache,
                torch.from_numpy(tok).to(self.device), torch.from_numpy(pos).to(self.device),
            )
        spans.end(part)
        return self._read_back(logits, call, t0, "decode"), cache

    def _read_back(
        self, logits: torch.Tensor, call: Optional[spans.Span], t0: int, kind: str
    ) -> np.ndarray:
        """The logits on the host, which ends the ``kind`` call begun at
        ``t0`` (``call`` its span): its host seconds go to
        ``call_seconds``."""
        part = spans.begin("serve.readback", call)
        host = self._logits_to_host(logits)
        t1 = spans.now()
        spans.end(part, t1)
        spans.end(call, t1)
        self.call_seconds[kind].append((t1 - t0) / 1e9)
        return host

    def generate(
        self, requests: List[Request], batch_size: Optional[int] = None
    ) -> Dict[int, List[int]]:
        """Serve requests to completion with continuous batch refill."""
        self.call_seconds = {"prefill": [], "decode": []}
        if not requests:
            return {}
        budgets = {i: self._budget(r) for i, r in enumerate(requests)}
        held = [spans.begin("serve.request", request_id=r.request_id) for r in requests]
        pending = deque(range(len(requests)))
        B = max(1, min(batch_size or self.batch_size, len(requests)))
        dt = self.cache_dtype()
        cache = self._cache("batch", B, dt)
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
                    moe.tag_routing("prefill", (r.request_id,))
                    last[b], row_cache = self._prefill(r, dt)
                    part = spans.begin("serve.insert_row", request_id=r.request_id)
                    self.insert_row(cache, row_cache, b)
                    spans.end(part)
                    row_req[b] = ri
                    row_pos[b] = len(r.prompt)
            live = [b for b in range(B) if row_req[b] is not None]
            if not live:
                break

            step = spans.begin("serve.sample", rows=len(live))
            for b in live:
                ri = row_req[b]
                r = requests[ri]
                t = self._sample(last[b], r.temperature)
                if held[ri] is not None:
                    held[ri].attrs.setdefault("first_token", spans.now())
                if self.eos_id is not None and t == self.eos_id:
                    r.done = True  # EOS consumed, not returned
                    row_req[b] = None
                    spans.end(held[ri])
                    continue
                r.generated.append(t)
                tok[b, 0] = t
                if len(r.generated) >= budgets[ri]:
                    r.done = True
                    row_req[b] = None
                    spans.end(held[ri])
            spans.end(step)
            if all(ri is None for ri in row_req) and not pending:
                break
            # Retired rows ride along as dummies (their stale token at a
            # clamped position): writes stay confined to their own cache
            # row and are replaced wholesale on refill.
            if moe.recording():
                moe.tag_routing("decode", [None if ri is None else requests[ri].request_id
                                           for ri in row_req])
            arr, cache = self._decode(
                cache, tok, np.minimum(row_pos, self.max_len - 1).astype(np.int32)
            )
            for b in range(B):
                if row_req[b] is not None:
                    last[b] = arr[b]
                    row_pos[b] += 1
        return {r.request_id: r.generated for r in requests}
