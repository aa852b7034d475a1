"""Batched-serving latency curve of the port: the timing bridge from the
engine to the scheduler's simulator.

The scheduling stack prices a serving replica's work with an affine
per-decode-step cost ``base + per_req * batch``.  :func:`calibrate`
measures that curve from a live port :class:`~repro_torch.serve.engine.ServeEngine`
(timed decode steps at several batch sizes, least-squares fit).
``BatchLatencyModel`` is the port's own copy of the JAX package's class
(``repro/serve/latency.py``), field for field.

``DEFAULT_SERVE_MODEL`` is the JAX package's committed curve, copied so
that the scheduler core's ``RequestStream`` defaults match the reference;
``H100_SERVE_MODEL`` is the curve ``chip_smoke.py``'s calibrate phase
measured on the card (see each constant's comment for provenance).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Sequence, Union

import numpy as np
import torch

from ..models.model import resolve_device


@dataclass(frozen=True)
class BatchLatencyModel:
    """Affine decode-step latency: ``step_time(b) = base + per_req * b``.

    ``base``/``per_req`` are seconds per decode *step*; a request costs
    ``tokens_per_request`` steps, so a batch of ``b`` requests occupies
    its replica for ``service_time(b) = tokens_per_request * step_time(b)``
    seconds and sustains ``throughput(b) = b / service_time(b)``
    requests/s.
    """

    base: float
    per_req: float
    tokens_per_request: int = 32

    def __post_init__(self) -> None:
        if not (self.base >= 0.0 and math.isfinite(self.base)):
            raise ValueError(f"base must be finite >= 0, got {self.base}")
        if not (self.per_req > 0.0 and math.isfinite(self.per_req)):
            raise ValueError(
                f"per_req must be finite > 0, got {self.per_req}"
            )
        if self.tokens_per_request < 1:
            raise ValueError(
                f"tokens_per_request must be >= 1, got "
                f"{self.tokens_per_request}"
            )

    def step_time(self, batch: int) -> float:
        """Seconds for one decode step over a batch of ``batch`` rows."""
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        return self.base + self.per_req * batch

    def service_time(self, batch: int) -> float:
        """Seconds to serve a batch of ``batch`` requests to completion."""
        return self.tokens_per_request * self.step_time(batch)

    def throughput(self, batch: int) -> float:
        """Sustained requests/s of one replica at batch size ``batch``."""
        return batch / self.service_time(batch)

    @property
    def batch_base(self) -> float:
        """Per-batch fixed cost in seconds (the RequestStream ``svc_base``
        default): the step floor over a full request's decode."""
        return self.tokens_per_request * self.base

    @property
    def batch_per_req(self) -> float:
        """Per-request marginal cost in seconds (``svc_per_req``)."""
        return self.tokens_per_request * self.per_req


def calibrate(
    engine,
    batch_sizes: Sequence[int] = (1, 8, 32, 128),
    steps: int = 24,
    tokens_per_request: int = 32,
    device: Union[str, torch.device] = "cuda",
) -> BatchLatencyModel:
    """Fit the affine decode-step curve from a live ``ServeEngine``.

    ``device`` must be the engine's device: a measurement that finds no
    card fails rather than timing the CPU, unless the caller asked for
    ``"cpu"``.  For each batch size: build a fresh cache, run one decode
    step outside the timed window (warm-up), then time ``steps`` further
    steps, ending in a device synchronize, and take the mean.  The
    (batch, latency) samples are least-squares fit to
    ``base + per_req * batch``; a fit driven under the noise floor is
    clamped so the curve stays increasing.  ``engine.max_len`` must exceed
    ``steps`` (every step writes the next cache slot).
    """
    dev = resolve_device(device)
    if dev != engine.device:
        raise ValueError(f"calibrate on {dev}, but the engine runs on {engine.device}")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if engine.max_len <= steps:
        raise ValueError(
            f"max_len={engine.max_len} must exceed steps={steps}"
        )

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    model, params = engine.model, engine.params
    lat = []
    for b in batch_sizes:
        cache = model.init_cache(b, engine.max_len, dtype=engine.cache_dtype())
        tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        model.decode_step(params, cache, tok, torch.zeros(b, dtype=torch.int32, device=dev))
        sync()  # warm-up outside the timed window
        t0 = time.perf_counter()
        for i in range(1, steps + 1):
            model.decode_step(
                params, cache, tok, torch.full((b,), i, dtype=torch.int32, device=dev)
            )
        sync()
        lat.append((time.perf_counter() - t0) / steps)
    bs = np.asarray(batch_sizes, dtype=np.float64)
    ys = np.asarray(lat, dtype=np.float64)
    design = np.stack([np.ones_like(bs), bs], axis=1)
    (base, per_req), *_ = np.linalg.lstsq(design, ys, rcond=None)
    return BatchLatencyModel(
        base=max(float(base), 0.0),
        per_req=max(float(per_req), 1e-9),
        tokens_per_request=tokens_per_request,
    )


# The JAX package's committed curve (repro/serve/latency.py), copied value
# for value: `calibrate(ServeEngine(reduced_config("deepseek-7b"), params,
# max_len=64))` of the JAX engine on the CPU, reduced config, measured
# base=4.21e-4, per_req=4.43e-5.  It is no number of the card: it is the
# scheduler's default (RequestStream.svc_base / svc_per_req), kept so that
# the port's scheduler gives the reference's schedules and digests.
DEFAULT_SERVE_MODEL = BatchLatencyModel(
    base=4.2e-4, per_req=4.4e-5, tokens_per_request=32
)


# Measured by chip_smoke.py's calibrate phase: `calibrate(ServeEngine(
# get_config("deepseek-7b"), params, max_len=64), batch_sizes=(1, 8, 32, 128),
# steps=24)` on an NVIDIA H100 80GB HBM3 with a 700 W power limit, full
# width (30 layers) in bf16, seeded random weights, torch 2.11 / CUDA 12.8.
# The fit gave base=0.03156900351446138 s and a slope at or below zero,
# clamped to the 1e-9 floor: the eager engine is bound by the host, which
# launches about 1,564 kernels a step (the same run profiled 8.2 ms of
# device work in a 32 ms step at batch 4), so a step costs the same at
# batch 1 and at batch 128.  Refresh by re-running chip_smoke.py, not by
# hand-editing.
H100_SERVE_MODEL = BatchLatencyModel(
    base=0.03156900351446138, per_req=1e-9, tokens_per_request=32
)
