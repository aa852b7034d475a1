"""Fault tolerance: failure detection, elastic re-meshing, stragglers (the
JAX package's ``repro/train/fault_tolerance.py``).

* **node failure** — ``HeartbeatMonitor`` flags hosts whose heartbeat is
  overdue; ``plan_elastic_mesh`` shrinks the data axis to the surviving
  host count; ``elastic_restore`` re-places the last checkpoint onto the
  new mesh (the ZeRO-sharded state re-shards through ``distribute``).
* **stragglers** — ``StragglerDetector`` keeps a per-host EWMA of step
  times and flags hosts slower than ``threshold x`` the median.
* **checkpoint/restart** — see checkpoint.py; driven by launch/train.py.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class HeartbeatMonitor:
    def __init__(self, timeout: float = 60.0):
        self.timeout = timeout
        self._last: Dict[int, float] = {}

    def beat(self, host: int, t: Optional[float] = None) -> None:
        self._last[host] = time.monotonic() if t is None else t

    def failed(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return sorted(h for h, t in self._last.items() if now - t > self.timeout)

    def healthy(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return sorted(h for h, t in self._last.items() if now - t <= self.timeout)


class StragglerDetector:
    """Per-host EWMA step times; flags hosts slower than median x threshold."""

    def __init__(self, alpha: float = 0.2, threshold: float = 1.5):
        self.alpha = alpha
        self.threshold = threshold
        self._ewma: Dict[int, float] = {}

    def record(self, host: int, step_time: float) -> None:
        prev = self._ewma.get(host)
        self._ewma[host] = (
            step_time
            if prev is None
            else (1 - self.alpha) * prev + self.alpha * step_time
        )

    def stragglers(self) -> List[int]:
        if len(self._ewma) < 2:
            return []
        med = float(np.median(list(self._ewma.values())))
        return sorted(
            h for h, v in self._ewma.items() if v > self.threshold * med
        )


def plan_elastic_mesh(n_healthy_devices: int, model_axis: int) -> Tuple[int, int]:
    """Largest (data, model) mesh that fits the surviving devices.

    The model axis is preserved (re-sharding TP state across a different
    model-axis size would change per-device layouts); the data axis shrinks
    — ZeRO/FSDP state re-shards along 'data' by construction.
    """
    if n_healthy_devices < model_axis:
        raise ValueError(
            f"cannot keep model axis {model_axis} with only "
            f"{n_healthy_devices} devices"
        )
    return (n_healthy_devices // model_axis, model_axis)


def state_shardings(cfg, state: Any, mesh) -> Any:
    """Placements of a ``TrainState``: params and both AdamW moments by
    the param rules, the step replicated, no error feedback."""
    from ..parallel import sharding as sh

    return type(state)(
        params=sh.param_shardings(cfg, state.params, mesh),
        opt=type(state.opt)(
            step=sh.replicated(mesh),
            m=sh.param_shardings(cfg, state.opt.m, mesh),
            v=sh.param_shardings(cfg, state.opt.v, mesh),
        ),
        error_feedback=None,
    )


def elastic_restore(ckpt_dir, state_template, cfg, new_mesh):
    """Restore the latest checkpoint onto a (possibly smaller) mesh.
    Returns (state of DTensors, meta, placements)."""
    from . import checkpoint

    state_sh = state_shardings(cfg, state_template, new_mesh)
    state, meta = checkpoint.restore(ckpt_dir, state_template, shardings=state_sh, mesh=new_mesh)
    return state, meta, state_sh


@dataclass
class FailureEvent:
    step: int
    host: int
    kind: str = "crash"  # crash | straggle


@dataclass
class FaultInjector:
    """Deterministic failure schedule for tests/examples."""

    events: List[FailureEvent] = field(default_factory=list)

    def at(self, step: int) -> List[FailureEvent]:
        return [e for e in self.events if e.step == step]
