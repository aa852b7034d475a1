"""Straggler detection (the port's copy of ``StragglerDetector`` from the
JAX package's ``repro/train/fault_tolerance.py``, the piece the training
driver uses; the elastic re-meshing there waits for the parallel layer).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


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
