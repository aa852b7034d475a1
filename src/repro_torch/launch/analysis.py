"""Roofline terms of a dry-run cell (the JAX package's
``repro/launch/analysis.py``), against one NVIDIA H100 SXM5 80 GB.

Hardware constants, from NVIDIA's H100 data sheet (SXM part, dense rates,
at the full 700 W power limit); ``chip_smoke.py::bound`` reads them from
here:
  peak bf16 tensor-core rate : 989 TFLOP/s
  peak fp32 rate (no tensor cores) : 67 TFLOP/s
  HBM3 bandwidth             : 3.35 TB/s
  NVLink 4 bandwidth         : 450 GB/s a direction
  HBM capacity               : 80 GB
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # per card
HBM_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S = 450e9  # per direction
HBM_CAPACITY_BYTES = 80e9

COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops: float  # per device
    bytes: float  # per device
    coll_bytes: float  # per device
    coll_breakdown: Dict[str, int] = field(default_factory=dict)
    model_flops: float = 0.0  # 6*N*D or 2*N*D (useful flops, whole step)
    peak_memory_bytes: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS["bfloat16"]

    @property
    def t_memory(self) -> float:
        return self.bytes / HBM_BYTES_PER_S

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BYTES_PER_S

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (FLOPs summed over devices)."""
        total = self.flops * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs throughput vs peak, if the dominant term binds."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        if t <= 0:
            return 0.0
        return (self.model_flops / self.n_devices / t) / PEAK_FLOPS["bfloat16"]

    @property
    def fits_h100(self) -> bool:
        """The per-device peak fits one H100's 80 GB."""
        return self.peak_memory_bytes <= HBM_CAPACITY_BYTES

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(
            t_compute=self.t_compute,
            t_memory=self.t_memory,
            t_collective=self.t_collective,
            bottleneck=self.bottleneck,
            useful_flops_ratio=self.useful_flops_ratio,
            roofline_fraction=self.roofline_fraction,
            fits_h100=self.fits_h100,
        )
        return d


def model_flops_for(cfg, cell, n_active_params: int) -> float:
    """Useful-FLOPs floor: 6*N*tokens (train) / 2*N*tokens (inference)."""
    if cell.kind == "train":
        return 6.0 * n_active_params * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n_active_params * cell.global_batch * cell.seq_len
    # decode: one token per sequence per step
    return 2.0 * n_active_params * cell.global_batch
