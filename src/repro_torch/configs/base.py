"""Architecture configuration: the port's own copy of ``ArchConfig``.

Field for field the same dataclass as the JAX package's
``repro.configs.base.ArchConfig`` (tests/test_torch_configs.py holds them
equal).  ``family`` selects the block structure:

* dense   — attention + (gated) MLP every layer
* moe     — attention + top-k mixture-of-experts MLP
* vlm     — dense backbone; frontend is a patch-embedding stub
* ssm     — Mamba2 (SSD) mixer only, no MLP
* hybrid  — Jamba-style 1:7 attention:mamba interleave, MoE every 2nd layer
* audio   — encoder-only (bidirectional) transformer, frame-embedding stub

All six families run in the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | vlm | ssm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int  # query heads (0 for attention-free archs)
    n_kv_heads: int
    d_ff: int  # dense MLP hidden (for moe: per-expert hidden)
    vocab_size: int
    head_dim: int = 128
    qk_norm: bool = False
    sliding_window: Optional[int] = None  # SWA window (tokens)
    mlp_gated: bool = True  # SwiGLU vs plain GeLU MLP
    causal: bool = True
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # hybrid (Jamba): one attention layer per `attn_period` layers, MoE on
    # every `moe_period`-th layer.
    attn_period: int = 0
    moe_period: int = 0
    # frontend stubs
    frontend_dim: int = 0  # audio frame / vision patch embedding dim
    vlm_img_tokens: int = 0
    # numerics
    dtype: str = "bfloat16"
    # notes recorded for DESIGN.md fidelity bookkeeping
    notes: str = ""

    def __post_init__(self) -> None:
        if self.family not in ("dense", "moe", "vlm", "ssm", "hybrid", "audio"):
            raise ValueError(f"unknown family {self.family}")
        if self.family in ("moe", "hybrid") and not (
            self.n_experts > 0 and self.top_k > 0
        ):
            raise ValueError("MoE family needs n_experts/top_k")

    # ---- derived sizes -----------------------------------------------------

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so it shards over `model`."""
        return _round_up(self.vocab_size, 256)

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def ssm_groups(self) -> int:
        return 1  # single B/C group (Mamba2 default)

    def layer_kinds(self) -> Tuple[Tuple[str, str], ...]:
        """(mixer, ff) kind per layer within one scan block.

        dense/moe/vlm/audio: one (attn, ff) layer per scan step.
        ssm: one (mamba, none) layer per scan step.
        hybrid: the scan step is a super-block of ``attn_period`` layers.
        """
        if self.family in ("dense", "vlm", "audio"):
            return (("attn", "dense"),)
        if self.family == "moe":
            return (("attn", "moe"),)
        if self.family == "ssm":
            return (("mamba", "none"),)
        # hybrid: attention in the middle of the super-block, MoE on odd
        # positions (Jamba's published 1:7 interleave, MoE every 2 layers).
        kinds = []
        for i in range(self.attn_period):
            mixer = "attn" if i == self.attn_period // 2 else "mamba"
            ff = "moe" if (i % self.moe_period == self.moe_period - 1) else "dense"
            kinds.append((mixer, ff))
        return tuple(kinds)

    @property
    def n_scan_blocks(self) -> int:
        per_block = len(self.layer_kinds())
        if self.n_layers % per_block != 0:
            raise ValueError(
                f"{self.name}: n_layers {self.n_layers} not divisible by "
                f"super-block size {per_block}"
            )
        return self.n_layers // per_block


@dataclass(frozen=True)
class ShapeCell:
    """One (architecture x input-shape) evaluation cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    """Which shape cells apply to this arch."""
    out = ["train_4k", "prefill_32k"]
    if cfg.causal:  # encoder-only archs have no autoregressive decode
        out.append("decode_32k")
        # long_500k needs sub-quadratic attention: SSM, hybrid, or SWA.
        if (
            cfg.family in ("ssm", "hybrid")
            or cfg.sliding_window is not None
        ):
            out.append("long_500k")
    return out
