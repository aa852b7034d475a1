"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 — llama+mistral mix, SWA  [arXiv:2401.16818; unverified]"""
from .base import ArchConfig
from .registry import register


@register
def h2o_danube3_4b() -> ArchConfig:
    return ArchConfig(
        name="h2o-danube-3-4b",
        family="dense",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        head_dim=120,  # d_model / n_heads
        d_ff=10240,
        vocab_size=32000,
        sliding_window=4096,  # mistral-style SWA -> sub-quadratic long ctx
        rope_theta=1e4,
    )
