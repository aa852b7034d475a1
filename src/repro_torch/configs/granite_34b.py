"""granite-34b [dense]: 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — llama-arch, code  [arXiv:2405.04324; hf]

gpt_bigcode lineage: non-gated (2-matrix) MLP, multi-query attention.
"""
from .base import ArchConfig
from .registry import register


@register
def granite_34b() -> ArchConfig:
    return ArchConfig(
        name="granite-34b",
        family="dense",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        head_dim=128,
        d_ff=24576,
        vocab_size=49152,
        mlp_gated=False,  # gpt_bigcode MLP (up/down, GeLU)
        rope_theta=1e4,
    )
