"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887; hf]

Super-block of 8 layers: attention at position 4, Mamba elsewhere
(1:7); MoE replaces the dense MLP on every 2nd layer (Jamba's published
e=2 MoE period). Total params ~= 398B, active ~= 94B.
"""
from .base import ArchConfig
from .registry import register


@register
def jamba_1_5_large_398b() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=65536,
        n_experts=16,
        top_k=2,
        attn_period=8,
        moe_period=2,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        rope_theta=1e6,
    )
