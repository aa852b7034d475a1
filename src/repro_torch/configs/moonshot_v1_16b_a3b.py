"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (kv=16) expert
d_ff=1408 vocab=163840, MoE 64e top-6 — kimi/moonlight
[hf:moonshotai/Moonlight-16B-A3B; hf]

Note: with the assigned 48 layers the total parameter count is ~27B
(the HF Moonlight model uses 27 layers for its "16B" total); the config
is kept verbatim.
"""
from .base import ArchConfig
from .registry import register


@register
def moonshot_v1_16b_a3b() -> ArchConfig:
    return ArchConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,  # per-expert hidden
        vocab_size=163840,
        n_experts=64,
        top_k=6,
        rope_theta=5e4,
    )
