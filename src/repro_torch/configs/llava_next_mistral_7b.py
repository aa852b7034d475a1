"""llava-next-mistral-7b [vlm]: 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=32000 — anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

The vision frontend is a STUB per the assignment: ``input_specs()``
provides precomputed patch embeddings (anyres tiles), projected by a
trainable 2-layer MLP into the mistral-7b backbone.
"""
from .base import ArchConfig
from .registry import register


@register
def llava_next_mistral_7b() -> ArchConfig:
    return ArchConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        frontend_dim=1024,  # CLIP-large patch embedding dim
        vlm_img_tokens=1152,  # anyres: base 576 + half-tile thumbnails
        rope_theta=1e6,
    )
