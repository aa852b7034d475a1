"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120
vocab=504 — encoder-only, same arch as w2v2  [arXiv:2106.07447; unverified]

The CNN waveform frontend is a STUB per the assignment: ``input_specs()``
provides precomputed 512-dim frame features; a trainable projection maps
them into the encoder. Loss is masked-frame cluster prediction over the
504 k-means targets (the HuBERT objective).
"""
from .base import ArchConfig
from .registry import register


@register
def hubert_xlarge() -> ArchConfig:
    return ArchConfig(
        name="hubert-xlarge",
        family="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        head_dim=80,  # d_model / n_heads
        d_ff=5120,
        vocab_size=504,
        mlp_gated=False,  # w2v2 MLP is up/down GeLU
        causal=False,  # bidirectional encoder
        frontend_dim=512,
    )
