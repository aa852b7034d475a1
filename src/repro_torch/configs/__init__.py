"""Architecture configs of the port (its own copy, not the JAX package's)."""
from .base import SHAPES, ArchConfig, ShapeCell, applicable_shapes  # noqa: F401
from .registry import get_config, list_archs, reduced_config  # noqa: F401

# Import config modules so they register themselves.
from . import (  # noqa: F401,E402
    deepseek_7b,
    granite_34b,
    h2o_danube3_4b,
    hubert_xlarge,
    jamba_1_5_large_398b,
    llava_next_mistral_7b,
    mamba2_370m,
    moonshot_v1_16b_a3b,
    qwen3_32b,
    qwen3_moe_30b_a3b,
)
