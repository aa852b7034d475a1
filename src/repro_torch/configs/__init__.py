"""Architecture configs of the port (its own copy, not the JAX package's)."""
from .base import ArchConfig  # noqa: F401
from .registry import get_config, list_archs, reduced_config  # noqa: F401

# Import config modules so they register themselves.
from . import deepseek_7b, mamba2_370m, moonshot_v1_16b_a3b, qwen3_moe_30b_a3b  # noqa: F401,E402
