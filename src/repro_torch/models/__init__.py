"""Model stack of the port (dense family)."""
from .model import Model  # noqa: F401
