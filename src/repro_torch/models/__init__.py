"""Model stack of the port: the six families of the JAX package."""
from .model import Model  # noqa: F401
