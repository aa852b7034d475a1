"""Convert parameters of the JAX package into the port's parameters.

``params_from_jax`` takes the JAX ``Model.init`` tree with every leaf
already converted to numpy (the caller does that step; this module
imports no JAX) and returns the same nested dicts of CPU torch tensors,
checked leaf by leaf against the port's ``param_spec``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .configs.base import ArchConfig
from .models.model import param_spec


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    # Copy: a JAX-backed buffer is read-only and must not be aliased.
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree: Dict[str, Any], cfg: ArchConfig) -> Dict[str, Any]:
    """Port params from a JAX param tree of numpy arrays, for ``cfg``.

    Raises ``ValueError`` on a missing or extra key or a leaf whose shape
    differs from what the port builds for ``cfg``.
    """

    def walk(node: Any, spec: Any, path: str) -> Any:
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                got = sorted(node) if isinstance(node, dict) else type(node).__name__
                raise ValueError(f"{path or 'params'}: keys {got}, expected {sorted(spec)}")
            return {k: walk(node[k], spec[k], f"{path}/{k}") for k in spec}
        shape, _ = spec
        t = _to_tensor(np.asarray(node))
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)}, expected {tuple(shape)}")
        return t

    return walk(tree, param_spec(cfg), "")
