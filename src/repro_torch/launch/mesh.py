"""Device meshes (the JAX package's ``repro/launch/mesh.py``).

Functions, never module-level constants, so importing this module touches
no process group.  Each builds a ``DeviceMesh`` over the default process
group, which the caller initialises with as many ranks as the mesh has:
a real group (NCCL on cards, gloo on the CPU) or, for the dry run, a fake
one (``launch/dryrun.py``).
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` across two pods: 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_debug_mesh(
    n_devices: int | None = None, model: int = 2, device_type: str = "cuda"
) -> DeviceMesh:
    """(n // model, model) ``("data", "model")`` over ``n_devices`` ranks,
    default the world size of the default group."""
    n = n_devices or dist.get_world_size()
    model = min(model, n)
    return init_device_mesh(device_type, (n // model, model), mesh_dim_names=("data", "model"))
