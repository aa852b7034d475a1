"""Run-time optimization flags (the JAX package's
``repro/parallel/opt_flags.py``).

Set by ``launch/dryrun.py`` (``--opt a,b,c``) before a step runs; read by
the model code as it runs.  Flags:

  sp           — sequence-parallel residual stream (model.py)
  mamba_heads  — shard SSD heads over `model` inside the mamba mixer (the
                 port's Mamba block on DTensors always does where the
                 heads divide: models/mamba.py::_placed_mix)
  moe_ep       — expert-parallel placement of the MoE dispatch slabs
  moe_a2a      — local-dispatch expert-parallel MoE (moe.apply_moe_shard_map)
  sp_sub       — per-sublayer resharding (kept for ablation, as in the reference)
  batch_axes   — mesh axes the batch dim is sharded over (set automatically)
  mesh         — the DeviceMesh ``moe_a2a`` runs on
"""
from __future__ import annotations

_FLAGS = {
    "sp": False,
    "mamba_heads": False,
    "moe_ep": False,
    "moe_a2a": False,
    "sp_sub": False,
    "batch_axes": None,
    "mesh": None,
}


def set_flags(**kw) -> None:
    for k, v in kw.items():
        if k not in _FLAGS:
            raise KeyError(k)
        _FLAGS[k] = v


def reset() -> None:
    set_flags(sp=False, mamba_heads=False, moe_ep=False, moe_a2a=False,
              sp_sub=False, batch_axes=None, mesh=None)


def get(name: str):
    return _FLAGS[name]
