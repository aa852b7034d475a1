"""Checkpointing: atomic, resumable, optionally asynchronous, in the JAX
package's on-disk layout (``repro/train/checkpoint.py``):

    <dir>/step_<N>/arrays.npz   — every leaf, keyed by its "/"-joined path
    <dir>/step_<N>/meta.json    — step, data-loader cursor, user metadata
    <dir>/step_<N>/.complete    — commit marker (atomicity)

Keys are the paths ``jax.tree_util`` gives a ``TrainState``
(``params/...``, ``opt/step``, ``opt/m/...``, ``opt/v/...`` and
``error_feedback/...`` when present), so a checkpoint written by either
package restores in the other.  bfloat16 leaves are stored as ``|V2``,
the dtype and bytes ``np.savez`` gives a JAX bfloat16 array
(``convert.to_numpy``), and a ``|V2`` leaf restores into a bfloat16
template leaf as the same bits.  (The JAX package's own ``restore`` cannot
read ``|V2``: ROADMAP.md, C2.)

Write protocol: serialize into ``step_<N>.tmp``, then rename, so a crash
mid-write never corrupts the latest complete checkpoint.  ``AsyncWriter``
copies the state to the host on the caller's thread and writes it to
disk on its own.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..convert import _to_tensor, to_numpy
from ..tree import leaves_with_paths, tree_map, unflatten

PathLike = Union[str, Path]


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {
        key: to_numpy(leaf) if torch.is_tensor(leaf) else np.asarray(leaf)
        for key, leaf in leaves_with_paths(tree)
    }


def save(
    ckpt_dir: PathLike,
    step: int,
    state: Any,
    extra_meta: Optional[dict] = None,
) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step}"
    tmp = ckpt_dir / f"step_{step}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "arrays.npz", **_flatten(state))
    meta = {"step": int(step)}
    meta.update(extra_meta or {})
    (tmp / "meta.json").write_text(json.dumps(meta))
    (tmp / ".complete").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(ckpt_dir: PathLike) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for p in ckpt_dir.iterdir():
        if p.name.startswith("step_") and (p / ".complete").exists():
            try:
                steps.append(int(p.name.split("_", 1)[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def restore(
    ckpt_dir: PathLike,
    state_template: Any,
    step: Optional[int] = None,
    device: Union[str, torch.device, None] = None,
    shardings: Any = None,
    mesh=None,
) -> Tuple[Any, dict]:
    """Restore into the template's structure, shapes and dtypes (a
    template on the meta device will do, as from
    ``train_step.train_state_template``).  Leaves land on ``device``,
    default each template leaf's own.  ``shardings``: a tree of
    placements (``parallel.sharding``) that places each leaf on ``mesh``
    as a DTensor (``sharding.distribute``), on the mesh's device type, for
    a mesh that may differ from the one that saved it.  Returns (state,
    meta)."""
    if shardings is not None:
        if mesh is None:
            raise ValueError("restore: shardings= needs mesh=")
        from ..parallel.sharding import distribute

        dev = torch.device(mesh.device_type)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        state, meta = restore(ckpt_dir, state_template, step, dev)
        return distribute(state, shardings, mesh), meta
    ckpt_dir = Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no complete checkpoint under {ckpt_dir}")
    path = ckpt_dir / f"step_{step}"
    meta = json.loads((path / "meta.json").read_text())
    out: List[torch.Tensor] = []
    with np.load(path / "arrays.npz") as arrays:
        for key, leaf in leaves_with_paths(state_template):
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = arrays[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"shape mismatch for {key}: ckpt {arr.shape} vs "
                    f"template {tuple(leaf.shape)}"
                )
            t = _to_tensor(arr)
            if t.dtype == torch.bfloat16 and leaf.dtype != torch.bfloat16:
                raise TypeError(
                    f"{key}: a |V2 (bfloat16 bits) leaf restores only into a "
                    f"bfloat16 template leaf, not {leaf.dtype}"
                )
            dev = torch.device(device) if device is not None else leaf.device
            if dev.type == "meta":
                raise ValueError("a template on the meta device needs device=")
            out.append(t.to(device=dev, dtype=leaf.dtype))
    return unflatten(state_template, out), meta


def prune(ckpt_dir: PathLike, keep: int = 3) -> None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return
    steps = sorted(
        int(p.name.split("_", 1)[1])
        for p in ckpt_dir.iterdir()
        if p.name.startswith("step_") and "." not in p.name.split("_", 1)[1]
    )
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)


class AsyncWriter:
    """Background checkpoint writer (one in flight at a time)."""

    def __init__(self, ckpt_dir: PathLike, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._errors: List[Exception] = []
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_state, meta = item
            try:
                save(self.ckpt_dir, step, host_state, meta)
                prune(self.ckpt_dir, self.keep)
            except Exception as e:  # surfaced on the next submit or close
                self._errors.append(e)

    def submit(self, step: int, state: Any, meta: Optional[dict] = None) -> None:
        if self._errors:
            raise self._errors.pop()
        # device->host copy now (a copy even on the CPU: the next step
        # updates the state's tensors in place); the disk write in the thread
        host_state = tree_map(lambda t: to_numpy(t) if torch.is_tensor(t) else t, state)
        self._q.put((step, host_state, meta))

    def close(self) -> None:
        self._q.put(None)
        self._worker.join()
        if self._errors:
            raise self._errors.pop()
