"""Dry run: for every (arch x shape x mesh) cell, whether the job fits one
H100 per device, and its FLOPs, bytes and collective bytes per device,
without the devices (the JAX package's ``repro/launch/dryrun.py``).

Per cell this module:
  1. builds params, optimiser state, cache and batch on the meta device,
     as DTensors placed by ``parallel.sharding``'s rules, on a fake process
     group of 256 ranks (16x16) or 512 (2x16x16): nothing is allocated,
     and no collective moves a byte;
  2. runs one train, prefill or decode step of the port's own code under
     ``cost.CostMode``, which counts per device the FLOPs, the bytes, the
     collective bytes by kind and the peak of live memory;
  3. returns the reference's roofline terms (``analysis.RooflineTerms``)
     and ``fits_h100``: the per-device peak within 80 GB.

The fake group is torch's private ``fake_pg`` backend, imported here and
nowhere else in the port; ``run_cell`` destroys it before it returns.

Usage:
  python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k \\
      [--multi-pod] [--out results/dryrun_torch/cell.json]
  python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from ..configs import SHAPES, applicable_shapes, get_config, list_archs
from ..configs.base import ArchConfig, ShapeCell
from ..models.model import Model, active_params
from ..parallel import opt_flags
from ..parallel import sharding as sh
from ..train.fault_tolerance import state_shardings
from ..train.optimizer import AdamWConfig, adamw_init
from ..train.train_step import TrainState, make_train_step
from ..tree import leaves
from . import analysis, cost
from .mesh import make_production_mesh

# --------------------------------------------------------------------------
# the state of one cell
# --------------------------------------------------------------------------


def input_specs(cfg: ArchConfig, cell: ShapeCell, device="meta", generator=None) -> dict:
    """The batch of one step (tokens and labels int32, as in the
    reference), seeded random values from ``generator``, or none on the
    meta device."""
    B, S = cell.global_batch, cell.seq_len
    dt = torch.bfloat16

    def ints(*shape):
        if generator is None:
            return torch.empty(shape, dtype=torch.int32, device=device)
        return torch.randint(0, cfg.vocab_size, shape, generator=generator,
                             dtype=torch.int32, device=device)

    def floats(*shape):
        if generator is None:
            return torch.empty(shape, dtype=dt, device=device)
        return torch.randn(shape, generator=generator, device=device).to(dt)

    if cfg.family == "audio":
        return {"frames": floats(B, S, cfg.frontend_dim), "labels": ints(B, S)}
    if cfg.family == "vlm":
        Ti = cfg.vlm_img_tokens
        return {"tokens": ints(B, S - Ti), "labels": ints(B, S - Ti),
                "patch_embeds": floats(B, Ti, cfg.frontend_dim)}
    return {"tokens": ints(B, S), "labels": ints(B, S)}


def fill_positions(cache: Dict[str, Any], pos: int) -> None:
    """Mark every slot of every attention cache written, as at decode
    position ``pos`` after ``pos`` earlier tokens: slot j holds the latest
    position <= pos that the (ring) buffer keeps there, so a decode step
    reads every slot."""
    for sub in cache.values():
        if "pos" in sub:
            W = sub["pos"].shape[-1]
            j = torch.arange(W, dtype=torch.int32, device=sub["pos"].device)
            sub["pos"].copy_((pos - torch.remainder(pos - j, W)).expand_as(sub["pos"]))


def build_state(model: Model, cell: ShapeCell, mesh, generator=None) -> Dict[str, Any]:
    """The placed state of one cell, on the model's device: seeded random
    params (``generator``; on the meta device none) placed by the param
    rules, then by kind: train — AdamW state and a batch; prefill — a
    cache and a prompt batch; decode — a cache whose every slot is written
    (``fill_positions``; with a generator, each rank's shard of every
    floating cache leaf drawn from it), a token a row and ``pos`` =
    seq_len - 1."""
    cfg = model.cfg
    params = model.param_specs() if generator is None else model.init(generator)
    batch = input_specs(cfg, cell, model.device, generator)
    state: Dict[str, Any] = {}
    if cell.kind == "train":
        train = TrainState(params=params, opt=adamw_init(params))
        placed = sh.distribute(train, state_shardings(cfg, train, mesh), mesh)
        state["train"] = placed
        state["batch"] = sh.distribute(batch, sh.batch_shardings(cfg, batch, mesh), mesh)
        return state
    state["params"] = sh.distribute(params, sh.param_shardings(cfg, params, mesh), mesh)
    cache = model.init_cache(cell.global_batch, cell.seq_len)  # in cfg.dtype: bf16 at full width
    if cell.kind == "decode":
        fill_positions(cache, cell.seq_len - 1)
        state["tokens"] = sh.distribute(
            batch["tokens"][:, :1].contiguous(),
            sh.to_placements(sh.batch_spec(mesh, (cell.global_batch, 1)), mesh), mesh)
        state["pos"] = cell.seq_len - 1
    else:
        batch.pop("labels")
        state["batch"] = sh.distribute(batch, sh.batch_shardings(cfg, batch, mesh), mesh)
    state["cache"] = sh.distribute(cache, sh.cache_shardings(cfg, cache, mesh), mesh)
    if cell.kind == "decode" and generator is not None:
        for t in leaves(state["cache"]):
            if t.is_floating_point():
                t.to_local().normal_(generator=generator)
    return state


def set_opts(model: Model, cell: ShapeCell, mesh, opts=()) -> None:
    """The optimisation flags of ``opts`` (and the batch axes), as the
    reference's dry run sets them."""
    opt_flags.reset()
    b = sh.batch_axes(mesh, cell.global_batch)
    opt_flags.set_flags(batch_axes=b)
    if "sp" in opts and cell.seq_len % max(sh.axis_size(mesh, "model"), 1) == 0:
        # sequence-parallel residual stream (shard S over `model`)
        model.act_spec = (b, "model", None)
        opt_flags.set_flags(sp=True)
    for flag in ("mamba_heads", "moe_ep", "sp_sub"):
        if flag in opts:
            opt_flags.set_flags(**{flag: True})
    if "moe_a2a" in opts:
        opt_flags.set_flags(moe_a2a=True, mesh=mesh)


def run_step(model: Model, cell: ShapeCell, state: Dict[str, Any]):
    """One step of the cell's kind on its state: train — loss, grads and
    AdamW (the state is updated in place); prefill — the prompt into the
    cache; decode — one token.  Returns the step's output."""
    if cell.kind == "train":
        return make_train_step(model, AdamWConfig())(state["train"], state["batch"])
    if cell.kind == "prefill":
        return model.prefill(state["params"], state["batch"], state["cache"])
    return model.decode_step(state["params"], state["cache"], state["tokens"], state["pos"])


def measure(model: Model, cell: ShapeCell, mesh) -> Dict[str, Any]:
    """The per-device cost of one step of ``cell`` on ``mesh``, counted
    with ``model`` on the meta device: ``CostMode`` after the step, the
    state's bytes, and the state's bytes as the allocator rounds them."""
    state = build_state(model, cell, mesh)
    mode = cost.CostMode(chunk=model.cfg.ssm_chunk)
    allocated = mode.track(state)
    with mode:
        run_step(model, cell, state)
    return {"mode": mode, "state_bytes": cost.state_bytes(state, allocated=False),
            "state_allocated_bytes": allocated}


# --------------------------------------------------------------------------
# per-cell dry run
# --------------------------------------------------------------------------


def run_cell(
    arch: str,
    shape: str,
    multi_pod: bool,
    verbose: bool = True,
    mesh=None,
    cfg: Optional[ArchConfig] = None,
    opts: tuple = (),
) -> dict:
    """One cell on ``mesh`` (a DeviceMesh on the caller's process group),
    or, by default, on the production mesh of a fake process group that
    is made here and destroyed before returning."""
    if mesh is None:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=512 if multi_pod else 256)
        try:
            return run_cell(arch, shape, multi_pod, verbose,
                            make_production_mesh(multi_pod=multi_pod),
                            cfg, opts)
        finally:
            dist.destroy_process_group()
    cfg = cfg or get_config(arch)
    cell = SHAPES[shape]
    model = Model(cfg, device="meta")
    set_opts(model, cell, mesh, opts)
    t0 = time.time()
    try:
        got = measure(model, cell, mesh)
    finally:
        opt_flags.reset()
    mode = got["mode"]
    n_active = active_params(cfg, model.param_specs())
    terms = analysis.RooflineTerms(
        arch=arch,
        shape=shape,
        mesh="x".join(str(n) for n in mesh.shape),
        n_devices=mesh.size(),
        flops=mode.flops,
        bytes=mode.bytes,
        coll_bytes=mode.coll_bytes,
        coll_breakdown={k: int(v) for k, v in mode.coll.items()},
        model_flops=analysis.model_flops_for(cfg, cell, n_active),
        peak_memory_bytes=float(mode.peak_bytes),
    )
    result = {
        "ok": True,
        "run_s": round(time.time() - t0, 1),
        "state_bytes": got["state_bytes"],
        "state_allocated_bytes": got["state_allocated_bytes"],
        "kernel_calls": mode.kernel_calls,
        **terms.to_dict(),
    }
    if verbose:
        print(json.dumps(result, indent=2, default=str))
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--opt", default="", help="comma-separated optimizations (e.g. sp)")
    args = ap.parse_args()
    opts = tuple(o for o in args.opt.split(",") if o)

    if args.all:
        outdir = Path(args.out or "results/dryrun_torch")
        outdir.mkdir(parents=True, exist_ok=True)
        mesh_tag = "multi" if args.multi_pod else "single"
        for arch in list_archs():
            cfg = get_config(arch)
            for shape in applicable_shapes(cfg):
                path = outdir / f"{arch}__{shape}__{mesh_tag}.json"
                if args.skip_existing and path.exists():
                    print(f"skip {path}")
                    continue
                print(f"=== {arch} x {shape} x {mesh_tag} ===", flush=True)
                try:
                    res = run_cell(arch, shape, args.multi_pod, verbose=False, opts=opts)
                except Exception as e:  # record failures for triage
                    res = {"ok": False, "error": repr(e), "traceback": traceback.format_exc()}
                    print(f"FAILED: {e!r}", flush=True)
                path.write_text(json.dumps(res, indent=2, default=str))
                print(
                    f"-> {path} ok={res.get('ok')} run={res.get('run_s')}s "
                    f"fits_h100={res.get('fits_h100')} "
                    f"peak={res.get('peak_memory_bytes', 0) / 1e9:.2f}GB "
                    f"flops={res.get('flops', 0):.4g} coll={res.get('coll_bytes', 0):.4g} "
                    f"bottleneck={res.get('bottleneck')}",
                    flush=True,
                )
        return

    res = run_cell(args.arch, args.shape, args.multi_pod, opts=opts)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=2, default=str))


if __name__ == "__main__":
    main()
