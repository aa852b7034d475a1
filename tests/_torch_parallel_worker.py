"""Multi-rank runs of the port on the CPU over gloo, for
tests/test_torch_parallel.py.

    python tests/_torch_parallel_worker.py CASE[,CASE...] WORLD OUT_DIR

starts WORLD ranks (spawned processes, one gloo group on a FileStore in
OUT_DIR: no network) that run each CASE in turn; rank 0 writes what the test compares
into OUT_DIR as .npz files.  Every input is drawn from a numpy or torch
seed, alike on every rank.
"""
from __future__ import annotations

import sys
from contextlib import contextmanager
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor

from repro_torch.configs import reduced_config
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import Model
from repro_torch.models import moe as TX
from repro_torch.parallel import opt_flags
from repro_torch.parallel import sharding as sh
from repro_torch.train import checkpoint
from repro_torch.train.fault_tolerance import elastic_restore, plan_elastic_mesh, state_shardings
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import TrainState, loss_and_grads, train_state_template
from repro_torch.tree import leaves_with_paths, tree_map

# (arch, flags, config overrides): the 2x2 parity cases
PARITY = {
    "deepseek-7b/sp": ("deepseek-7b", ("sp",), {}),
    "mamba2-370m/mamba_heads": ("mamba2-370m", ("mamba_heads",), {}),
    "qwen3-moe-30b-a3b/moe_ep": ("qwen3-moe-30b-a3b", ("moe_ep",), {}),
    # no pair drops at this capacity, as in tests/test_moe_shard_map.py
    "qwen3-moe-30b-a3b/moe_a2a": ("qwen3-moe-30b-a3b", ("moe_a2a",), {"capacity_factor": 8.0}),
}
B, S = 4, 16


def parity_inputs(arch: str, overrides: dict):
    """(cfg, params, batch of distinct rows, batch whose two halves are the
    same rows) for one parity case, alike on every rank."""
    cfg = reduced_config(arch, **overrides)
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    distinct = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    twice = {k: torch.cat([v[: B // 2]] * 2) for k, v in distinct.items()}
    return cfg, params, distinct, twice


def set_flags(model: Model, flags, mesh, batch: int) -> None:
    """The flags as launch/dryrun.py sets them from ``--opt``."""
    opt_flags.reset()
    b = sh.batch_axes(mesh, batch)
    opt_flags.set_flags(batch_axes=b)
    if "sp" in flags:
        model.act_spec = (b, "model", None)
        opt_flags.set_flags(sp=True)
    for f in ("mamba_heads", "moe_ep"):
        if f in flags:
            opt_flags.set_flags(**{f: True})
    if "moe_a2a" in flags:
        opt_flags.set_flags(moe_a2a=True, mesh=mesh)


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


@contextmanager
def scan_placements():
    """The placements of x at every SSD scan that reaches the kernel
    wrapper's DTensor branch while the block runs (a list, filled in)."""
    from repro_torch.kernels import ops

    seen, run = [], ops._ssd_dtensor

    def record(x, *args):
        seen.append(str(x.placements))
        return run(x, *args)

    ops._ssd_dtensor = record
    try:
        yield seen
    finally:
        ops._ssd_dtensor = run


def run_parity(rank: int, out: Path) -> None:
    mesh = make_debug_mesh(4, 2, device_type="cpu")
    for name, (arch, flags, overrides) in PARITY.items():
        cfg, params, distinct, twice = parity_inputs(arch, overrides)
        model = Model(cfg, device="cpu")
        dparams = sh.distribute(params, sh.param_shardings(cfg, params, mesh), mesh)
        set_flags(model, flags, mesh, B)
        res = {}
        for tag, batch in (("distinct", distinct), ("twice", twice)):
            dbatch = sh.distribute(batch, sh.batch_shardings(cfg, batch, mesh), mesh)
            with scan_placements() as scans:
                logits, _ = model.prefill(dparams, {"tokens": dbatch["tokens"]})
                loss, metrics, grads = loss_and_grads(model, dparams, dbatch)
            res[f"{tag}/scan_x"] = np.array(scans, dtype=str)
            res[f"{tag}/logits"] = _full(logits)
            res[f"{tag}/loss"] = _full(loss)
            res[f"{tag}/xent"] = _full(metrics["xent"])
            for path, g in leaves_with_paths(grads):
                res[f"{tag}/grad/{path}"] = _full(g)
        opt_flags.reset()
        if rank == 0:
            np.savez(out / f"{name.replace('/', '__')}.npz",
                     **{k: v if isinstance(v, np.ndarray) else v.detach().numpy()
                        for k, v in res.items()})


# (arch, batch, prompt length, decode steps): a cache split on its batch,
# and (one row) a sliding-window ring split on its slots over `data`
DECODE = {"deepseek-7b/batch": ("deepseek-7b", 2, 12, 3),
          "h2o-danube-3-4b/slots": ("h2o-danube-3-4b", 1, 64, 3)}


def decode_inputs(arch: str, batch: int, prompt: int):
    """(cfg, params, prompt tokens) of one decode case, alike on every rank."""
    cfg = reduced_config(arch)
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(2))
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (batch, prompt))
    return cfg, params, torch.from_numpy(toks)


def serve(model, params, cache, toks, steps):
    """Prefill ``toks`` into ``cache``, then ``steps`` greedy decode steps
    at Python-int positions: each step's logits."""
    logits, _ = model.prefill(params, {"tokens": toks}, cache)
    out, pos = [logits], toks.shape[1]
    for _ in range(steps):
        nxt = _full(logits).argmax(-1).to(toks.dtype)
        nxt = sh.distribute(nxt, sh.to_placements(sh.batch_spec(cache_mesh(cache), nxt.shape),
                                                  cache_mesh(cache)), cache_mesh(cache)) \
            if cache_mesh(cache) is not None else nxt
        logits, _ = model.decode_step(params, cache, nxt, pos)
        out.append(logits)
        pos += 1
    return out


def cache_mesh(cache):
    k = next(iter(cache.values()))["k"]
    return k.device_mesh if isinstance(k, DTensor) else None


def run_decode(rank: int, out: Path) -> None:
    """Prefill and decode on (data 2, model 2) with the cache placed by the
    rules: each step's logits."""
    mesh = make_debug_mesh(4, 2, device_type="cpu")
    for name, (arch, batch, prompt, steps) in DECODE.items():
        cfg, params, toks = decode_inputs(arch, batch, prompt)
        model = Model(cfg, device="cpu")
        dparams = sh.distribute(params, sh.param_shardings(cfg, params, mesh), mesh)
        cache = model.init_cache(batch, prompt + steps)
        placements = sh.cache_shardings(cfg, cache, mesh)
        dcache = sh.distribute(cache, placements, mesh)
        dtoks = sh.distribute(toks, sh.to_placements(sh.batch_spec(mesh, toks.shape), mesh), mesh)
        got = [_full(x).detach().numpy() for x in serve(model, dparams, dcache, dtoks, steps)]
        if rank == 0:
            np.savez(out / f"decode_{name.replace('/', '__')}.npz", *got,
                     placements=str(placements["sub0"]["k"]))


def run_ep_vs_jax(rank: int, out: Path) -> None:
    """apply_moe_shard_map on (data 4, model 2) with the JAX run's weights
    and input (OUT/jax_ep.npz), its output, aux and grads."""
    got = np.load(out / "jax_ep.npz")
    cfg = reduced_config("qwen3-moe-30b-a3b", capacity_factor=8.0)
    mesh = make_debug_mesh(8, 2, device_type="cpu")
    p = {k: torch.from_numpy(got[f"p/{k}"]) for k in ("router", "w_up", "w_gate", "w_down")}
    x = torch.from_numpy(got["x"])
    dp = sh.distribute(p, {k: sh.to_placements(sh._param_spec((k,), v, cfg, mesh), mesh)
                           for k, v in p.items()}, mesh)
    dx = sh.distribute(x, sh.to_placements(sh.batch_spec(mesh, x.shape), mesh), mesh)
    live = tree_map(lambda t: t.detach().requires_grad_(), dp)
    y, aux = TX.apply_moe_shard_map(live, cfg, dx, mesh, "data")
    grads = torch.autograd.grad(y.sum(), list(live.values()))
    res = {"y": _full(y), "aux": _full(aux), **{f"grad/{k}": _full(g) for k, g in zip(live, grads)}}
    if rank == 0:
        np.savez(out / "port_ep.npz", **{k: v.detach().numpy() for k, v in res.items()})


def elastic_state(cfg):
    """A seeded train state: params, first moments, step 7."""
    gen = torch.Generator().manual_seed(3)
    params = Model(cfg, device="cpu").init(gen)
    opt = adamw_init(params)
    opt = opt._replace(m=tree_map(lambda t: torch.randn(t.shape, generator=gen), opt.m),
                       step=torch.tensor(7, dtype=torch.int32))
    return TrainState(params=params, opt=opt)


class FakeGroup:
    """A fake default process group of ``n`` ranks (this process being
    ``rank``), destroyed on exit, so no large group outlives a test."""

    def __init__(self, n: int, rank: int = 0):
        self.n, self.rank = n, rank

    def __enter__(self):
        from repro_torch.launch.dryrun import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=self.rank, world_size=self.n)
        return self

    def __exit__(self, *exc):
        dist.destroy_process_group()


def run_elastic_save(rank: int, out: Path) -> None:
    """A train state placed on 4 ranks (data 2, model 2), gathered and
    saved by rank 0."""
    cfg = reduced_config("deepseek-7b")
    state = elastic_state(cfg)
    mesh = make_debug_mesh(4, 2, device_type="cpu")
    placed = sh.distribute(state, state_shardings(cfg, state, mesh), mesh)
    full = tree_map(_full, placed)
    if rank == 0:
        checkpoint.save(out / "ckpt", 7, full, {"world": 4})


def run_elastic_restore(rank: int, out: Path) -> None:
    """The 4-rank checkpoint restored onto 2 ranks (data 1, model 2)."""
    cfg = reduced_config("deepseek-7b")
    data, model_axis = plan_elastic_mesh(2, 2)
    mesh = make_debug_mesh(data * model_axis, model_axis, device_type="cpu")
    template = train_state_template(Model(cfg, device="cpu"))
    state, meta, shardings = elastic_restore(out / "ckpt", template, cfg, mesh)
    placed = [(k, v.placements, tuple(v.to_local().shape))
              for k, v in leaves_with_paths(state) if isinstance(v, DTensor)]
    full = tree_map(_full, state)
    if rank == 0:
        np.savez(out / "restored.npz", **{k: v.numpy() for k, v in leaves_with_paths(full)})
        (out / "restored_meta.txt").write_text(
            f"{meta}\n" + "\n".join(f"{k} {p} {s}" for k, p, s in placed))


def run_wrappers(rank: int, out: Path) -> None:
    """Each kernel wrapper on DTensors against the same wrapper on the
    whole tensors (the plain versions here), at every placement the
    kernels take on a (data 2, model 2) mesh; and the placements that
    must raise."""
    from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor

    from repro_torch.kernels import ops

    mesh = make_debug_mesh(4, 2, device_type="cpu")
    g = torch.Generator().manual_seed(5)
    rnd = lambda *shape: torch.randn(shape, generator=g)  # noqa: E731
    put = lambda t, *p: distribute_tensor(t, mesh, list(p))  # noqa: E731
    res, raised = {}, []
    x, scale = rnd(4, 8, 16), rnd(16)
    for i, p in enumerate([(Shard(0), Shard(1)), (Replicate(), Shard(0)), (Shard(1), Replicate())]):
        res[f"rmsnorm/{i}"] = (ops.rmsnorm(put(x, *p), put(scale, Replicate(), Replicate())),
                               ops.rmsnorm(x, scale))
    B, Sq, H, G, K = 4, 8, 4, 2, 16
    q, k, v = rnd(B, Sq, H, K), rnd(B, Sq, G, K), rnd(B, Sq, G, K)
    pos = torch.arange(Sq, dtype=torch.int32)
    want = ops.flash_attention(q, k, v, pos, pos, True, None)
    cases = {  # (q placements, k/v placements)
        "batch,heads": ((Shard(0), Shard(2)), (Shard(0), Shard(2))),
        "heads,q-seq": ((Shard(2), Shard(1)), (Shard(2), Replicate())),
        "batch,kv-seq": ((Shard(0), Replicate()), (Shard(0), Shard(1))),
        "batch,kv-heads-whole": ((Shard(0), Shard(2)), (Shard(0), Replicate())),
    }
    for name, (qp, kp) in cases.items():
        res[f"flash/{name}"] = (
            ops.flash_attention(put(q, *qp), put(k, *kp), put(v, *kp), pos, pos, True, None), want)
    H, P, N = 4, 16, 16
    xs, dt, A = rnd(B, 32, H, P), torch.rand(B, 32, H, generator=g), -torch.rand(H, generator=g)
    Bm, Cm = rnd(B, 32, N), rnd(B, 32, N)
    y, st = ops.ssd_scan(xs, dt, A, Bm, Cm, 16)
    for name, (a, b) in {"batch,heads": (Shard(0), Shard(2)), "heads,batch": (Shard(2), Shard(0))}.items():
        pick = lambda batch, heads: [{Shard(0): batch, Shard(2): heads}[p] for p in (a, b)]  # noqa: E731
        yd, sd = ops.ssd_scan(put(xs, a, b), put(dt, *pick(Shard(0), Shard(2))),
                              put(A, Replicate(), Replicate()), put(Bm, *pick(Shard(0), Replicate())),
                              put(Cm, *pick(Shard(0), Replicate())), 16)
        res[f"ssd/{name}/y"], res[f"ssd/{name}/state"] = (yd, y), (sd, st)
    for what, call in {
        "rmsnorm D split": lambda: ops.rmsnorm(put(x, Shard(2), Replicate()),
                                               put(scale, Replicate(), Replicate())),
        "rmsnorm partial": lambda: ops.rmsnorm(DTensor.from_local(x, mesh, [Partial(), Replicate()]),
                                               put(scale, Replicate(), Replicate())),
        "flash head dim split": lambda: ops.flash_attention(
            put(q, Shard(3), Replicate()), put(k, Shard(3), Replicate()),
            put(v, Shard(3), Replicate()), pos, pos),
        "ssd state split": lambda: ops.ssd_scan(
            put(xs, Shard(3), Replicate()), put(dt, Replicate(), Replicate()),
            put(A, Replicate(), Replicate()), put(Bm, Replicate(), Replicate()),
            put(Cm, Replicate(), Replicate()), 16),
    }.items():
        try:
            call()
        except ValueError:
            raised.append(what)
    got = {f"{k}/got": _full(a).numpy() for k, (a, _) in res.items()}  # on every rank: a collective
    if rank == 0:
        np.savez(out / "wrappers.npz", **got, **{f"{k}/want": b.numpy() for k, (_, b) in res.items()})
        (out / "wrappers_raised.txt").write_text("\n".join(raised))


CASES = {"parity": run_parity, "wrappers": run_wrappers, "decode": run_decode, "ep_vs_jax": run_ep_vs_jax,
         "elastic_save": run_elastic_save, "elastic_restore": run_elastic_restore}


def _rank(rank: int, case: str, world: int, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/store_{world}",
                            rank=rank, world_size=world, timeout=timedelta(seconds=120))
    try:
        for one in case.split(","):
            CASES[one](rank, Path(out))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    case, world, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    mp.start_processes(_rank, args=(case, world, out), nprocs=world, start_method="spawn")
