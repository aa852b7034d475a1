"""Multi-rank runs of the port on the CPU over gloo, for
tests/test_torch_parallel.py.

    python tests/_torch_parallel_worker.py CASE[,CASE...] WORLD OUT_DIR

starts WORLD ranks (spawned processes, one gloo group on a FileStore in
OUT_DIR: no network) that run each CASE in turn; rank 0 writes what the test compares
into OUT_DIR as .npz files.  Every input is drawn from a numpy or torch
seed, alike on every rank.
"""
from __future__ import annotations

import json
import sys
from contextlib import contextmanager, nullcontext
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor

from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeCell
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
    # the hybrid's one super-block of 8 layers (attention, Mamba, the placed
    # MoE and dense FF); at two (16 fp32 layers) the grads' own rounding noise
    # is above TOL: a 1e-7 relative change of every weight moves a leaf's
    # grad by up to 2.9e-5 of its largest magnitude
    "jamba-1.5-large-398b": ("jamba-1.5-large-398b", (), {"n_layers": 8}),
    # under sp the gated norm and out_proj run on each rank's sequence rows
    # (mamba._gate_and_project_rows)
    "jamba-1.5-large-398b/sp": ("jamba-1.5-large-398b", ("sp",), {"n_layers": 8}),
    # the same under torch 2.11's rules (rules_of_2_11: the sequence-split
    # residual never viewed with (B, S) flattened; dtensor_util.AT_LEAST_2_13
    # false: the attention and MLP products on the sequence rows, the MoE
    # output placed as its input, the embedding looked up on each rank's
    # tokens)
    "jamba-1.5-large-398b/sp/below_2_13": ("jamba-1.5-large-398b", ("sp", "below_2_13"),
                                           {"n_layers": 8}),
    # a GQA model whose one KV head `model` does not split (K/V on each
    # rank's own rows), with the plain GeLU MLP, and a model whose
    # unembedding is its token table, under 2.11's rules
    "granite-34b/sp/below_2_13": ("granite-34b", ("sp", "below_2_13"), {}),
    "mamba2-370m/sp/below_2_13": ("mamba2-370m", ("sp", "below_2_13"), {}),
    # the Mamba block alone, on each rank's sequence rows under sp
    # (mamba._rows_mix, the SSD scan split on its sequence)
    "mamba2-370m/sp": ("mamba2-370m", ("sp",), {}),
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


@contextmanager
def rules_of_2_11():
    """torch 2.11's DTensor on this torch, as far as the port meets it: the
    model takes the placements it takes below 2.13
    (``dtensor_util.AT_LEAST_2_13`` false where it is read), and a view
    that flattens a dim split on a mesh dim into the dim before it (the
    ``sp`` residual's (B, S)) is refused, as 2.11 refuses it, where 2.13
    keeps the split as a strided one
    (``_ViewShardingPropagator._analyze_flatten``).  DTensor's caches of
    sharding decisions are cleared on entry and exit.  On torch below 2.13
    these are its own rules, and nothing is patched."""
    from repro_torch.dtensor_util import AT_LEAST_2_13

    if not AT_LEAST_2_13:
        yield
        return
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._ops._view_ops import _ViewShardingPropagator
    from torch.distributed.tensor.debug import _clear_sharding_prop_cache

    from repro_torch.models import layers

    analyze = _ViewShardingPropagator._analyze_flatten

    def refuse(self, cmd):
        if self.strict_view:
            for dim in cmd.input_dims[1:]:
                if any(isinstance(p, Shard) and p.dim == dim.input_dim
                       for p in self.input_src_placements):
                    raise RuntimeError(f"rules of torch 2.11: cannot view dim {dim.input_dim}, "
                                       f"split over the mesh, flattened into the dim before it")
        return analyze(self, cmd)

    gate = layers.AT_LEAST_2_13
    _clear_sharding_prop_cache()
    layers.AT_LEAST_2_13, _ViewShardingPropagator._analyze_flatten = False, refuse
    try:
        yield
    finally:
        layers.AT_LEAST_2_13, _ViewShardingPropagator._analyze_flatten = gate, analyze
        _clear_sharding_prop_cache()


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
            rules = rules_of_2_11() if "below_2_13" in flags else nullcontext()
            with scan_placements() as scans, rules:
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


# (arch, batch, prompt length, decode steps, flags): a cache split on its
# batch, (one row) a sliding-window ring split on its slots over `data`,
# and a Mamba cache written by a prefill on each rank's sequence rows (sp)
DECODE = {"deepseek-7b/batch": ("deepseek-7b", 2, 12, 3, ()),
          "h2o-danube-3-4b/slots": ("h2o-danube-3-4b", 1, 64, 3, ()),
          "mamba2-370m/sp": ("mamba2-370m", 2, 16, 3, ("sp",))}


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
    leaf = next(iter(next(iter(cache.values())).values()))
    return leaf.device_mesh if isinstance(leaf, DTensor) else None


def run_decode(rank: int, out: Path) -> None:
    """Prefill and decode on (data 2, model 2) with the cache placed by the
    rules: each step's logits."""
    mesh = make_debug_mesh(4, 2, device_type="cpu")
    for name, (arch, batch, prompt, steps, flags) in DECODE.items():
        cfg, params, toks = decode_inputs(arch, batch, prompt)
        model = Model(cfg, device="cpu")
        dparams = sh.distribute(params, sh.param_shardings(cfg, params, mesh), mesh)
        cache = model.init_cache(batch, prompt + steps)
        placements = sh.cache_shardings(cfg, cache, mesh)
        dcache = sh.distribute(cache, placements, mesh)
        dtoks = sh.distribute(toks, sh.to_placements(sh.batch_spec(mesh, toks.shape), mesh), mesh)
        set_flags(model, flags, mesh, batch)
        try:
            got = [_full(x).detach().numpy() for x in serve(model, dparams, dcache, dtoks, steps)]
        finally:
            opt_flags.reset()
        leaf = "k" if "k" in placements["sub0"] else "ssm"
        if rank == 0:
            np.savez(out / f"decode_{name.replace('/', '__')}.npz", *got,
                     placements=str(placements["sub0"][leaf]))


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


# (arch, mesh (data, model), batch, flags, config overrides): the MoE layer
# alone on DTensors, its dispatch slab placed (``moe._placed_experts``)
MOE_PLACED = {
    "qwen3-moe-30b-a3b/2x2": ("qwen3-moe-30b-a3b", (2, 2), 4, (), {}),
    "qwen3-moe-30b-a3b/2x2/moe_ep": ("qwen3-moe-30b-a3b", (2, 2), 4, ("moe_ep",), {}),
    # pairs dropped at every expert's capacity
    "moonshot-v1-16b-a3b/2x2/drops": ("moonshot-v1-16b-a3b", (2, 2), 4, (), {"capacity_factor": 0.5}),
    # C = 16 slots over 3 batch ranks: the slab padded to 18
    "qwen3-moe-30b-a3b/3x2": ("qwen3-moe-30b-a3b", (3, 2), 3, (), {"capacity_factor": 0.5}),
    "qwen3-moe-30b-a3b/3x2/moe_ep": ("qwen3-moe-30b-a3b", (3, 2), 3, ("moe_ep",), {}),
}


def moe_inputs(arch: str, batch: int, overrides: dict):
    """(cfg, MoE params, x [batch, S, D], a cotangent for the output),
    alike on every rank."""
    cfg = reduced_config(arch, **overrides)
    p = TX.init_moe(torch.Generator().manual_seed(4), cfg)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((batch, S, cfg.d_model)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((batch, S, cfg.d_model)).astype(np.float32))
    return cfg, p, x, dy


def moe_layer(cfg, p, x, dy):
    """``apply_moe`` and ``route`` on ``x`` (DTensors or not), the params'
    FSDP shards gathered as a block gathers them: the output, aux, the
    routing's fields and the grads of ``(y * dy).sum() + aux`` to x and
    each param."""
    live = tree_map(lambda t: t.detach().requires_grad_(), {"x": x, **p})
    gathered = sh.gather_fsdp({k: v for k, v in live.items() if k != "x"})
    y, aux = TX.apply_moe(gathered, cfg, live["x"])
    grads = torch.autograd.grad((y * dy).sum() + aux, list(live.values()))
    xt = live["x"].detach()
    r = TX.route(gathered["router"].detach(), cfg, xt.reshape(-1, cfg.d_model))
    res = {"y": y, "aux": aux, **{f"grad/{k}": g for k, g in zip(live, grads)}}
    res.update({f"route/{k}": v for k, v in r._asdict().items() if k != "capacity"})
    return {k: _full(v).detach() for k, v in res.items()}


def run_moe_placed(rank: int, out: Path) -> None:
    world = dist.get_world_size()
    for name, (arch, (data, model_axis), batch, flags, overrides) in MOE_PLACED.items():
        if data * model_axis != world:
            continue
        mesh = make_debug_mesh(world, model_axis, device_type="cpu")
        cfg, p, x, dy = moe_inputs(arch, batch, overrides)
        place = lambda t: sh.to_placements(sh.batch_spec(mesh, t.shape), mesh)  # noqa: E731
        dp = sh.distribute(p, sh.param_shardings(cfg, p, mesh), mesh)
        opt_flags.reset()
        opt_flags.set_flags(batch_axes=sh.batch_axes(mesh, batch), **{f: True for f in flags})
        try:
            res = moe_layer(cfg, dp, sh.distribute(x, place(x), mesh), sh.distribute(dy, place(dy), mesh))
        finally:
            opt_flags.reset()
        if rank == 0:
            np.savez(out / f"moe_{name.replace('/', '__')}.npz", **{k: v.numpy() for k, v in res.items()})


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


# (batch, rows a rank, chunk): the SSD scan split on its sequence over
# every rank, each rank's rows a multiple of the chunk and not
SEQ_SCANS = {"chunk_multiple": (2, 32, 16), "not_chunk_multiple": (2, 12, 16)}
CONV_ROWS = (1, 2, 3)  # rows a rank of the causal conv split on its sequence


def seq_split_inputs(seed: int, *shapes):
    """fp32 arrays of ``shapes`` drawn from one numpy seed, alike on every rank."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]


def _grads_of(fn, tensors, cotangents):
    """(outputs of fn(*tensors), the gradients of the sum of each output
    times its cotangent to every tensor), gathered whole."""
    live = [t.detach().requires_grad_() for t in tensors]
    outs = fn(*live)
    loss = sum((o * c).sum() for o, c in zip(outs, cotangents))
    return [_full(o).detach() for o in outs] + [_full(g) for g in torch.autograd.grad(loss, live)]


def run_seq_split(rank: int, out: Path) -> None:
    """On (data 1, model WORLD): the SSD scan wrapper with x, dt, B and C
    split on the sequence (ops._ssd_rows), with and without an initial
    state, and the causal conv on each rank's rows with its halo
    (mamba._conv_rows) and its cache window, against the same functions on
    the whole tensors: outputs and the gradients of a seeded cotangent."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import ops
    from repro_torch.models import mamba as M

    world = dist.get_world_size()
    mesh = make_debug_mesh(world, world, device_type="cpu")
    rows, whole = (Replicate(), Shard(1)), (Replicate(), Replicate())
    put = lambda t, p: distribute_tensor(t, mesh, p, src_data_rank=None)  # noqa: E731
    res = {}
    H, P, N = 4, 16, 16
    for name, (B, per, chunk) in SEQ_SCANS.items():
        S = per * world
        x, Bm, Cm, gy, h0, gs = seq_split_inputs(6, (B, S, H, P), (B, S, N), (B, S, N),
                                                 (B, S, H, P), (B, H, N, P), (B, H, N, P))
        rng = np.random.default_rng(7)
        dt = torch.from_numpy(rng.uniform(0.01, 0.2, (B, S, H)).astype(np.float32))
        A = -torch.from_numpy(rng.uniform(0.5, 4.0, H).astype(np.float32))
        for init in (False, True):
            ins = (x, dt, A, Bm, Cm) + ((h0,) if init else ())
            at = (rows, rows, whole, rows, rows, whole)
            scan = lambda x, dt, A, Bm, Cm, *h: ops.ssd_scan(x, dt, A, Bm, Cm, chunk, *h)  # noqa: E731
            got = _grads_of(scan, [put(t, p) for t, p in zip(ins, at)], (put(gy, rows), put(gs, whole)))
            res[f"ssd/{name}/{'init' if init else 'zero'}"] = (got, _grads_of(scan, ins, (gy, gs)))
    k, Ch = 4, 8
    for per in CONV_ROWS:
        S = per * world
        xbc, w, b, g = seq_split_inputs(8 + per, (2, S, Ch), (k, Ch), (Ch,), (2, S, Ch))

        def placed(xbc, w, b):
            conv, window = M._conv_rows(xbc, w, b)
            return conv, window()

        def plain(xbc, w, b):
            pad = torch.cat([xbc.new_zeros((2, k - 1, Ch)), xbc], 1)
            return M._causal_conv(xbc, w, b), pad[:, -(k - 1):]

        last = torch.from_numpy(np.random.default_rng(9).standard_normal((2, k - 1, Ch)).astype(np.float32))
        got = _grads_of(placed, (put(xbc, rows), put(w, whole), put(b, whole)),
                        (put(g, rows), put(last, whole)))
        res[f"conv/{per}_rows"] = (got, _grads_of(plain, (xbc, w, b), (g, last)))
    if rank == 0:
        np.savez(out / f"seq_split_{world}.npz",
                 **{f"{k}/got/{i}": t.numpy() for k, (a, _) in res.items() for i, t in enumerate(a)},
                 **{f"{k}/want/{i}": t.numpy() for k, (_, b) in res.items() for i, t in enumerate(b)})


# the cells whose kernel calls the 2x2 run records (reduced jamba, one
# super-block: attention, Mamba and MoE), and the config's overrides
CALL_ARCH = ("jamba-1.5-large-398b", {"n_layers": 8})
CALL_CELLS = {"prefill": ShapeCell("prefill_32", 32, 4, "prefill"),
              "decode": ShapeCell("decode_32", 32, 4, "decode"),
              "train": ShapeCell("train_32", 32, 4, "train")}


@contextmanager
def local_calls():
    """Every kernel wrapper call that comes as plain tensors while the
    block runs (on DTensors: each rank's local shard, inside local_map),
    recorded as ``cost.kernel_call`` records it on the meta device: {JSON
    of the call: count}, filled in."""
    import inspect

    from repro_torch.kernels import ops
    from repro_torch.launch.cost import kernel_call

    seen = {}

    def record(name, args):
        if name == "rmsnorm":
            ins, attrs = {"x": args["x"], "scale": args["scale"]}, {"eps": args["eps"]}
        elif name == "flash_attention":
            ins = {k: args[k] for k in ("q", "k", "v", "q_pos", "kv_pos")}
            attrs = {"causal": bool(args["causal"]), "window": args["window"]}
        else:
            ins = {"x": args["x"], "dt": args["dt"], "A": args["A"], "B": args["Bm"], "C": args["Cm"]}
            if args["init_state"] is not None:
                ins["init_state"] = args["init_state"]
            out_dtype = args["out_dtype"] or args["x"].dtype
            attrs = {"chunk": args["chunk"], "out_dtype": str(out_dtype).split(".")[-1]}
        key = json.dumps(kernel_call(name, ins, attrs), sort_keys=True)
        seen[key] = seen.get(key, 0) + 1

    def wrap(name, fn):
        sig = inspect.signature(fn)

        def call(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            if not isinstance(args[0], DTensor):
                record(name, bound.arguments)
            return fn(*args, **kwargs)

        return call

    saved = {name: getattr(ops, name) for name in ("rmsnorm", "flash_attention", "ssd_scan")}
    for name, fn in saved.items():
        setattr(ops, name, wrap(name, fn))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def run_call_shapes(rank: int, out: Path) -> None:
    """One step of each CALL_CELLS cell on (data 2, model 2), its state
    built and placed as the dry run builds it (``dryrun.build_state``, from
    a seed): the local kernel calls of rank 0."""
    from repro_torch.launch import dryrun

    arch, overrides = CALL_ARCH
    cfg = reduced_config(arch, **overrides)
    mesh = make_debug_mesh(4, 2, device_type="cpu")
    got = {}
    for name, cell in CALL_CELLS.items():
        model = Model(cfg, device="cpu")
        state = dryrun.build_state(model, cell, mesh, torch.Generator().manual_seed(0))
        dryrun.set_opts(model, cell, mesh)
        try:
            with local_calls() as seen:
                dryrun.run_step(model, cell, state)
        finally:
            opt_flags.reset()
        got[name] = [{**json.loads(k), "count": n} for k, n in seen.items()]
    if rank == 0:
        (out / "call_shapes.json").write_text(json.dumps(got))


CASES = {"parity": run_parity, "wrappers": run_wrappers, "decode": run_decode, "ep_vs_jax": run_ep_vs_jax,
         "elastic_save": run_elastic_save, "elastic_restore": run_elastic_restore,
         "moe_placed": run_moe_placed, "call_shapes": run_call_shapes,
         "seq_split": run_seq_split}


def _rank(rank: int, case: str, world: int, out: str) -> None:
    torch.set_num_threads(1)
    # an absolute path: a relative one would read as the URL's host
    dist.init_process_group("gloo", init_method=f"file://{Path(out).resolve()}/store_{world}",
                            rank=rank, world_size=world, timeout=timedelta(seconds=120))
    try:
        for one in case.split(","):
            CASES[one](rank, Path(out))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    case, world, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    mp.start_processes(_rank, args=(case, world, out), nprocs=world, start_method="spawn")
