"""The port's dry run (repro_torch/launch/dryrun.py, cost.py, analysis.py)
against the JAX package's.

* ``run_cell`` on a fake (data 4, model 2) mesh for reduced qwen3-32b and
  jamba-1.5-large-398b at ``train_4k`` (the JAX test's cells,
  tests/test_sharding.py): ok, FLOPs and collective bytes counted;
  ``model_flops`` and ``active_params`` equal JAX's exactly; the
  per-device bytes of params and of the AdamW moments equal the sum of
  JAX's shard sizes under the same specs, exactly.
* The counted FLOPs of reduced deepseek-7b ``train_4k`` on one device
  within 10 % of ``repro.launch.hlo_cost.analyze`` on the JAX cell, once
  the work the port adds is taken out: its backward recomputes each
  attention forward in the plain version (``kernels/ops.py``, ``_vjp``),
  4 B H S^2 K FLOPs a layer that XLA's backward does not run.  What
  remains between the two is counting: XLA counts 1 FLOP an element of
  every elementwise op and reduction (the softmax over B H S^2 scores
  above all), ``torch.utils.flop_counter`` counts none.
* ``CostMode`` on plain tensors counts what ``FlopCounterMode`` counts.
* A production-mesh cell makes and destroys its own fake group of 256.
* ``CostMode`` counts the scratch of the CUDA softmax backward
  (``cost.SCRATCH``); a decode cell built with a generator has its cache
  drawn from it.
* ``run_cell(by_op=N)`` counts what it counts without, and its by-op
  report adds up: the ops' FLOPs to the cell's, the storages live at the
  peak (the softmax backward's scratch among them) to its peak.
* Under ``sp``, reduced jamba-1.5-large-398b ``train_4k`` on the fake
  (4, 2) mesh (one dry run, shared) peaks below the count it had while
  the gated norm gathered its rows whole, and below the count it had
  while the Mamba block gathered its input whole on the sequence, its
  FLOPs within 1 % of each; reduced deepseek-7b (no Mamba block) counts
  its recorded peak and FLOPs exactly, with and without ``sp``.
* Under torch 2.11's rules (``_torch_parallel_worker.rules_of_2_11``),
  reduced jamba-1.5-large-398b and granite-34b ``train_4k`` under ``sp``
  count the 2.13 path's FLOPs and kernel calls exactly, its peak within
  one allocator block and its collective bytes within 1 % (the lookup of
  a table this small aside), and never hold two residual-shaped tensors
  gathered on the sequence at once.

The reduced configs run at head_dim 64 and in bf16, widths the card's
kernels take (on the meta device the wrappers check what they take).
"""
import contextlib
import dataclasses
import sys
import weakref

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from _torch_parallel_worker import FakeGroup, rules_of_2_11  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.launch import analysis as janalysis  # noqa: E402
from repro.launch import hlo_cost  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models.model import active_params as j_active_params  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.train.optimizer import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.train.train_step import init_train_state, make_train_step  # noqa: E402
from repro_torch import dtensor_util  # noqa: E402
from repro_torch.configs import SHAPES, reduced_config  # noqa: E402
from repro_torch.launch import cost, dryrun  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.model import active_params  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

KW = dict(dtype="bfloat16", head_dim=64)


def _jax_train_specs(jcfg):
    return jax.eval_shape(lambda k: init_train_state(JModel(jcfg), k), jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", ["qwen3-32b", "jamba-1.5-large-398b"])
def test_run_cell_on_a_fake_mesh(arch):
    cfg, jcfg = reduced_config(arch, **KW), j_reduced_config(arch, **KW)
    with FakeGroup(8):
        mesh = make_debug_mesh(8, model=2)
        res = dryrun.run_cell(arch, "train_4k", False, verbose=False, mesh=mesh, cfg=cfg)
        model = Model(cfg, device="meta")
        state = dryrun.build_state(model, SHAPES["train_4k"], mesh)["train"]
    assert res["ok"] and res["flops"] > 0 and res["coll_bytes"] > 0, res
    assert res["n_devices"] == 8 and res["mesh"] == "4x2"
    assert res["peak_memory_bytes"] >= res["state_allocated_bytes"] > 0

    jparams = JModel(jcfg).param_specs()
    n_active = active_params(cfg, model.param_specs())
    assert n_active == j_active_params(jcfg, jparams)
    assert res["model_flops"] == janalysis.model_flops_for(jcfg, J_SHAPES["train_4k"], n_active)

    amesh = AbstractMesh((4, 2), ("data", "model"))
    shards = jax.tree.leaves(jsh.param_shardings(jcfg, jparams, amesh))
    shard_elems = sum(int(np.prod(s.shard_shape(p.shape))) for s, p in
                      zip(shards, jax.tree.leaves(jparams)))
    jbytes = sum(int(np.prod(s.shard_shape(p.shape))) * p.dtype.itemsize for s, p in
                 zip(shards, jax.tree.leaves(jparams)))
    local = lambda tree: [t.to_local() for t in leaves(tree)]  # noqa: E731
    assert sum(t.nbytes for t in local(state.params)) == jbytes
    for moments in (state.opt.m, state.opt.v):  # fp32, placed as the params
        assert sum(t.nbytes for t in local(moments)) == 4 * shard_elems


def test_flops_match_hlo_cost():
    arch, shape = "deepseek-7b", "train_4k"
    cfg, jcfg = reduced_config(arch, **KW), j_reduced_config(arch, **KW)
    jmodel = JModel(jcfg)
    from repro.launch.dryrun import input_specs as j_input_specs

    compiled = jax.jit(make_train_step(jmodel, JAdamWConfig())).lower(
        _jax_train_specs(jcfg), j_input_specs(jcfg, J_SHAPES[shape])).compile()
    xla = hlo_cost.analyze(compiled.as_text()).flops
    with FakeGroup(1):
        res = dryrun.run_cell(arch, shape, False, verbose=False,
                              mesh=make_debug_mesh(1, model=1), cfg=cfg)
    cell = SHAPES[shape]
    recompute = cfg.n_layers * 4 * cell.global_batch * cfg.n_heads * cell.seq_len ** 2 * cfg.head_dim
    assert res["kernel_calls"] == {"rmsnorm": 4 * cfg.n_layers + 1,
                                   "flash_attention": 2 * cfg.n_layers}
    assert abs(res["flops"] - recompute - xla) <= 0.1 * xla, (res["flops"], recompute, xla)


def test_cost_mode_counts_as_flop_counter():
    """On plain meta tensors, with no kernel in the way, the two counts of
    a step of matmuls, a conv and their backward agree exactly."""
    w = torch.empty(64, 32, device="meta", requires_grad=True)
    k = torch.empty(8, 4, 3, device="meta", requires_grad=True)
    x = torch.empty(16, 64, device="meta")

    def step():
        h = torch.tanh(x @ w)
        y = torch.nn.functional.conv1d(h[:, None, :].expand(16, 4, 32).contiguous(), k)
        torch.autograd.grad(y.sum(), [w, k])

    with FlopCounterMode(display=False) as ref:
        step()
    mode = cost.CostMode()
    with mode:
        step()
    assert mode.flops == ref.get_total_flops() > 0


def test_production_cell_makes_and_destroys_its_fake_group():
    res = dryrun.run_cell("mamba2-370m", "long_500k", False, verbose=False)
    assert not dist.is_initialized()
    assert res["ok"] and res["n_devices"] == 256 and res["mesh"] == "16x16"
    assert res["fits_h100"] and res["kernel_calls"] == {"rmsnorm": 97}
    assert res["state_bytes"] <= res["state_allocated_bytes"] <= res["peak_memory_bytes"]


def test_cost_mode_counts_the_softmax_backwards_scratch(monkeypatch):
    """A softmax backward on meta tensors peaks at its gradient and, beside
    it, a scratch of the same size (the CUDA kernel's grad * output, which
    the card's max_memory_allocated shows): two [64, 1024] fp32 blocks,
    one when counted without it."""
    block = cost.allocated_bytes(64 * 1024 * 4)
    grad, out = (torch.empty(64, 1024, device="meta") for _ in range(2))

    def peak():
        mode = cost.CostMode()
        with mode:
            torch.ops.aten._softmax_backward_data(grad, out, -1, torch.float32)
        return mode.peak_bytes

    assert peak() == 2 * block
    monkeypatch.setattr(cost, "SCRATCH", {})
    assert peak() == block


def test_decode_state_draws_its_cache():
    """With a generator, every floating leaf of a decode cell's cache is
    drawn from it (every slot then holds a key and value to attend);
    without one (the meta device), the cache is built empty."""
    with FakeGroup(1):
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        cfg = reduced_config("deepseek-7b")
        cell = dataclasses.replace(SHAPES["decode_32k"], global_batch=2, seq_len=16)
        state = dryrun.build_state(Model(cfg, device="cpu"), cell, mesh, torch.Generator().manual_seed(0))
        floats = [t.to_local() for t in leaves(state["cache"]) if t.is_floating_point()]
        assert floats and all(bool((t != 0).all()) for t in floats)


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_cost_by_op_adds_up(shape):
    cfg = reduced_config("qwen3-moe-30b-a3b", **KW)
    with FakeGroup(8):
        mesh = make_debug_mesh(8, model=2)
        plain = dryrun.run_cell("qwen3-moe-30b-a3b", shape, False, verbose=False, mesh=mesh, cfg=cfg)
        got = dryrun.run_cell("qwen3-moe-30b-a3b", shape, False, verbose=False, mesh=mesh, cfg=cfg,
                              by_op=10**6)
    for key in ("flops", "bytes", "coll_bytes", "peak_memory_bytes", "state_bytes"):
        assert got[key] == plain[key], key
    assert "flops_by_op" not in plain
    assert sum(o["flops"] for o in got["flops_by_op"]) == pytest.approx(got["flops"], rel=1e-12)
    assert sum(o["bytes"] for o in got["live_at_peak"]) == got["peak_memory_bytes"]
    ops = [o["op"] for o in got["flops_by_op"]]
    assert ops[0].startswith("kernel flash_attention @ models/layers.py:"), ops[:3]
    assert any(o.startswith("bmm @ models/moe.py:") for o in ops), ops
    made = [g["made_by"] for g in got["live_at_peak"]]
    assert any(m.startswith("state (") for m in made) and (
        any(m.startswith("scratch of _softmax_backward_data") for m in made) == (shape == "train_4k")), made
    with pytest.raises(ValueError):
        cost.CostMode().by_op_report()


def _shape(rec, name):
    return rec["inputs"][name]["shape"], rec["inputs"][name]["dtype"]


def test_production_prefill_records_each_local_call():
    """mamba2-370m x prefill_32k on the 16x16 mesh: the batch of 32 split
    over `data` (2 rows a device) and the 32 SSD heads over `model` (2 a
    device); each distinct call once, with its count, the counts adding up
    to ``kernel_calls``."""
    res = dryrun.run_cell("mamba2-370m", "prefill_32k", False, verbose=False)
    recs = res["kernel_call_shapes"]
    by = {(r["kernel"], tuple(_shape(r, "x")[0])): r for r in recs}
    assert len(by) == len(recs) == 3
    assert by["rmsnorm", (2, 32768, 1024)]["count"] == 49  # ln1 a layer and the final norm
    assert by["rmsnorm", (2, 32768, 2048)]["count"] == 48  # the gated norm over d_inner
    ssd = by["ssd_scan", (2, 32768, 2, 64)]
    assert ssd["count"] == 48 and ssd["chunk"] == 128 and ssd["out_dtype"] == "float32"
    assert _shape(ssd, "x") == ([2, 32768, 2, 64], "bfloat16") and _shape(ssd, "A") == ([2], "float32")
    assert _shape(ssd, "B") == _shape(ssd, "C") == ([2, 32768, 128], "bfloat16")
    assert _shape(ssd, "dt") == ([2, 32768, 2], "float32") and "init_state" not in ssd["inputs"]
    for name, n in res["kernel_calls"].items():
        assert sum(r["count"] for r in recs if r["kernel"] == name) == n


def test_cost_mode_records_flash_masks_and_positions():
    """A decode cell and a prefill cell of reduced deepseek-7b on a fake
    (4, 2) mesh: the flash call's local heads (4 of 4 query heads split
    over `model` to 2, KV heads 2 to 1), its batch rows, its mask and
    whether one q_pos row serves the batch."""
    cfg = reduced_config("deepseek-7b", **KW)
    cells = {"decode": dataclasses.replace(SHAPES["decode_32k"], global_batch=8, seq_len=64),
             "prefill": dataclasses.replace(SHAPES["prefill_32k"], global_batch=8, seq_len=64)}
    with FakeGroup(8):
        mesh = make_debug_mesh(8, model=2)
        got = {}
        for kind, cell in cells.items():
            model = Model(cfg, device="meta")
            dryrun.set_opts(model, cell, mesh)
            got[kind] = dryrun.measure(model, cell, mesh)["mode"].call_records()
    for kind, Sq in (("decode", 1), ("prefill", 64)):
        flash = [r for r in got[kind] if r["kernel"] == "flash_attention"]
        assert len(flash) == 1 and flash[0]["count"] == cfg.n_layers
        f = flash[0]
        assert _shape(f, "q") == ([2, Sq, 2, 64], "bfloat16")
        assert _shape(f, "k") == _shape(f, "v") == ([2, 64, 1, 64], "bfloat16")
        assert _shape(f, "q_pos") == ([Sq], "int32") and _shape(f, "kv_pos") == ([64], "int32")
        assert f["causal"] is True and f["window"] is None and f["q_pos_shared"] is True
        norms = [r for r in got[kind] if r["kernel"] == "rmsnorm"]
        assert [(_shape(r, "x")[0], r["count"]) for r in norms] == [([2, Sq, 64], 2 * cfg.n_layers + 1)]


def test_distinct_calls_merges_the_cells_tables():
    """``distinct_calls``: a call two cells make is one entry naming both,
    its counts summed; a failed cell adds nothing; a flash call carries its
    cell's decode position, so one shape at two depths is two entries."""
    norm = {"kernel": "rmsnorm", "eps": 1e-6, "inputs": {
        "x": {"shape": [8, 1, 64], "dtype": "bfloat16"}, "scale": {"shape": [64], "dtype": "float32"}}}
    other = {**norm, "inputs": {**norm["inputs"], "x": {"shape": [8, 1, 32], "dtype": "bfloat16"}}}
    flash = {"kernel": "flash_attention", "causal": True, "window": None, "q_pos_shared": True,
             "inputs": {"q": {"shape": [8, 1, 2, 64], "dtype": "bfloat16"}}}
    results = [
        {"arch": "a", "shape": "decode_32k", "kernel_call_shapes": [{**norm, "count": 3},
                                                                   {**flash, "count": 2}]},
        {"arch": "b", "shape": "decode_32k", "kernel_call_shapes": [
            {**norm, "count": 5}, {**other, "count": 1}, {**flash, "count": 4}]},
        {"arch": "b", "shape": "long_500k", "kernel_call_shapes": [{**flash, "count": 1}]},
        {"arch": "c", "shape": "train_4k", "ok": False, "error": "x"},
    ]
    got = dryrun.distinct_calls(results)
    last_32k, last_500k = SHAPES["decode_32k"].seq_len - 1, SHAPES["long_500k"].seq_len - 1
    assert got == [
        {**flash, "decode_pos": last_32k, "cells": ["a x decode_32k", "b x decode_32k"], "count": 6},
        {**flash, "decode_pos": last_500k, "cells": ["b x long_500k"], "count": 1},
        {**norm, "cells": ["a x decode_32k", "b x decode_32k"], "count": 8},
        {**other, "cells": ["b x decode_32k"], "count": 1},
    ]
    prefill = dryrun.distinct_calls([{"arch": "a", "shape": "prefill_32k",
                                      "kernel_call_shapes": [{**flash, "count": 1}]}])
    assert prefill[0]["decode_pos"] is None


def test_ring_positions_hold_the_latest_position_of_each_slot():
    """Before the ring wraps, a slot past ``pos`` holds a negative position
    (not yet written); after, slot j holds the latest position <= pos that
    is j modulo W."""
    assert dryrun.ring_positions(4, 1).tolist() == [0, 1, -2, -1]
    assert dryrun.ring_positions(4, 9).tolist() == [8, 9, 6, 7]
    assert dryrun.ring_positions(4, 3).tolist() == [0, 1, 2, 3]


# Reduced jamba-1.5-large-398b x train_4k under sp on the fake (4, 2) mesh,
# counted while the gated norm gathered y * silu(z) whole over `model`
# (before mamba._gate_and_project_rows): (peak bytes, FLOPs)
JAMBA_SP_WHOLE_ROWS = (38589130240, 6877052141568)
# the same, counted while the Mamba block gathered its input whole on the
# sequence for in_proj and the conv (before mamba._rows_mix)
JAMBA_SP_WHOLE_INPUT = (38454945280, 6875173093376)
# Reduced deepseek-7b x train_4k on the same mesh, with and without sp: a
# cell with no Mamba block, which the gated norm's placement leaves alone
DEEPSEEK_TRAIN = {("sp",): (34951463424, 5661068886016), (): (35018572288, 5661370875904)}


def _reduced_train_run(arch, opts, rules=contextlib.nullcontext):
    """``run_cell`` of reduced ``arch`` x train_4k on the fake (4, 2) mesh,
    under the DTensor ``rules`` (a context manager)."""
    with FakeGroup(8), rules():
        mesh = make_debug_mesh(8, model=2)
        res = dryrun.run_cell(arch, "train_4k", False, verbose=False, mesh=mesh,
                              cfg=reduced_config(arch, **KW), opts=opts)
    assert res["ok"] and not dist.is_initialized()
    return res


def _reduced_train_cell(arch, opts):
    res = _reduced_train_run(arch, opts)
    return res["peak_memory_bytes"], res["flops"]


@pytest.fixture(scope="module")
def jamba_sp_run():
    return _reduced_train_run("jamba-1.5-large-398b", ("sp",))


@pytest.fixture(scope="module")
def jamba_sp(jamba_sp_run):
    return jamba_sp_run["peak_memory_bytes"], jamba_sp_run["flops"]


def test_sp_gated_rows_lower_the_hybrid_train_peak(jamba_sp):
    peak, flops = jamba_sp
    before_peak, before_flops = JAMBA_SP_WHOLE_ROWS
    assert peak < before_peak, (peak, before_peak)
    assert abs(flops - before_flops) <= 0.01 * before_flops, (flops, before_flops)


def test_sp_mamba_rows_lower_the_hybrid_train_peak(jamba_sp):
    peak, flops = jamba_sp
    before_peak, before_flops = JAMBA_SP_WHOLE_INPUT
    assert peak < before_peak, (peak, before_peak)
    assert abs(flops - before_flops) <= 0.01 * before_flops, (flops, before_flops)


@pytest.mark.parametrize("opts", list(DEEPSEEK_TRAIN))
def test_cell_without_mamba_counts_as_before(opts):
    assert _reduced_train_cell("deepseek-7b", opts) == DEEPSEEK_TRAIN[opts]


# Under torch 2.11's rules (rules_of_2_11: the sp residual never viewed with
# (B, S) flattened, the gate of dtensor_util.AT_LEAST_2_13 off), reduced
# jamba-1.5-large-398b (attention on split KV heads, gated MLP, MoE, Mamba)
# and granite-34b (one KV head, which `model` does not split, and the plain
# GeLU MLP) x train_4k under sp: each on the fake (4, 2) mesh, with the most
# residual-shaped [B, S, D] tensors that ``unsplit`` gathered alive at once
RULES_OF_2_11 = ("jamba-1.5-large-398b", "granite-34b")


@contextlib.contextmanager
def _gathered_rows(shape, seen):
    """While open, ``seen["most"]``: the most storages of local ``shape``
    made by ``dtensor_util.unsplit`` (wherever it was imported) alive at
    once."""
    run = dtensor_util.unsplit
    seen.update(alive=0, most=0, made=0)

    def freed():
        seen["alive"] -= 1

    def spy(t, dim):
        out = run(t, dim)
        if out is not t and tuple(out.to_local().shape) == shape:
            seen["made"] += 1
            seen["alive"] += 1
            seen["most"] = max(seen["most"], seen["alive"])
            weakref.finalize(out.to_local().untyped_storage(), freed)
        return out

    users = [m for m in sys.modules.values()
             if getattr(m, "__name__", "").startswith("repro_torch") and getattr(m, "unsplit", None) is run]
    for m in users:
        m.unsplit = spy
    try:
        yield
    finally:
        for m in users:
            m.unsplit = run


@pytest.fixture(scope="module")
def rules_of_2_11_runs(jamba_sp_run):
    runs = {}
    for arch in RULES_OF_2_11:
        cfg = reduced_config(arch, **KW)
        B, S = SHAPES["train_4k"].global_batch // 4, SHAPES["train_4k"].seq_len
        seen = {}
        with _gathered_rows((B, S, cfg.d_model), seen):
            below = _reduced_train_run(arch, ("sp",), rules_of_2_11)
        on = jamba_sp_run if arch == "jamba-1.5-large-398b" else _reduced_train_run(arch, ("sp",))
        runs[arch] = {"on": on, "below": below, "gathered": dict(seen)}
    return runs


@pytest.mark.parametrize("arch", RULES_OF_2_11)
def test_rules_of_2_11_count_as_2_13(rules_of_2_11_runs, arch):
    """The FLOPs and the distinct kernel calls equal the 2.13 path's
    exactly, and so does the peak, but for the one allocator block of the
    tensor of the fake mesh that DTensor makes once a process for its
    decomposition rules (``_get_fake_mesh``), counted by whichever run of
    the process makes it first.  The collective bytes are within 1 % once
    the embedding lookup's all-gathers on 2.13 are set aside: 2.13's
    DTensor gathers a table this small (16 KB a rank) whole, and then the
    tokens and the lookup's gradient, where at the configs' widths it
    splits the table on its width with all-to-alls, as the port's lookup
    does below 2.13 (``layers._lookup_on_ranks``); ``CostMode`` counts no
    all-to-all of DTensor's (PERF.md, PR 29)."""
    on, below = rules_of_2_11_runs[arch]["on"], rules_of_2_11_runs[arch]["below"]
    assert abs(below["peak_memory_bytes"] - on["peak_memory_bytes"]) <= cost.BLOCK, (
        below["peak_memory_bytes"], on["peak_memory_bytes"])
    assert below["flops"] == on["flops"]
    assert below["kernel_call_shapes"] == on["kernel_call_shapes"]
    cfg, cell = reduced_config(arch, **KW), SHAPES["train_4k"]
    B, S, D, V = cell.global_batch, cell.seq_len, cfg.d_model, cfg.padded_vocab
    lookup = (B // 4) * S * D * 2 + B * S * 4 + V * D * 2  # gradient, tokens, table
    want = on["coll_bytes"] - lookup
    assert abs(below["coll_bytes"] - want) <= 0.01 * want, (
        below["coll_breakdown"], on["coll_breakdown"])


@pytest.mark.parametrize("arch", RULES_OF_2_11)
def test_rules_of_2_11_hold_no_gathered_residual(rules_of_2_11_runs, arch):
    """Under 2.11's rules a product on the sequence rows gathers its input
    inside and again in its backward (``dtensor_util.product_on_rows``):
    no residual-shaped tensor gathered by ``unsplit`` outlives the next,
    where the sublayers' gathered inputs were saved for the backward
    (ROADMAP C9)."""
    gathered = rules_of_2_11_runs[arch]["gathered"]
    assert gathered["made"] > 0 and gathered["most"] == 1, gathered
