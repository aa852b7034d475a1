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

The reduced configs run at head_dim 64 and in bf16: on the meta device
the wrappers check what the card's kernels take, and 16 is not a head
dim they are built for.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from _torch_parallel_worker import FakeGroup  # noqa: E402
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
