"""Multi-rank runs of the port on the CPU over gloo, against the
single-process port (which the other tests hold to JAX) and against the
JAX package.  The ranks run in subprocesses (tests/_torch_parallel_worker.py),
so no process group outlives a test.

* On a (data 2, model 2) mesh, reduced deepseek-7b (``sp``), mamba2-370m
  (``mamba_heads``) and qwen3-moe-30b-a3b (``moe_ep``, and ``moe_a2a``):
  prefill logits, loss and every grad leaf of the sharded run equal the
  single-process port's within 1e-5 of each tensor's largest magnitude
  (fp32; the sums run in another order).  Under ``moe_a2a`` the aux loss
  is, as in the reference, each data shard's own (capacity and load of
  its tokens): with distinct rows per shard only the logits and the
  cross-entropy are held; with the batch's two shards the same rows, the
  loss and grads too.
* Prefill and decode with the cache placed by the rules (split on its
  batch, or a sliding-window ring split on its slots) equal the single
  process's within 1e-5.
* Each kernel wrapper on DTensors (every placement the kernels take)
  equals the wrapper on whole tensors exactly; the placements they must
  refuse raise.
* The expert-parallel MoE on 8 ranks (data 4, model 2) against JAX's
  ``apply_moe_shard_map`` on 8 host devices: the output within 1e-4 (the
  tolerance of tests/test_moe_shard_map.py), aux the mean of the data
  shards' own, grads finite.
* A train state saved from 4 ranks and restored by ``elastic_restore``
  onto 2 (``plan_elastic_mesh``) comes back exactly.
* ``HeartbeatMonitor``, ``plan_elastic_mesh``, ``StragglerDetector`` and
  ``FaultInjector`` answer as the JAX package's do.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parallel_worker import (  # noqa: E402
    DECODE, PARITY, FakeGroup, decode_inputs, elastic_state, parity_inputs, serve,
)
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import distribute_tensor  # noqa: E402
from repro.train import fault_tolerance as JFT  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.train import fault_tolerance as TFT  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5


def _env():
    path = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])
    return {**os.environ, "PYTHONPATH": path, "JAX_PLATFORMS": "cpu"}


def _run(args, timeout=300):
    proc = subprocess.run([sys.executable, *map(str, args)], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


def _worker(cases, world, out):
    _run([ROOT / "tests" / "_torch_parallel_worker.py", cases, world, out])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("gloo")
    _worker("parity,wrappers,decode,elastic_save", 4, out)
    _worker("elastic_restore", 2, out)
    return out


def _close(got, want, what):
    want = np.asarray(want, dtype=np.float64)
    err = np.abs(np.asarray(got, dtype=np.float64) - want).max()
    assert err <= TOL * max(np.abs(want).max(), 1e-30), (what, err, np.abs(want).max())


@pytest.mark.parametrize("case", list(PARITY))
def test_sharded_run_equals_single_process(runs, case):
    arch, flags, overrides = PARITY[case]
    got = np.load(runs / f"{case.replace('/', '__')}.npz")
    cfg, params, distinct, twice = parity_inputs(arch, overrides)
    model = Model(cfg, device="cpu")
    for tag, batch in (("distinct", distinct), ("twice", twice)):
        logits, _ = model.prefill(params, {"tokens": batch["tokens"]})
        loss, metrics, grads = loss_and_grads(model, params, batch)
        want = {"logits": logits, "xent": metrics["xent"], "loss": loss,
                **{f"grad/{k}": g for k, g in leaves_with_paths(grads)}}
        per_shard_aux = "moe_a2a" in flags and tag == "distinct"
        for k, v in want.items():
            if per_shard_aux and k not in ("logits", "xent"):
                continue
            _close(got[f"{tag}/{k}"], v.detach().numpy(), f"{case} {tag} {k}")
        assert len(want) == 3 + len(leaves_with_paths(params))
        # under mamba_heads every scan (prefill, loss, remat) takes its heads split
        # over `model`, its batch over `data`; else nothing splits the heads
        scans = set(got[f"{tag}/scan_x"].tolist())
        if cfg.family == "ssm":
            split = "(Shard(dim=0), Shard(dim=2))" if "mamba_heads" in flags \
                else "(Shard(dim=0), Replicate())"
            assert len(got[f"{tag}/scan_x"]) == 3 * cfg.n_layers and scans == {split}, scans
        else:
            assert not scans, scans


@pytest.mark.parametrize("case", list(DECODE))
def test_sharded_serving_equals_single_process(runs, case):
    """Prefill and greedy decode steps with the cache placed by the rules:
    split on its batch over `data` (deepseek-7b, 2 rows), or, one row,
    a sliding-window ring split on its slots over `data` and on its KV
    heads over `model` (h2o-danube-3-4b: a 64-token prompt over a 32-slot
    ring, then steps across it).  Each step's logits within 1e-5 of the
    single process's."""
    arch, batch, prompt, steps = DECODE[case]
    got = np.load(runs / f"decode_{case.replace('/', '__')}.npz")
    cfg, params, toks = decode_inputs(arch, batch, prompt)
    model = Model(cfg, device="cpu")
    want = serve(model, params, model.init_cache(batch, prompt + steps), toks, steps)
    assert len(want) == steps + 1
    for i, w in enumerate(want):
        _close(got[f"arr_{i}"], w.detach().numpy(), f"{case} step {i}")
    split = {"deepseek-7b/batch": "(Shard(dim=1), Shard(dim=3))",  # [n, B, W, G, K]
             "h2o-danube-3-4b/slots": "(Shard(dim=2), Shard(dim=3))"}[case]
    assert str(got["placements"]) == split


def test_kernel_wrappers_on_dtensors(runs):
    got = np.load(runs / "wrappers.npz")
    names = sorted(k[:-len("/got")] for k in got.files if k.endswith("/got"))
    assert len(names) == 3 + 4 + 4  # rmsnorm, flash, ssd (y and state) cases
    for name in names:
        np.testing.assert_array_equal(got[f"{name}/got"], got[f"{name}/want"], err_msg=name)
    raised = (runs / "wrappers_raised.txt").read_text().split("\n")
    assert raised == ["rmsnorm D split", "rmsnorm partial", "flash head dim split",
                      "ssd state split"]


def test_elastic_restore_onto_fewer_ranks(runs):
    """Saved from (data 2, model 2), restored onto (data 1, model 2): every
    leaf equal to the state that was placed, and placed by the rules of
    the new mesh (model splits kept, nothing split over data)."""
    want = dict(leaves_with_paths(elastic_state(reduced_config("deepseek-7b"))))
    got = np.load(runs / "restored.npz")
    assert set(got.files) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    meta, *placed = (runs / "restored_meta.txt").read_text().splitlines()
    assert meta == "{'step': 7, 'world': 4}"
    wq = next(line for line in placed if line.startswith("params/blocks/sub0/attn/wq "))
    assert "(Replicate(), Shard(dim=2))" in wq and wq.endswith("(2, 64, 2, 16)")


JAX_EP = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import reduced_config
    from repro.models import moe as X
    from repro.parallel import opt_flags
    from repro.launch.mesh import make_debug_mesh

    cfg = reduced_config("qwen3-moe-30b-a3b", capacity_factor=8.0)
    mesh = make_debug_mesh(8, model=2)
    p = X.init_moe(jax.random.PRNGKey(0), cfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 32, cfg.d_model), jnp.float32)
    opt_flags.set_flags(moe_a2a=True, mesh=mesh, batch_axes="data")
    with mesh:
        y, aux = jax.jit(lambda p, x: X.apply_moe(p, cfg, x))(p, x)
    opt_flags.reset()
    shard_aux = [float(X.apply_moe(p, cfg, x[i:i + 1])[1]) for i in range(4)]
    # where each device of a (pod 2, data 2, model 2) mesh starts its shard
    # of an (8,) array split over (pod, data)
    m3 = Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("pod", "data", "model"))
    starts = NamedSharding(m3, P(("pod", "data"))).devices_indices_map((8,))
    order = [starts[d][0].start or 0 for d in m3.devices.reshape(-1)]
    np.savez(sys.argv[1], x=np.asarray(x), y=np.asarray(y), aux=float(aux),
             shard_aux=np.asarray(shard_aux), order=np.asarray(order),
             **{f"p/{k}": np.asarray(v) for k, v in p.items()})
    """
)


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory):
    out = tmp_path_factory.mktemp("ep")
    _run(["-c", JAX_EP, out / "jax_ep.npz"])
    return out


def test_expert_parallel_moe_matches_jax(jax_ep):
    _worker("ep_vs_jax", 8, jax_ep)
    jx, port = np.load(jax_ep / "jax_ep.npz"), np.load(jax_ep / "port_ep.npz")
    np.testing.assert_allclose(port["y"], jx["y"], atol=1e-4, rtol=0)
    # the reference returns one data shard's aux (out_specs P()); the port,
    # the mean of the shards' own
    assert np.abs(jx["shard_aux"] - float(jx["aux"])).min() <= 1e-5 * float(jx["aux"])
    np.testing.assert_allclose(float(port["aux"]), jx["shard_aux"].mean(), rtol=1e-5)
    grads = [k for k in port.files if k.startswith("grad/")]
    assert len(grads) == 4 and all(np.isfinite(port[k]).all() for k in grads)


def test_multi_axis_batch_split_is_pod_major(jax_ep):
    """A dim over (pod, data): the port's local shard on each rank of a
    (2, 2, 2) mesh starts where JAX's device at that mesh position starts."""
    order = np.load(jax_ep / "jax_ep.npz")["order"]
    for rank in range(8):
        with FakeGroup(8, rank):
            mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
            t = distribute_tensor(torch.arange(8), mesh, sh.to_placements((("pod", "data"),), mesh),
                                  src_data_rank=None)
            assert int(t.to_local()[0]) == order[rank], (rank, mesh.get_coordinate())


def test_fault_tolerance_matches_jax():
    jm, tm = JFT.HeartbeatMonitor(timeout=5.0), TFT.HeartbeatMonitor(timeout=5.0)
    rng = np.random.default_rng(0)
    for host, t in zip(rng.integers(0, 6, 40), np.cumsum(rng.uniform(0, 2, 40))):
        jm.beat(int(host), float(t))
        tm.beat(int(host), float(t))
    for now in (10.0, 30.0, 45.0, 60.0):
        assert tm.failed(now) == jm.failed(now) and tm.healthy(now) == jm.healthy(now)

    js, ts = JFT.StragglerDetector(), TFT.StragglerDetector()
    for host, t in zip(rng.integers(0, 6, 60), rng.uniform(0.5, 3.0, 60)):
        js.record(int(host), float(t))
        ts.record(int(host), float(t))
    assert ts.stragglers() == js.stragglers()

    for n, m in ((256, 16), (250, 16), (16, 16), (7, 2)):
        assert TFT.plan_elastic_mesh(n, m) == JFT.plan_elastic_mesh(n, m)
    for mod in (JFT, TFT):
        with pytest.raises(ValueError):
            mod.plan_elastic_mesh(8, 16)

    events = [(3, 1, "crash"), (3, 2, "straggle"), (7, 0, "crash")]
    ji = JFT.FaultInjector([JFT.FailureEvent(*e) for e in events])
    ti = TFT.FaultInjector([TFT.FailureEvent(*e) for e in events])
    for step in range(10):
        assert [vars(e) for e in ti.at(step)] == [vars(e) for e in ji.at(step)]
