"""The port's sharding rules (repro_torch/parallel/sharding.py) against the
JAX package's (repro/parallel/sharding.py): the same specs for every
param leaf of all ten full configs, every cache leaf and every batch leaf,
on both production mesh shapes (JAX on an AbstractMesh, the port on a
stand-in of the same extents), and, placed on a fake process group of as
many ranks, every local shard of the shape JAX's spec gives, none uneven.
Exact comparisons throughout: no tolerance applies."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import applicable_shapes as j_applicable_shapes  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from _torch_parallel_worker import FakeGroup  # noqa: E402
from repro_torch.configs import SHAPES, applicable_shapes, get_config, list_archs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402

ARCHS = list_archs()
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), types.SimpleNamespace(mesh_dim_names=axes, shape=shape)


def _jax_specs(tree, shardings):
    """{path: (spec tuple, shape)} of a JAX tree and its NamedShardings."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    shs = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    out = {}
    for (path, leaf), s in zip(flat, shs):
        key = "/".join(str(p.key) if hasattr(p, "key") else str(p) for p in path)
        out[key] = (tuple(s.spec), tuple(leaf.shape), s)
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_shards_match_jax(arch, mesh_name):
    """Every param leaf: the port's spec is JAX's; placed on a fake group of
    the mesh's ranks, its local shard has the shape of JAX's shard, and
    every split dim divides evenly."""
    amesh, stand_in = _meshes(mesh_name)
    jcfg, cfg = j_get_config(arch), get_config(arch)
    jtree = JModel(jcfg).param_specs()
    want = _jax_specs(jtree, jsh.param_shardings(jcfg, jtree, amesh))
    meta = Model(cfg, device="meta").param_specs()
    got = {k: sh._param_spec(tuple(k.split("/")), t, cfg, stand_in)
           for k, t in leaves_with_paths(meta)}
    assert set(got) == set(want)
    for k, (spec, _, _) in want.items():
        assert got[k] == spec, (k, got[k], spec)

    shape, _ = MESHES[mesh_name]
    with FakeGroup(int(np.prod(shape))):
        mesh = make_production_mesh(multi_pod=len(shape) == 3)
        placed = sh.distribute(meta, sh.param_shardings(cfg, meta, mesh), mesh)
        for k, t in leaves_with_paths(placed):
            spec, gshape, jsharding = want[k]
            assert tuple(t.to_local().shape) == tuple(jsharding.shard_shape(gshape)), k
            for p in t.placements:
                if isinstance(p, Shard):
                    n = np.prod([mesh.size(i) for i, q in enumerate(t.placements) if q == p])
                    assert gshape[p.dim] % n == 0, (k, gshape, t.placements)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_jax(arch, mesh_name):
    """Every cache leaf of every serving cell, and every batch leaf of
    every cell, has the reference's spec."""
    amesh, stand_in = _meshes(mesh_name)
    jcfg, cfg = j_get_config(arch), get_config(arch)
    assert applicable_shapes(cfg) == j_applicable_shapes(jcfg)
    for shape in applicable_shapes(cfg):
        cell = SHAPES[shape]
        assert cell == type(cell)(**vars(J_SHAPES[shape]))
        if cell.kind != "train":
            jcache = jax.eval_shape(lambda: JModel(jcfg).init_cache(
                cell.global_batch, cell.seq_len, dtype=jnp.bfloat16))
            want = _jax_specs(jcache, jsh.cache_shardings(jcfg, jcache, amesh))
            cache = Model(cfg, device="meta").init_cache(cell.global_batch, cell.seq_len)
            got = {k: sh.cache_spec(tuple(k.split("/")), t, stand_in)
                   for k, t in leaves_with_paths(cache)}
            assert got == {k: v[0] for k, v in want.items()}, shape
        batch = dryrun.input_specs(cfg, cell)
        jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.int32) for k, v in batch.items()}
        want = _jax_specs(jbatch, jsh.batch_shardings(jcfg, jbatch, amesh))
        for k, t in batch.items():
            assert sh.batch_spec(stand_in, tuple(t.shape)) == want[k][0], (shape, k)


def test_batch_axes_and_maybe_match_jax():
    """``batch_axes`` and ``maybe`` on both production meshes and a debug
    mesh, for dims that divide every extent, some or none."""
    for shape, axes in [*MESHES.values(), ((4, 2), ("data", "model"))]:
        amesh = AbstractMesh(shape, axes)
        stand_in = types.SimpleNamespace(mesh_dim_names=axes, shape=shape)
        for dim in (1, 2, 3, 8, 16, 24, 32, 48, 256, 512, 1000, 1024):
            assert sh.batch_axes(stand_in, dim) == jsh.batch_axes(amesh, dim), (shape, dim)
            for names in (("model",), ("data",), ("pod", "data"), ("pod", "data", "model")):
                assert sh.maybe(stand_in, dim, *names) == jsh.maybe(amesh, dim, *names)
    stand_in = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"), shape=(2, 16, 16))
    assert sh.batch_axes(stand_in, 256) == ("pod", "data")
    assert sh.batch_axes(stand_in, 16) == "data"
    assert sh.batch_axes(stand_in, 1) is None
    assert sh.maybe(stand_in, 24, "model") is None


def test_to_placements():
    """A spec's placements: a dim over (pod, data) is split on both mesh
    dims; an axis out of the mesh's order, or used twice, raises."""
    m = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"), shape=(2, 16, 16))
    assert sh.to_placements((("pod", "data"), None, "model"), m) == (Shard(0), Shard(0), Shard(2))
    assert sh.to_placements((None, None), m) == (Replicate(),) * 3
    assert sh.replicated(m) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        sh.to_placements((("data", "pod"),), m)
    with pytest.raises(ValueError):
        sh.to_placements(("model", "model"), m)
