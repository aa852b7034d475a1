"""The port's copy of the synthetic data pipeline against the JAX
package's: the same batches bit for bit, and the loader's cursor."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.train.data import DataLoader as JLoader  # noqa: E402
from repro.train.data import make_batch as j_make_batch  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.train.data import DataLoader, make_batch  # noqa: E402

# the port registers deepseek-7b and mamba2-370m; the other families'
# batches are drawn from a port ArchConfig with the JAX config's fields
ARCHS = ["deepseek-7b", "mamba2-370m", "hubert-xlarge", "llava-next-mistral-7b"]


def _cfgs(arch):
    j = j_reduced_config(arch)
    return j, ArchConfig(**dataclasses.asdict(j))


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("step,seed,shard,n_shards", [(0, 0, 0, 1), (7, 1, 0, 1), (3, 5, 1, 2)])
def test_make_batch_bit_equal(arch, step, seed, shard, n_shards):
    j, t = _cfgs(arch)
    _same(make_batch(t, 4, 32, step, seed, shard, n_shards),
          j_make_batch(j, 4, 32, step, seed, shard, n_shards))


def test_labels_are_shifted_tokens_and_shards_split():
    _, t = _cfgs("deepseek-7b")
    b = make_batch(t, 2, 16, step=0, seed=0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert make_batch(t, 8, 16, 0, 0, shard=1, n_shards=2)["tokens"].shape == (4, 16)
    with pytest.raises(ValueError, match="shards"):
        make_batch(t, 7, 16, 0, 0, shard=0, n_shards=2)


def test_loader_matches_jax_loader():
    j, t = _cfgs("mamba2-370m")
    jl, tl = JLoader(j, 2, 16, seed=4), DataLoader(t, 2, 16, seed=4)
    for _ in range(4):
        _same(tl.next(), jl.next())
    assert tl.state() == jl.state() == {"step": 4, "seed": 4}


def test_loader_cursor_roundtrip():
    _, t = _cfgs("deepseek-7b")
    l1 = DataLoader(t, 2, 16, seed=3)
    for _ in range(5):
        l1.next()
    saved = l1.state()
    want = l1.next()
    l2 = DataLoader(t, 2, 16, seed=0)
    l2.restore(saved)
    _same(l2.next(), want)
