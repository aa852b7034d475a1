"""The port's Model against the JAX Model on reduced deepseek-7b, float32,
with the JAX-initialised weights passed through convert.params_from_jax."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models.model import param_spec  # noqa: E402

CFG = reduced_config("deepseek-7b")
TOL = 1e-4  # float32 logits after 2 blocks; sums run in another order


@pytest.fixture(scope="module")
def models():
    jm = JModel(CFG)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), CFG)
    return jm, jp, TModel(CFG, device="cpu"), tp


def _close(a, b):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)


def test_prefill_logits_match(models):
    jm, jp, tm, tp = models
    toks = np.random.default_rng(0).integers(0, CFG.vocab_size, (2, 9)).astype(np.int32)
    lj, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(2, 16, jnp.float32))
    lt, _ = tm.prefill(tp, {"tokens": torch.tensor(toks)}, tm.init_cache(2, 16, torch.float32))
    assert lt.shape == (2, 1, CFG.padded_vocab)
    _close(lt, lj)


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_chain_matches(models, per_row):
    """Prefill 6 tokens, then 5 decode steps with a scalar pos, or a [B]
    pos whose rows sit at different depths."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(1)
    toks = rng.integers(0, CFG.vocab_size, (2, 12)).astype(np.int32)
    jc = jm.init_cache(2, 16, jnp.float32)
    tc = tm.init_cache(2, 16, torch.float32)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :6])}, jc)
    _, tc = tm.prefill(tp, {"tokens": torch.tensor(toks[:, :6])}, tc)
    for i in range(5):
        pos = np.array([6 + i, 8 + i], np.int32) if per_row else np.array(6 + i, np.int32)
        tok = toks[:, 6 + i : 7 + i]
        lj, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        lt, tc = tm.decode_step(tp, tc, torch.tensor(tok), torch.tensor(pos))
        _close(lt, lj)
    for name in ("k", "v", "pos"):
        np.testing.assert_allclose(
            tc["sub0"][name].numpy(), np.asarray(jc["sub0"][name]), atol=TOL, rtol=TOL
        )


def test_convert_checks_the_tree(models):
    _, jp, _, _ = models
    tree = jax.tree.map(np.asarray, jp)
    del tree["final_norm"]
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(tree, CFG)
    tree = jax.tree.map(np.asarray, jp)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tree, dataclasses.replace(CFG, d_ff=64))


def test_convert_copies_and_keeps_bfloat16():
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    jp = JModel(cfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(tree, cfg)
    w = tp["embed"]["tokens"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.float().numpy(), np.asarray(jp["embed"]["tokens"], np.float32))
    w.zero_()  # writable, and not aliasing the numpy source
    assert np.asarray(tree["embed"]["tokens"], np.float32).any()


def test_init_follows_param_spec():
    tm = TModel(CFG, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    jp = JModel(CFG).init(jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda a: a.shape, jp)
    assert jax.tree.map(lambda t: tuple(t.shape), tp) == shapes


def test_entry_points_refuse_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TModel(CFG)


def test_dense_init_draws_in_spec_order():
    """The spec's leaf kinds (added for Mamba) leave the dense draws as
    they were: one fp32 normal per std leaf, in the spec's order, and no
    draw for the fp32-ones norm scales."""
    tp = TModel(CFG, device="cpu").init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(0)

    def replay(spec, got):
        for k, leaf in spec.items():
            if isinstance(leaf, dict):
                replay(leaf, got[k])
                continue
            shape, std = leaf
            want = torch.ones(shape) if std is None else torch.randn(shape, generator=gen) * std
            torch.testing.assert_close(got[k], want, atol=0, rtol=0)

    replay(param_spec(CFG), tp)
