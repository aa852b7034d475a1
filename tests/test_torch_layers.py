"""The port's dense layers against the JAX package's, on reduced
deepseek-7b in float32 (same numpy inputs, JAX-initialised weights)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

CFG = reduced_config("deepseek-7b")
TOL = 1e-5


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=tol)


@pytest.mark.parametrize("per_row", [False, True])
def test_rope(per_row):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    pos = np.array([[3], [9]], np.int32) if per_row else np.arange(5, dtype=np.int32) + 7
    if per_row:
        x = x[:, :1]
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), CFG.rope_theta)
    _close(TL.rope(torch.tensor(x), torch.tensor(pos), CFG.rope_theta), want)


def _attn_setup(B=2, S=6, W=16, seed=0):
    params = JL.init_attention(jax.random.PRNGKey(seed), CFG)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, CFG.d_model)).astype(np.float32)
    jcache = JL.init_attn_cache(CFG, B, W, jnp.float32)
    tcache = TL.init_attn_cache(CFG, B, W, torch.float32, "cpu")
    return params, x, jcache, tcache


def _check_cache(tcache, jcache):
    for name in ("k", "v", "pos"):
        np.testing.assert_allclose(
            tcache[name].numpy(), np.asarray(jcache[name]), atol=TOL, rtol=TOL
        )


def test_apply_attention_prefill_writes_cache():
    params, x, jcache, tcache = _attn_setup()
    qpos = np.arange(x.shape[1], dtype=np.int32)
    out_j, jcache = JL.apply_attention(
        params, CFG, jnp.asarray(x), jnp.asarray(qpos), jcache,
        jnp.zeros((), jnp.int32), True,
    )
    out_t, tcache2 = TL.apply_attention(
        _t(params), CFG, torch.tensor(x), torch.tensor(qpos), tcache, 0, True
    )
    assert tcache2 is tcache  # updated in place
    _close(out_t, out_j)
    _check_cache(tcache, jcache)


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_attention_decode(per_row):
    """Prefill, then one decode step: a scalar position written with
    dynamic_update_slice semantics, or per-row slots [B]."""
    params, x, jcache, tcache = _attn_setup()
    tp = _t(params)
    S = x.shape[1]
    qpos = np.arange(S, dtype=np.int32)
    _, jcache = JL.apply_attention(
        params, CFG, jnp.asarray(x), jnp.asarray(qpos), jcache, jnp.zeros((), jnp.int32), True
    )
    TL.apply_attention(tp, CFG, torch.tensor(x), torch.tensor(qpos), tcache, 0, True)
    xd = np.random.default_rng(5).normal(size=(2, 1, CFG.d_model)).astype(np.float32)
    pos = np.array([S, S + 3], np.int32) if per_row else np.array(S, np.int32)
    qp = pos[:, None] if per_row else pos[None]
    out_j, jcache = JL.apply_attention(
        params, CFG, jnp.asarray(xd), jnp.asarray(qp), jcache, jnp.asarray(pos), False
    )
    out_t, _ = TL.apply_attention(
        tp, CFG, torch.tensor(xd), torch.tensor(qp), tcache, torch.tensor(pos), False
    )
    _close(out_t, out_j)
    _check_cache(tcache, jcache)


def test_apply_attention_dynamic_update_slice_clamps():
    """A scalar write past the end clamps its start so the update fits,
    as jax.lax.dynamic_update_slice does."""
    params, x, jcache, tcache = _attn_setup(S=4, W=8)
    qpos = np.arange(6, 10, dtype=np.int32)
    out_j, jcache = JL.apply_attention(
        params, CFG, jnp.asarray(x), jnp.asarray(qpos), jcache, jnp.asarray(6, jnp.int32), True
    )
    out_t, _ = TL.apply_attention(
        _t(params), CFG, torch.tensor(x), torch.tensor(qpos), tcache, torch.tensor(6), True
    )
    _close(out_t, out_j)
    _check_cache(tcache, jcache)


@pytest.mark.parametrize("gated", [True, False])
def test_apply_mlp(gated):
    cfg = dataclasses.replace(CFG, mlp_gated=gated)
    params = JL.init_mlp(jax.random.PRNGKey(1), cfg)
    x = np.random.default_rng(2).normal(size=(2, 3, cfg.d_model)).astype(np.float32)
    want = JL.apply_mlp(params, cfg, jnp.asarray(x))
    _close(TL.apply_mlp(_t(params), cfg, torch.tensor(x)), want)


@pytest.mark.parametrize("tied", [False, True])
def test_embed_and_unembed(tied):
    cfg = dataclasses.replace(CFG, tie_embeddings=tied)
    params = JL.init_embedding(jax.random.PRNGKey(3), cfg)
    toks = np.array([[1, 5, 255], [0, 7, 7]], np.int32)
    h_j = JL.embed_tokens(params, jnp.asarray(toks))
    h_t = TL.embed_tokens(_t(params), torch.tensor(toks))
    _close(h_t, h_j)
    _close(TL.unembed(_t(params), cfg, h_t), JL.unembed(params, cfg, h_j))


def test_rms_norm_layer():
    x = np.random.default_rng(4).normal(size=(2, 3, CFG.d_model)).astype(np.float32)
    s = np.linspace(0.5, 1.5, CFG.d_model, dtype=np.float32)
    _close(TL.rms_norm(torch.tensor(x), torch.tensor(s)), JL.rms_norm(jnp.asarray(x), jnp.asarray(s)))


def test_init_matches_jax_shapes_and_dtypes():
    gen = torch.Generator().manual_seed(0)
    for jfn, tfn in ((JL.init_attention, TL.init_attention), (JL.init_mlp, TL.init_mlp),
                     (JL.init_embedding, TL.init_embedding)):
        jp, tp = jfn(jax.random.PRNGKey(0), CFG), tfn(gen, CFG)
        assert set(jp) == set(tp)
        for k in jp:
            assert tuple(tp[k].shape) == jp[k].shape, k
            assert str(tp[k].dtype).replace("torch.", "") == str(jp[k].dtype), k
