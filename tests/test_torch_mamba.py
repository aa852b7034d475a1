"""The port's Mamba2 layers and SSM model against the JAX package, on reduced
mamba2-370m in float32 (same numpy inputs, JAX-initialised weights).

Where the reference is at fault (ROADMAP.md, C1: its conv cache for a
prompt shorter than ssm_conv - 1 tokens), the port is held against what
the reference's own causal conv and recurrence define: the zero-padded
window, and the JAX model's decode_step run token by token.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models import mamba as TM  # noqa: E402
from repro_torch.models.model import param_spec  # noqa: E402

CFG = reduced_config("mamba2-370m")
TOL = 1e-4  # float32; sums run in another order (chunked scan, conv)
CH = CFG.d_inner + 2 * CFG.ssm_state
K1 = CFG.ssm_conv - 1


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def layer():
    return JM.init_mamba(jax.random.PRNGKey(0), CFG)


@pytest.fixture(scope="module")
def models():
    jm = JModel(CFG)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, TModel(CFG, device="cpu"), params_from_jax(jax.tree.map(np.asarray, jp), CFG)


def test_reduced_config_sizes():
    assert (CFG.n_layers, CFG.d_model, CFG.d_inner) == (2, 64, 128)
    assert (CFG.ssm_heads, CFG.ssm_head_dim, CFG.ssm_state, CFG.ssm_chunk) == (8, 16, 16, 16)
    assert CFG.dtype == "float32"


def test_causal_conv_matches():
    rng = np.random.default_rng(0)
    xbc = rng.normal(size=(2, 7, CH)).astype(np.float32)
    w = rng.normal(size=(CFG.ssm_conv, CH)).astype(np.float32)
    b = rng.normal(size=(CH,)).astype(np.float32)
    want = JM._causal_conv(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b))
    _close(TM._causal_conv(*map(torch.tensor, (xbc, w, b))), want)


def test_split_proj_matches():
    width = 2 * CFG.d_inner + 2 * CFG.ssm_state + CFG.ssm_heads
    proj = np.random.default_rng(1).normal(size=(2, 3, width)).astype(np.float32)
    for a, b in zip(TM._split_proj(CFG, torch.tensor(proj)), JM._split_proj(CFG, jnp.asarray(proj))):
        _close(a, b, 0)


def _zero_padded_window(p, x):
    """The last k-1 rows of the pre-conv xBC after the causal conv's own
    left padding with k-1 zeros: the conv window the recurrence needs."""
    pre = jnp.einsum("bsd,de->bse", x, p["in_proj"])
    _, xbc_pre, _ = JM._split_proj(CFG, pre)
    return jnp.pad(xbc_pre, ((0, 0), (K1, 0), (0, 0)))[:, -K1:]


@pytest.mark.parametrize("S", [1, 2, 3, 5, 12, 37])
def test_apply_mamba_output_and_cache(layer, S):
    x = np.random.default_rng(S).normal(size=(2, S, CFG.d_model)).astype(np.float32)
    out_j, cache_j = JM.apply_mamba(layer, CFG, jnp.asarray(x), return_cache=True)
    cache_t = TM.init_mamba_cache(CFG, 2, torch.float32, "cpu")
    cache_t["conv"].fill_(7.0)  # stale contents must not survive the prefill
    out_t = TM.apply_mamba(_t(layer), CFG, torch.tensor(x), cache_t)
    _close(out_t, out_j)
    _close(cache_t["ssm"], cache_j["ssm"])
    _close(cache_t["conv"], _zero_padded_window(layer, jnp.asarray(x)))
    if S >= K1:  # where the reference's cache is right, it is the port's
        _close(cache_t["conv"], cache_j["conv"])


def test_apply_mamba_decode_matches(layer):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 1, CFG.d_model)).astype(np.float32)
    conv = rng.normal(size=(3, K1, CH)).astype(np.float32)
    ssm = rng.normal(size=(3, CFG.ssm_heads, CFG.ssm_state, CFG.ssm_head_dim)).astype(np.float32)
    out_j, cache_j = JM.apply_mamba_decode(
        layer, CFG, jnp.asarray(x), {"conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)}
    )
    cache_t = {"conv": torch.tensor(conv), "ssm": torch.tensor(ssm)}
    out_t = TM.apply_mamba_decode(_t(layer), CFG, torch.tensor(x), cache_t)
    _close(out_t, out_j)
    _close(cache_t["conv"], cache_j["conv"])
    _close(cache_t["ssm"], cache_j["ssm"])


def test_init_mamba_cache_layout():
    c = TM.init_mamba_cache(CFG, 3, torch.bfloat16, "cpu")
    j = JM.init_mamba_cache(CFG, 3, jnp.bfloat16)
    assert tuple(c["conv"].shape) == j["conv"].shape and c["conv"].dtype == torch.bfloat16
    assert tuple(c["ssm"].shape) == j["ssm"].shape and c["ssm"].dtype == torch.float32


def test_prefill_logits_match(models):
    jm, jp, tm, tp = models
    toks = np.random.default_rng(3).integers(0, CFG.vocab_size, (2, 21)).astype(np.int32)
    lj, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(2, 32, jnp.float32))
    lt, _ = tm.prefill(tp, {"tokens": torch.tensor(toks)}, tm.init_cache(2, 32, torch.float32))
    assert lt.shape == (2, 1, CFG.padded_vocab)
    _close(lt, lj)
    lt_nc, _ = tm.prefill(tp, {"tokens": torch.tensor(toks)})  # no cache
    _close(lt_nc, lj)


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_chain_matches(models, per_row):
    """Prefill 6 tokens, then 5 decode steps with a scalar or a [B] pos
    (an SSM row ignores its position; both forms must run)."""
    jm, jp, tm, tp = models
    toks = np.random.default_rng(4).integers(0, CFG.vocab_size, (2, 11)).astype(np.int32)
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
    for name in ("conv", "ssm"):
        _close(tc["sub0"][name], jc["sub0"][name])


@pytest.mark.parametrize("S", [1, 2, 3, 5])
def test_short_prefill_continues_the_recurrence(models, S):
    """Prefill of S tokens then 3 decode steps equals the JAX model's
    decode_step run token by token from a zero cache (C1: for S < 3 the
    JAX prefill's own cache would not)."""
    jm, jp, tm, tp = models
    toks = np.random.default_rng(10 + S).integers(0, CFG.vocab_size, (1, S + 3)).astype(np.int32)
    jc = jm.init_cache(1, 16, jnp.float32)
    want = []
    for t in range(S + 3):
        lj, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t : t + 1]), jnp.asarray(t, jnp.int32))
        want.append(lj)
    tc = tm.init_cache(1, 16, torch.float32)
    lt, tc = tm.prefill(tp, {"tokens": torch.tensor(toks[:, :S])}, tc)
    _close(lt, want[S - 1])
    for t in range(S, S + 3):
        lt, tc = tm.decode_step(tp, tc, torch.tensor(toks[:, t : t + 1]), t)
        _close(lt, want[t])


def test_init_follows_param_spec():
    tp = TModel(CFG, device="cpu").init(torch.Generator().manual_seed(0))
    jp = JModel(CFG).init(jax.random.PRNGKey(0))
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tp) == jax.tree.map(
        lambda a: (a.shape, str(a.dtype)), jp
    )
    m = tp["blocks"]["sub0"]["mamba"]
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert bool(((dt >= 1e-3 - 1e-6) & (dt <= 1e-1 + 1e-6)).all())
    a = torch.exp(m["A_log"])
    assert bool(((a >= 1.0 - 1e-5) & (a <= 16.0 + 1e-4)).all())
    assert not m["conv_b"].any() and bool((m["D"] == 1).all()) and bool((m["norm"] == 1).all())
    assert set(param_spec(CFG)["blocks"]["sub0"]) == {"ln1", "mamba"}
