"""The port's MoE layer and MoE models against the JAX package, on reduced
qwen3-moe-30b-a3b and moonshot-v1-16b-a3b in float32 (same numpy inputs,
JAX-initialised weights): capacity, routing (experts, slots and the set
of dropped pairs exactly), the layer's output and aux loss, prefill and
decode logits, the serving engine's tokens, and Model.loss with every
grad leaf."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import moe as JX  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.train.data import make_batch as j_make_batch  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models import moe as TX  # noqa: E402
from repro_torch.models.model import param_spec  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402

ARCHS = ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"]
TOL = 1e-4  # float32 logits after 2 blocks; sums run in another order
PROMPTS = [[5, 6, 7], [9, 10, 11, 2, 5, 3, 8], [7], [1, 2, 3, 4]]  # test_serve_batched


def _cfgs(arch, **kw):
    return j_reduced_config(arch, **kw), reduced_config(arch, **kw)


def _layer(jcfg):
    jp = JX.init_moe(jax.random.PRNGKey(0), jcfg)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _jax_routing(p, cfg, xt):
    """The reference's routing, step for step as ``repro/models/moe.py``
    computes it inside ``apply_moe`` (:57-79): top_i, slot and keep."""
    T, E, K = xt.shape[0], cfg.n_experts, cfg.top_k
    C = JX.moe_capacity(cfg, T)
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xt.astype(jnp.float32), p["router"]), axis=-1)
    _, top_i = jax.lax.top_k(probs, K)
    onehot = jax.nn.one_hot(top_i.reshape(T * K), E, dtype=jnp.int32)
    pos_in_e = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
    keep = pos_in_e < C
    return np.asarray(top_i), np.asarray(jnp.where(keep, pos_in_e, C)), np.asarray(keep)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jcfg, cfg = _cfgs(request.param)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, jm, jp, cfg, TModel(cfg, device="cpu"), params_from_jax(jax.tree.map(np.asarray, jp), cfg)


def test_reduced_configs_are_small_moe():
    for arch in ARCHS:
        cfg = reduced_config(arch)
        assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.top_k) == ("moe", 2, 64, 4, 2)
        assert cfg.dtype == "float32" and cfg.capacity_factor == 1.25


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 2.0])
def test_capacity_matches_jax(arch, capacity_factor):
    """Every T from 1 to 600, full-width and reduced: round half to even,
    up to a multiple of 8, at least 8."""
    for jget, get in ((j_get_config, get_config), (j_reduced_config, reduced_config)):
        jcfg = dataclasses.replace(jget(arch), capacity_factor=capacity_factor)
        cfg = dataclasses.replace(get(arch), capacity_factor=capacity_factor)
        assert [TX.moe_capacity(cfg, t) for t in range(1, 601)] == [
            JX.moe_capacity(jcfg, t) for t in range(1, 601)
        ]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor,T,experts", [
    (1.25, 1, None), (1.25, 4, None), (1.25, 37, None), (1.25, 128, None),  # decode to prefill
    (0.5, 37, None), (0.5, 128, None),  # pairs drop
    (1.25, 4, "full"), (1.25, 200, "full"),  # the full configs' experts and top-k
])
def test_apply_moe_matches_jax(arch, capacity_factor, T, experts):
    """Routing exactly (experts, slots, the dropped set), y within 1e-5,
    aux within 1e-6 relative.  "full": the reduced widths with the full
    config's n_experts and top_k (128 and 8, or 64 and 6)."""
    kw = {}
    if experts:
        full = get_config(arch)
        kw = dict(n_experts=full.n_experts, top_k=full.top_k)
    jcfg, cfg = _cfgs(arch, capacity_factor=capacity_factor, **kw)
    jp, tp = _layer(jcfg)
    B = 2 if T % 2 == 0 else 1
    x = np.random.default_rng(T).normal(size=(B, T // B, cfg.d_model)).astype(np.float32)
    yj, auxj = JX.apply_moe(jp, jcfg, jnp.asarray(x))
    yt, auxt = TX.apply_moe(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(auxt.item(), float(auxj), rtol=1e-6)
    assert auxt.dtype == torch.float32

    top_i, slot, keep = _jax_routing(jp, jcfg, jnp.asarray(x.reshape(T, -1)))
    r = TX.route(tp["router"], cfg, torch.from_numpy(x.reshape(T, -1)))
    np.testing.assert_array_equal(r.top_i.numpy(), top_i)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.load.numpy(), np.bincount(top_i.ravel(), minlength=cfg.n_experts))
    assert r.capacity == JX.moe_capacity(jcfg, T)
    np.testing.assert_allclose(r.top_p.sum(-1).numpy(), 1.0, rtol=1e-6)
    if capacity_factor < 1:
        assert (~r.keep).sum() > 0, "no pair dropped: the drop path went untested"


def test_prefill_logits_match(models):
    jcfg, jm, jp, cfg, tm, tp = models
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    lj, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(2, 16, jnp.float32))
    lt, _ = tm.prefill(tp, {"tokens": torch.tensor(toks)}, tm.init_cache(2, 16, torch.float32))
    assert lt.shape == (2, 1, cfg.padded_vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_chain_matches(models, per_row):
    """Prefill 6 tokens, then 5 decode steps with a scalar pos, or a [B]
    pos whose rows sit at different depths."""
    jcfg, jm, jp, cfg, tm, tp = models
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jc = jm.init_cache(2, 16, jnp.float32)
    tc = tm.init_cache(2, 16, torch.float32)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :6])}, jc)
    _, tc = tm.prefill(tp, {"tokens": torch.tensor(toks[:, :6])}, tc)
    for i in range(5):
        pos = np.array([6 + i, 8 + i], np.int32) if per_row else np.array(6 + i, np.int32)
        tok = toks[:, 6 + i : 7 + i]
        lj, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        lt, tc = tm.decode_step(tp, tc, torch.tensor(tok), torch.tensor(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_tokens_match_jax_engine(models, temperature):
    """The engines' batched decode routes idle rows too, in both packages;
    greedy and sampled tokens agree (both sample from
    np.random.default_rng(seed))."""
    jcfg, _, jp, cfg, _, tp = models
    reqs = [(i, list(p), 6, temperature) for i, p in enumerate(PROMPTS)]
    jout = JEngine(jcfg, jp, max_len=64, seed=3, batch_size=2).generate([JRequest(*r) for r in reqs])
    tout = ServeEngine(cfg, tp, max_len=64, seed=3, batch_size=2, device="cpu").generate(
        [Request(*r) for r in reqs]
    )
    assert tout == jout


def test_loss_and_grads_match_jax(models):
    """Model.loss with its 0.01 aux term: loss within 1e-5 relative, aux
    within 1e-6 relative (and not 0), each grad leaf within 1e-4 of its
    largest element."""
    jcfg, jm, jp, cfg, tm, tp = models
    b = j_make_batch(jcfg, 4, 24, step=0, seed=0)
    (lj, mj), gj = jax.value_and_grad(jm.loss, has_aux=True)(jp, {k: jnp.asarray(v) for k, v in b.items()})
    lt, mt, gt = tts.loss_and_grads(tm, tp, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    np.testing.assert_allclose(mt["aux"].item(), float(mj["aux"]), rtol=1e-6)
    np.testing.assert_allclose(mt["xent"].item(), float(mj["xent"]), rtol=1e-5)
    assert mt["aux"].item() > 1.0  # about 1 a block for balanced routing
    want = dict(leaves_with_paths(jax.tree.map(np.asarray, gj)))
    got = dict(leaves_with_paths(gt))
    assert set(got) == set(want)
    for key, g in got.items():
        ref = want[key]
        assert g.shape == ref.shape and g.dtype == torch.float32, key
        err = np.abs(g.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (key, err, np.abs(ref).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_matches_jax_tree_in_bfloat16(arch):
    """Shapes and dtypes of every leaf equal the JAX init's in a bf16
    config: the router stays fp32, the experts are bf16; params_from_jax
    keeps them so and rejects a router cast to bf16."""
    jcfg, cfg = _cfgs(arch, dtype="bfloat16")
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    meta = TModel(cfg, device="cpu").param_specs()
    for (key, t), (_, m) in zip(leaves_with_paths(tp), leaves_with_paths(meta)):
        assert (t.shape, t.dtype) == (m.shape, m.dtype), key
    moe = tp["blocks"]["sub0"]["moe"]
    assert moe["router"].dtype == torch.float32 and moe["w_up"].dtype == torch.bfloat16
    assert moe["w_up"].shape == (2, 4, 64, 128) and moe["w_down"].shape == (2, 4, 128, 64)
    tree = jax.tree.map(np.asarray, jp)
    tree["blocks"]["sub0"]["moe"]["router"] = np.asarray(
        jp["blocks"]["sub0"]["moe"]["router"].astype(jnp.bfloat16))
    with pytest.raises(ValueError, match="router: dtype"):
        params_from_jax(tree, cfg)


def test_expert_init_draws_one_slice_at_a_time():
    """The stacked expert leaves are drawn a leading (block) slice at a
    time, each in fp32 then cast; the router in fp32 in a bf16 config."""
    cfg = dataclasses.replace(reduced_config("qwen3-moe-30b-a3b"), dtype="bfloat16")
    spec = param_spec(cfg)
    tp = TModel(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(0)

    def replay(spec, got):
        for k, leaf in spec.items():
            if isinstance(leaf, dict):
                replay(leaf, got[k])
                continue
            shape, init = leaf
            if init is None:
                want = torch.ones(shape)
            elif isinstance(init, float):
                want = (torch.randn(shape, generator=gen) * init).bfloat16()
            elif init[0] == "normal_fp32":
                want = torch.randn(shape, generator=gen) * init[1]
            else:
                assert init[0] == "normal_by_slice"
                want = torch.stack([(torch.randn(shape[1:], generator=gen) * init[1]).bfloat16()
                                    for _ in range(shape[0])])
            torch.testing.assert_close(got[k], want, atol=0, rtol=0)

    replay(spec, tp)
    assert tp["blocks"]["sub0"]["moe"]["router"].dtype == torch.float32
