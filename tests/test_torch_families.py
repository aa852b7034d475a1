"""The vlm, audio, hybrid and sliding-window families of the port against
the JAX package, on the reduced configs in float32 (same numpy inputs,
JAX-initialised weights passed through convert.params_from_jax), and the
plain flash path at the new head dims 80 and 120.

Tolerances: logits and hidden states within 1e-4 (float32 after two
blocks, sums in another order); losses within 1e-5 relative; each grad
leaf within 1e-4 of its largest element; engine tokens exactly; caches
within 1e-4; attention within 2e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import list_archs as j_list_archs  # noqa: E402
from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.train.data import make_batch as j_make_batch  # noqa: E402
from repro_torch.configs import get_config, list_archs, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models.model import n_params  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402

TOL = 1e-4
VLM, AUDIO, HYBRID, SWA = (
    "llava-next-mistral-7b", "hubert-xlarge", "jamba-1.5-large-398b", "h2o-danube-3-4b")


class _Jitted:
    """A JAX Model whose prefill, decode_step and loss gradient run under
    jax.jit (the same functions, compiled once instead of dispatched op
    by op)."""

    def __init__(self, model):
        self.model = model
        self.prefill = jax.jit(model.prefill)
        self.decode_step = jax.jit(model.decode_step)
        self.loss_and_grads = jax.jit(jax.value_and_grad(model.loss, has_aux=True))

    def __getattr__(self, name):
        return getattr(self.model, name)


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(jcfg, JAX model, JAX params, cfg, port model, port params) of the
    reduced config of ``arch``."""
    jcfg, cfg = j_reduced_config(arch), reduced_config(arch)
    jm = _Jitted(JModel(jcfg))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    return jcfg, jm, jp, cfg, TModel(cfg, device="cpu"), tp


@pytest.fixture(params=[VLM, AUDIO, HYBRID, SWA])
def models(request):
    return _models(request.param)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=tol, rtol=tol)


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _same_caches(tc, jc):
    got, want = dict(leaves_with_paths(tc)), dict(leaves_with_paths(jax.tree.map(np.asarray, jc)))
    assert set(got) == set(want)
    for key, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[key], atol=TOL, rtol=TOL, err_msg=key)


# --------------------------------------------------------------------------
# every config
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", j_list_archs())
def test_every_config_builds_on_meta_as_the_jax_tree(arch):
    """All ten full-width configs: the port's params on the meta device
    have the JAX init's keys, shapes and dtypes (an eval_shape of it), and
    so its parameter count."""
    assert list_archs() == j_list_archs()
    jtree = JModel(j_get_config(arch)).param_specs()
    want = dict(leaves_with_paths(jax.tree.map(lambda a: (a.shape, str(a.dtype)), jtree,
                                               is_leaf=lambda a: hasattr(a, "shape"))))
    meta = TModel(get_config(arch), device="cpu").param_specs()
    got = {k: (tuple(t.shape), str(t.dtype).replace("torch.", "")) for k, t in leaves_with_paths(meta)}
    assert got == {k: (tuple(s), d) for k, (s, d) in want.items()}
    assert all(t.device.type == "meta" for _, t in leaves_with_paths(meta))
    assert n_params(meta) == sum(int(np.prod(s)) for s, _ in want.values())


# --------------------------------------------------------------------------
# losses (vlm with its image prefix, audio with masked frames, hybrid with
# the MoE aux term, sliding window) and every grad leaf
# --------------------------------------------------------------------------


def test_loss_and_grads_match_jax(models):
    """Model.loss on make_batch's family batch: loss, xent and aux within
    1e-5 relative; every grad leaf within 1e-4 of its largest element."""
    jcfg, jm, jp, cfg, tm, tp = models
    b = j_make_batch(jcfg, 2, 40 if cfg.family == "vlm" else 24, step=0, seed=0)
    if cfg.family == "audio":
        assert (b["labels"] == -1).any() and (b["labels"] >= 0).any()
    (lj, mj), gj = jm.loss_and_grads(jp, _j(b))
    lt, mt, gt = tts.loss_and_grads(tm, tp, _t(b))
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    np.testing.assert_allclose(mt["xent"].item(), float(mj["xent"]), rtol=1e-5)
    np.testing.assert_allclose(mt["aux"].item(), float(mj["aux"]), rtol=1e-5, atol=1e-7)
    assert mt["n_tokens"].item() == float(mj["n_tokens"])
    if cfg.family == "hybrid":
        assert mt["aux"].item() > 1.0  # about 1 a MoE layer for balanced routing
    want = dict(leaves_with_paths(jax.tree.map(np.asarray, gj)))
    got = dict(leaves_with_paths(gt))
    assert set(got) == set(want)
    for key, g in got.items():
        ref = want[key]
        assert g.shape == ref.shape and g.dtype == torch.float32, key
        err = np.abs(g.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (key, err, np.abs(ref).max())
        if cfg.family == "vlm" and key.startswith("projector"):
            assert np.abs(ref).max() > 0, key  # the image rows reach the loss
    assert tm.unread_by_loss == ({"embed/tokens"} if cfg.family == "audio" else set())
    for key in tm.unread_by_loss:
        assert not got[key].any() and not want[key].any(), key


def test_loss_and_grads_raise_on_a_leaf_the_model_does_not_name():
    """Only the leaves a model names in unread_by_loss get zero grads: a
    leaf cut from the loss by mistake (here the final norm) still raises."""
    jcfg, _, _, _, tm, tp = _models(AUDIO)
    b = _t(j_make_batch(jcfg, 2, 24, step=0, seed=0))

    class Cut(TModel):
        def loss(self, params, batch):
            return super().loss({**params, "final_norm": params["final_norm"].detach()}, batch)

    cut = Cut(tm.cfg, device="cpu")
    with pytest.raises(RuntimeError, match="not have been used"):
        tts.loss_and_grads(cut, tp, b)


def test_vlm_loss_drops_the_image_rows():
    """The image rows carry no label: the loss counts the text labels
    only, and labels of the image length would not fit."""
    jcfg, cfg = j_reduced_config(VLM), reduced_config(VLM)
    jp = JModel(jcfg).init(jax.random.PRNGKey(1))
    tm = TModel(cfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    b = _t(j_make_batch(jcfg, 2, 40, step=1))
    assert b["patch_embeds"].shape[1] == cfg.vlm_img_tokens and b["tokens"].shape[1] == 32
    _, m = tm.loss(tp, b)
    assert m["n_tokens"].item() == 2 * 32
    with pytest.raises(RuntimeError):
        tm.loss(tp, {**b, "labels": torch.zeros(2, 40, dtype=torch.int32)})


# --------------------------------------------------------------------------
# prefill and decode
# --------------------------------------------------------------------------


def test_vlm_prefill_with_image_and_decode_chain():
    """Prefill of 8 image rows and 10 text tokens into the cache, then 5
    decode steps of text: logits and caches."""
    jcfg, jm, jp, cfg, tm, tp = _models(VLM)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 15)).astype(np.int32)
    pe = rng.normal(size=(2, cfg.vlm_img_tokens, cfg.frontend_dim)).astype(np.float32)
    batch = {"tokens": toks[:, :10], "patch_embeds": pe}
    jc, tc = jm.init_cache(2, 32, jnp.float32), tm.init_cache(2, 32, torch.float32)
    lj, jc = jm.prefill(jp, _j(batch), jc)
    lt, tc = tm.prefill(tp, _t(batch), tc)
    assert lt.shape == (2, 1, cfg.padded_vocab)
    _close(lt, lj)
    S = cfg.vlm_img_tokens + 10
    for i in range(5):
        tok = toks[:, 10 + i : 11 + i]
        lj, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(S + i, jnp.int32))
        lt, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), torch.tensor(S + i))
        _close(lt, lj)
    _same_caches(tc, jc)


def test_vlm_prefill_of_text_alone():
    """A vlm batch without patch embeddings is text only, as in the JAX
    package."""
    jcfg, jm, jp, cfg, tm, tp = _models(VLM)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    lj, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    lt, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    _close(lt, lj)


@pytest.mark.parametrize("with_cache", [False, True])
def test_audio_prefill_on_frames(with_cache):
    """Non-causal prefill over frames: the last frame's logits, the cache,
    and the backbone's output at every frame (where a causal mask would
    differ)."""
    jcfg, jm, jp, cfg, tm, tp = _models(AUDIO)
    assert cfg.causal is False
    frames = np.random.default_rng(5).normal(size=(2, 20, cfg.frontend_dim)).astype(np.float32)
    jc = jm.init_cache(2, 32, jnp.float32) if with_cache else None
    tc = tm.init_cache(2, 32, torch.float32) if with_cache else None
    lj, jc = jm.prefill(jp, {"frames": jnp.asarray(frames)}, jc)
    lt, tc = tm.prefill(tp, {"frames": torch.from_numpy(frames)}, tc)
    _close(lt, lj)
    if with_cache:
        _same_caches(tc, jc)
    hj, _ = jm._embed_inputs(jp, {"frames": jnp.asarray(frames)})
    ht, n_prefix = tm._embed_inputs(tp, {"frames": torch.from_numpy(frames)})
    assert n_prefix == 0
    _close(ht, hj)
    pos = np.arange(20, dtype=np.int32)
    bj, _, _ = jm._backbone(jp, hj, jnp.asarray(pos))
    bt, _ = tm._backbone(tp, ht, torch.from_numpy(pos))
    _close(bt, bj)
    bc, _ = TModel(dataclasses.replace(cfg, causal=True), device="cpu")._backbone(
        tp, ht, torch.from_numpy(pos))
    assert (bc[:, :-1] - bt[:, :-1]).abs().max() > 1e-2  # the causal mask would differ


def test_hybrid_prefill_logits():
    jcfg, jm, jp, cfg, tm, tp = _models(HYBRID)
    assert [m for m, _ in cfg.layer_kinds()].count("attn") == 1 and cfg.n_scan_blocks == 2
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    lj, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(2, 32, jnp.float32))
    lt, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tm.init_cache(2, 32, torch.float32))
    _close(lt, lj)
    _same_caches(tc, jc)


@pytest.mark.parametrize("per_row", [False, True])
def test_hybrid_decode_chain(per_row):
    """Prefill 6 tokens, then 5 decode steps with a scalar pos, or a [B]
    pos whose rows sit at different depths."""
    jcfg, jm, jp, cfg, tm, tp = _models(HYBRID)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jc, tc = jm.init_cache(2, 16, jnp.float32), tm.init_cache(2, 16, torch.float32)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :6])}, jc)
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :6])}, tc)
    for i in range(5):
        pos = np.array([6 + i, 8 + i], np.int32) if per_row else np.array(6 + i, np.int32)
        tok = toks[:, 6 + i : 7 + i]
        lj, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        lt, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), torch.from_numpy(pos))
        _close(lt, lj)
    _same_caches(tc, jc)


def _jax_routes(records):
    """A stand-in for the reference's ``apply_moe`` that first sends the
    routing it computes (``repro/models/moe.py`` :57-79, step for step:
    top-k experts of the softmaxed router scores, and the (token, k) pairs
    within capacity) to ``records`` through an ordered debug callback, so
    that it runs under jit and scan."""
    from repro.models import moe as JX

    apply = JX.apply_moe

    def routed(p, cfg, x):
        T, E, K = x.shape[0] * x.shape[1], cfg.n_experts, cfg.top_k
        xt = x.reshape(T, -1)
        probs = jax.nn.softmax(jnp.einsum("td,de->te", xt.astype(jnp.float32), p["router"]), axis=-1)
        _, top_i = jax.lax.top_k(probs, K)
        onehot = jax.nn.one_hot(top_i.reshape(T * K), E, dtype=jnp.int32)
        pos_in_e = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
        keep = pos_in_e < JX.moe_capacity(cfg, T)  # [T*K], row-major as the port's
        jax.debug.callback(lambda i, k: records.append((np.asarray(i), np.asarray(k))),
                           top_i, keep, ordered=True)
        return apply(p, cfg, x)

    return routed


def test_hybrid_moe_every_4th_layer_matches_jax(monkeypatch):
    """Reduced jamba with MoE on every 4th layer (positions 3 and 7 of the
    super-block, the layout of chip_smoke.jamba_cut_config) at capacity
    factor 0.5: the prefill logits of 2 x 12 tokens and a chain of 4 decode
    steps at per-row positions within 1e-4 of JAX's, and every routing call
    (4 MoE layers a pass) the same experts and the same dropped pairs, some
    pairs dropped."""
    from repro.models import moe as JX
    from repro_torch.models import moe as TX

    kw = dict(moe_period=4, capacity_factor=0.5)
    jcfg, cfg = j_reduced_config(HYBRID, **kw), reduced_config(HYBRID, **kw)
    assert [f for _, f in cfg.layer_kinds()] == ["dense"] * 3 + ["moe"] + ["dense"] * 3 + ["moe"]
    jrec, trec = [], []
    monkeypatch.setattr(JX, "apply_moe", _jax_routes(jrec))
    route = TX.route

    def recorded(*args):
        r = route(*args)
        trec.append((r.top_i.numpy(), r.keep.numpy()))
        return r

    monkeypatch.setattr(TX, "route", recorded)
    jm = _Jitted(JModel(jcfg))
    jp = jm.init(jax.random.PRNGKey(0))
    tm, tp = TModel(cfg, device="cpu"), params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jc, tc = jm.init_cache(2, 32, jnp.float32), tm.init_cache(2, 32, torch.float32)
    lj, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :12])}, jc)
    lt, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :12])}, tc)
    _close(lt, lj)
    for i in range(4):
        pos = np.array([12 + i, 12 + i], np.int32)
        tok = toks[:, 12 + i : 13 + i]
        lj, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        lt, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), torch.from_numpy(pos))
        _close(lt, lj)
    jax.effects_barrier()
    assert len(trec) == len(jrec) == 5 * 4
    for (ti, tk), (ji, jk) in zip(trec, jrec):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tk, jk)
    assert sum(int((~k).sum()) for _, k in trec) > 0, "no pair dropped: the drop path went untested"


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_hybrid_engine_tokens_match_jax(temperature):
    """Greedy and sampled tokens of both engines, exactly.  Prompts of 3
    or more tokens: the reference's Mamba conv cache is wrong below 3
    (ROADMAP.md C1)."""
    jcfg, _, jp, cfg, _, tp = _models(HYBRID)
    prompts = [[5, 6, 7], [9, 10, 11, 2, 5, 3, 8], [7, 1, 4, 4], [1, 2, 3, 4, 5]]
    reqs = [(i, list(p), 6, temperature) for i, p in enumerate(prompts)]
    jout = JEngine(jcfg, jp, max_len=64, seed=3, batch_size=2).generate([JRequest(*r) for r in reqs])
    tout = ServeEngine(cfg, tp, max_len=64, seed=3, batch_size=2, device="cpu").generate(
        [Request(*r) for r in reqs])
    assert tout == jout


# --------------------------------------------------------------------------
# sliding window: the ring-buffer cache (window 32 in the reduced config)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("S", [20, 32, 64])
def test_swa_prefill_fills_the_ring(S):
    """Prefill shorter than the window (slots 0..S-1), of exactly W, and of
    2 W (the cache keeps the last W, slot == position % W): logits and the
    cache, with a 64-slot max_len cut to the 32-slot ring."""
    jcfg, jm, jp, cfg, tm, tp = _models(SWA)
    assert cfg.sliding_window == 32
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    jc, tc = jm.init_cache(2, 64, jnp.float32), tm.init_cache(2, 64, torch.float32)
    assert tc["sub0"]["k"].shape[2] == 32
    lj, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    lt, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    _close(lt, lj)
    _same_caches(tc, jc)
    pos = tc["sub0"]["pos"][0, 0]
    want = np.where(np.arange(32) < S, np.arange(32), -1) if S < 32 else np.arange(S - 32, S)
    np.testing.assert_array_equal(pos.numpy(), want)


@pytest.mark.parametrize("start,steps", [(20, 16), (64, 6)])
def test_swa_decode_across_the_wrap(start, steps):
    """Decode steps that wrap the ring: from position 20 over slot 31 to
    slots 0-3, and after a 2 W prefill over slots 0-5, whose old keys fall
    out of the window; logits at every step and the final cache."""
    jcfg, jm, jp, cfg, tm, tp = _models(SWA)
    toks = np.random.default_rng(start).integers(0, cfg.vocab_size, (2, start + steps)).astype(np.int32)
    jc, tc = jm.init_cache(2, 64, jnp.float32), tm.init_cache(2, 64, torch.float32)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :start])}, jc)
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :start])}, tc)
    for i in range(steps):
        p = start + i
        tok = toks[:, p : p + 1]
        lj, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(p, jnp.int32))
        lt, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), torch.tensor(p))
        _close(lt, lj)
    _same_caches(tc, jc)
    last = start + steps - 1
    assert int(tc["sub0"]["pos"][0, 0, last % 32]) == last


def test_swa_decode_matches_a_forward_over_the_whole_sequence():
    """Each decode step's logits after a 2 W prefill equal a cache-free
    forward over the whole sequence (the path Model.loss takes), where
    the window mask, not the ring, cuts the context."""
    jcfg, jm, jp, cfg, tm, tp = _models(SWA)
    S, steps = 64, 5
    toks = torch.from_numpy(
        np.random.default_rng(9).integers(0, cfg.vocab_size, (1, S + steps)).astype(np.int32))
    cache = tm.init_cache(1, 64, torch.float32)
    tm.prefill(tp, {"tokens": toks[:, :S]}, cache)
    dec = [tm.decode_step(tp, cache, toks[:, S + i : S + i + 1], torch.tensor(S + i))[0][0, 0]
           for i in range(steps)]
    h, _ = tm._embed_inputs(tp, {"tokens": toks})
    h, _ = tm._backbone(tp, h, torch.arange(S + steps, dtype=torch.int32))
    from repro_torch.models import layers as L

    full = L.unembed(tp["embed"], cfg, L.rms_norm(h, tp["final_norm"]))[0, S:]
    for i in range(steps):
        np.testing.assert_allclose(dec[i].numpy(), full[i].numpy(), atol=TOL, rtol=TOL)


def test_swa_prefill_past_the_window_needs_a_multiple_of_it():
    jcfg, jm, jp, cfg, tm, tp = _models(SWA)
    with pytest.raises(ValueError, match="multiple of W"):
        tm.prefill(tp, {"tokens": torch.zeros(1, 40, dtype=torch.int32)}, tm.init_cache(1, 64))


# --------------------------------------------------------------------------
# the plain flash path at head_dim 80 and 120
# --------------------------------------------------------------------------


@pytest.mark.parametrize("K", [80, 120])
@pytest.mark.parametrize("mask", ["causal", "non_causal", "window", "window_non_causal"])
def test_flash_head_dims_match_reference_and_pallas(K, mask):
    """The port's wrapper on CPU tensors (its plain version) against the
    JAX oracle (repro/kernels/ref.py) and the Pallas kernel in interpret
    mode, which takes both widths, at 128 queries over 256 keys, GQA."""
    causal, window = "non_causal" not in mask, 48 if "window" in mask else None
    rng = np.random.default_rng(K)
    q = rng.normal(size=(2, 128, 4, K)).astype(np.float32)
    k, v = (rng.normal(size=(2, 256, 2, K)).astype(np.float32) for _ in "kv")
    qpos, kpos = np.arange(128, 256, dtype=np.int32), np.arange(256, dtype=np.int32)
    kpos[200:210] = -1  # empty ring slots
    n = dict(ops.LAUNCHES)
    out = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v, qpos, kpos)), causal, window)
    assert ops.LAUNCHES == n and out.shape == q.shape
    args = [jnp.asarray(a) for a in (q, k, v, qpos, kpos)]
    _close(out, jref.flash_attention_ref(*args, causal=causal, window=window), 2e-5)
    _close(out, jops.flash_attention(*args, causal, window), 2e-5)


@pytest.mark.parametrize("K", [80, 120])
def test_flash_head_dims_per_row_decode_match_jax_attention(K):
    """Sq = 1 at per-row positions over a ring with a window (the Pallas
    kernel cannot take one query): against the JAX model's attention."""
    from repro.models import layers as JL

    rng = np.random.default_rng(K + 1)
    q = rng.normal(size=(3, 1, 8, K)).astype(np.float32)
    k, v = (rng.normal(size=(3, 64, 2, K)).astype(np.float32) for _ in "kv")
    slots = np.arange(64, dtype=np.int32)
    kpos = np.where(slots < 10, slots + 64, slots).astype(np.int32)  # wrapped: 64..73, then 10..63
    qpos = np.array([[73], [40], [5]], np.int32)
    out = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v, qpos, kpos)), True, 32)
    want = JL.multi_head_attention(*(jnp.asarray(a) for a in (q, k, v, qpos, kpos)), True, 32)
    _close(out, want, 2e-5)


def test_flash_head_dims_of_the_kernel():
    """The widths the CUDA kernels are built for: the cases of
    csrc/flash_mma.cuh's with_head_dim (the forward's and the backward's
    dispatch) are ops._HEAD_DIMS, and cover every head_dim of a registered
    config and of its reduced config."""
    import re
    from pathlib import Path

    csrc = Path(ops.__file__).parents[1] / "csrc"
    for name in ("flash_attention.cu", "flash_attention_bwd.cu"):
        assert '#include "flash_mma.cuh"' in (csrc / name).read_text()
    src = (csrc / "flash_mma.cuh").read_text()
    switch = re.search(r"int with_head_dim\(int K, F f\) \{(.*?)\n\}", src, re.S).group(1)
    cases = re.findall(r"case (\d+): return f\(std::integral_constant<int, (\d+)>", switch)
    assert cases and all(a == b for a, b in cases)
    assert tuple(int(a) for a, _ in cases) == ops._HEAD_DIMS == (16, 64, 80, 120, 128)
    assert {get_config(a).head_dim for a in list_archs()} <= set(ops._HEAD_DIMS)
    assert {reduced_config(a).head_dim for a in list_archs()} == {16}
