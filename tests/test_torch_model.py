"""The port's Model against the JAX Model on reduced deepseek-7b, qwen3-32b
(qk-norm) and granite-34b (one KV head, the non-gated GeLU MLP), float32,
with the JAX-initialised weights passed through convert.params_from_jax."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models.model import param_spec  # noqa: E402

CFG = reduced_config("deepseek-7b")
ARCHS = ["deepseek-7b", "qwen3-32b", "granite-34b"]
TOL = 1e-4  # float32 logits after 2 blocks; sums run in another order


def _models(cfg):
    jm = JModel(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    return jm, jp, TModel(cfg, device="cpu"), tp


@pytest.fixture(scope="module")
def models():
    return _models(CFG)


@pytest.fixture(scope="module", params=ARCHS)
def arch_models(request):
    return _models(reduced_config(request.param))


def _close(a, b):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)


def test_prefill_logits_match(arch_models):
    jm, jp, tm, tp = arch_models
    cfg = tm.cfg
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    lj, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(2, 16, jnp.float32))
    lt, _ = tm.prefill(tp, {"tokens": torch.tensor(toks)}, tm.init_cache(2, 16, torch.float32))
    assert lt.shape == (2, 1, cfg.padded_vocab)
    _close(lt, lj)


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_chain_matches(arch_models, per_row):
    """Prefill 6 tokens, then 5 decode steps with a scalar pos, or a [B]
    pos whose rows sit at different depths."""
    jm, jp, tm, tp = arch_models
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
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
    """The dense draws in the spec's order: one fp32 normal per std leaf
    outside the blocks, one per block slice of a stacked leaf (so the
    fp32 scratch is one block's), and no draw for the fp32-ones norm
    scales."""
    tp = TModel(CFG, device="cpu").init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(0)

    def draw(shape, init):
        if init is None:
            return torch.ones(shape)
        if isinstance(init, float):
            return torch.randn(shape, generator=gen) * init
        assert init[0] == "by_slice", init
        return torch.stack([draw(shape[1:], init[1]) for _ in range(shape[0])])

    def replay(spec, got, in_blocks=False):
        for k, leaf in spec.items():
            if isinstance(leaf, dict):
                replay(leaf, got[k], in_blocks or k == "blocks")
                continue
            assert not (in_blocks and isinstance(leaf[1], float)), (k, leaf[1])
            torch.testing.assert_close(got[k], draw(*leaf), atol=0, rtol=0)

    replay(param_spec(CFG), tp)


def _draws(shape, init):
    """numel of each torch.randn draw of one leaf, in order."""
    if isinstance(init, float) or (isinstance(init, tuple) and init[0] == "normal_fp32"):
        return [int(np.prod(shape))]
    if isinstance(init, tuple) and init[0] == "by_slice":
        return _draws(shape[1:], init[1]) * shape[0]
    return []  # ones, zeros and the uniform draws (torch.rand)


def _leaf_draws(spec, inside_blocks=False):
    """(numel of each torch.randn draw the spec makes, in order, and the
    bound on it: a stacked block leaf's slice, else None)."""
    out = []
    for k, leaf in spec.items():
        if isinstance(leaf, dict):
            out += _leaf_draws(leaf, inside_blocks or k == "blocks")
            continue
        shape, init = leaf
        cap = int(np.prod(shape[1:])) if inside_blocks else None
        out += [(n, cap) for n in _draws(shape, init)]
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_init_draws_at_most_a_block_slice(arch, monkeypatch):
    """Every registered config's init on the meta device, with torch.randn
    spied on: no draw for a leaf under ``blocks`` exceeds one block's
    slice (the fp32 scratch of a draw is 4 bytes an element), and for the
    two dense giants no draw at all exceeds 1 G elements (4 GB in fp32)."""
    seen = []
    randn = torch.randn

    def spy(*size, **kw):
        t = randn(*size, **kw)
        seen.append(t.numel())
        return t

    monkeypatch.setattr(torch, "randn", spy)
    cfg = get_config(arch)
    TModel(cfg, device="meta").param_specs()
    want = _leaf_draws(param_spec(cfg))
    assert seen == [n for n, _ in want]
    for n, cap in want:
        assert cap is None or n <= cap, (arch, n, cap)
    if arch in ("granite-34b", "qwen3-32b"):
        assert max(seen) <= 1 << 30, (arch, max(seen))


def test_jamba_cut_counts_its_parameters_on_meta(monkeypatch):
    """chip_smoke.jamba_cut_config, the jamba-1.5-large-398b the card
    serves: every width of the registered config, n_layers 8 and
    moe_period 4 (MoE at positions 3 and 7), 27.03 G parameters on the
    meta device (54.05 GB in bf16), 38.65 GB of them the two MoE layers'
    experts; its largest draw in fp32 (``largest_draw_bytes``) is one MoE
    layer's [16, 8192, 24576] w_up, whose spy-counted draw it equals."""
    import importlib.util
    from pathlib import Path

    from repro_torch.models.model import n_params
    from repro_torch.tree import leaves_with_paths

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg, full = cs.jamba_cut_config(), get_config("jamba-1.5-large-398b")
    assert dataclasses.replace(full, n_layers=8, moe_period=4) == cfg
    assert [f for _, f in cfg.layer_kinds()].count("moe") == 2 and cfg.n_scan_blocks == 1
    seen = []
    randn = torch.randn

    def spy(*size, **kw):
        t = randn(*size, **kw)
        seen.append(t.numel())
        return t

    monkeypatch.setattr(torch, "randn", spy)
    params = TModel(cfg, device="meta").param_specs()
    assert n_params(params) == 27_025_004_544
    sizes = {k: t.numel() * t.element_size() for k, t in leaves_with_paths(params)}
    assert round(sum(sizes.values()) / 1e9, 2) == 54.05
    experts = sum(n for k, n in sizes.items() if "/moe/w_" in k)
    assert experts == 2 * 3 * 16 * 8192 * 24576 * 2  # 38.65 GB
    assert cs.largest_draw_bytes(cfg) == 4 * max(seen) == 4 * 16 * 8192 * 24576
