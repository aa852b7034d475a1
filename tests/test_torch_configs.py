"""The port's config copy equals the JAX package's, field by field."""
import dataclasses

import pytest

pytest.importorskip("torch")

import repro.configs as jcfg  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402


_PROPS = ("padded_vocab", "attn_dim", "kv_dim", "n_scan_blocks",
          "d_inner", "ssm_heads", "ssm_groups")


def _same_config(arch, getter):
    a = getattr(jcfg, getter)(arch)
    b = getattr(tcfg, getter)(arch)
    fa = [f.name for f in dataclasses.fields(a)]
    assert fa == [f.name for f in dataclasses.fields(b)]
    for name in fa:
        assert getattr(a, name) == getattr(b, name), name
    for prop in _PROPS:
        assert getattr(a, prop) == getattr(b, prop), prop
    assert a.layer_kinds() == b.layer_kinds()
    return b


@pytest.mark.parametrize("getter", ["get_config", "reduced_config"])
def test_deepseek_7b_config_matches(getter):
    _same_config("deepseek-7b", getter)


@pytest.mark.parametrize("getter", ["get_config", "reduced_config"])
def test_mamba2_370m_config_matches(getter):
    cfg = _same_config("mamba2-370m", getter)
    if getter == "get_config":  # the published widths, unchanged
        assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads) == (48, 1024, 2048, 32)
        assert (cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv, cfg.ssm_chunk) == (64, 128, 4, 128)
        assert (cfg.vocab_size, cfg.padded_vocab, cfg.tie_embeddings) == (50280, 50432, True)


@pytest.mark.parametrize("getter", ["get_config", "reduced_config"])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"])
def test_moe_configs_match(arch, getter):
    cfg = _same_config(arch, getter)
    if getter == "get_config" and arch == "qwen3-moe-30b-a3b":  # the published widths
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (48, 2048, 32, 4, 128)
        assert (cfg.d_ff, cfg.n_experts, cfg.top_k, cfg.capacity_factor) == (768, 128, 8, 1.25)
        assert (cfg.vocab_size, cfg.padded_vocab, cfg.qk_norm, cfg.rope_theta) == (151936, 152064, True, 1e6)
    elif getter == "get_config":
        assert (cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.n_experts, cfg.top_k) == (16, 16, 1408, 64, 6)
        assert (cfg.qk_norm, cfg.capacity_factor) == (False, 1.25)


@pytest.mark.parametrize("getter", ["get_config", "reduced_config"])
@pytest.mark.parametrize("arch", jcfg.list_archs())
def test_every_config_matches(arch, getter):
    """All ten configs of the JAX package, field for field."""
    _same_config(arch, getter)


@pytest.mark.parametrize("getter", ["get_config", "reduced_config"])
def test_new_family_configs_keep_their_widths(getter):
    """The vlm, audio, hybrid and sliding-window configs and their reduced
    forms: the widths the port's new paths run at."""
    llava, hubert, jamba, h2o = (_same_config(a, getter) for a in (
        "llava-next-mistral-7b", "hubert-xlarge", "jamba-1.5-large-398b", "h2o-danube-3-4b"))
    if getter == "get_config":
        assert (llava.family, llava.frontend_dim, llava.vlm_img_tokens, llava.head_dim) == ("vlm", 1024, 1152, 128)
        assert (hubert.family, hubert.causal, hubert.head_dim, hubert.frontend_dim) == ("audio", False, 80, 512)
        assert (hubert.mlp_gated, hubert.vocab_size, hubert.padded_vocab) == (False, 504, 512)
        assert (jamba.family, jamba.attn_period, jamba.moe_period, jamba.n_scan_blocks) == ("hybrid", 8, 2, 9)
        assert (h2o.sliding_window, h2o.head_dim, h2o.n_heads, h2o.n_kv_heads) == (4096, 120, 32, 8)
    else:
        assert (llava.frontend_dim, llava.vlm_img_tokens, hubert.frontend_dim) == (32, 8, 32)
        assert (jamba.n_layers, jamba.n_scan_blocks, h2o.sliding_window) == (16, 2, 32)
    assert [m for m, _ in jamba.layer_kinds()] == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    assert [f for _, f in jamba.layer_kinds()] == ["dense", "moe"] * 4


def test_only_ported_archs_registered():
    """Every family is ported: the port registers the JAX package's ten
    configs, and nothing else."""
    assert tcfg.list_archs() == jcfg.list_archs() == [
        "deepseek-7b", "granite-34b", "h2o-danube-3-4b", "hubert-xlarge",
        "jamba-1.5-large-398b", "llava-next-mistral-7b", "mamba2-370m",
        "moonshot-v1-16b-a3b", "qwen3-32b", "qwen3-moe-30b-a3b",
    ]
    with pytest.raises(KeyError, match="unknown arch"):
        tcfg.get_config("llama-2-7b")
