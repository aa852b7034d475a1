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


def test_only_ported_archs_registered():
    assert tcfg.list_archs() == ["deepseek-7b", "mamba2-370m"]
    with pytest.raises(KeyError, match="unknown arch"):
        tcfg.get_config("qwen3-32b")
