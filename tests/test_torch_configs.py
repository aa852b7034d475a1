"""The port's config copy equals the JAX package's, field by field."""
import dataclasses

import pytest

pytest.importorskip("torch")

import repro.configs as jcfg  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402


@pytest.mark.parametrize("getter", ["get_config", "reduced_config"])
def test_deepseek_7b_config_matches(getter):
    a = getattr(jcfg, getter)("deepseek-7b")
    b = getattr(tcfg, getter)("deepseek-7b")
    fa = [f.name for f in dataclasses.fields(a)]
    assert fa == [f.name for f in dataclasses.fields(b)]
    for name in fa:
        assert getattr(a, name) == getattr(b, name), name
    for prop in ("padded_vocab", "attn_dim", "kv_dim", "n_scan_blocks"):
        assert getattr(a, prop) == getattr(b, prop), prop
    assert a.layer_kinds() == b.layer_kinds()


def test_only_ported_archs_registered():
    assert tcfg.list_archs() == ["deepseek-7b"]
    with pytest.raises(KeyError, match="unknown arch"):
        tcfg.get_config("mamba2-370m")
