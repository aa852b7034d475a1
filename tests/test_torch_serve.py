"""The port's ServeEngine and calibrate against the JAX engine, on reduced
deepseek-7b in float32 with the JAX-initialised weights."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.latency import (  # noqa: E402
    H100_SERVE_MODEL,
    BatchLatencyModel,
    calibrate,
)

CFG = reduced_config("deepseek-7b")
PROMPTS = [[5, 6, 7], [9, 10, 11, 2, 5, 3, 8], [7], [1, 2, 3, 4]]  # test_serve_batched


@pytest.fixture(scope="module")
def weights():
    jp = JModel(CFG).init(jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), CFG)


def _engine(tp, cfg=CFG, **kw):
    return ServeEngine(cfg, tp, max_len=64, device="cpu", **kw)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_tokens_match_jax_engine(weights, temperature):
    """Greedy output equals the JAX engine's token for token; sampled
    output too, since both draw from np.random.default_rng(seed)."""
    jp, tp = weights
    jout = JEngine(CFG, jp, max_len=64, seed=3).generate(
        [JRequest(i, list(p), 6, temperature) for i, p in enumerate(PROMPTS)]
    )
    tout = _engine(tp, seed=3).generate(
        [Request(i, list(p), 6, temperature) for i, p in enumerate(PROMPTS)]
    )
    assert tout == jout


def test_solo_vs_batched_identical(weights):
    _, tp = weights
    solo = {}
    for i, p in enumerate(PROMPTS):
        solo.update(_engine(tp).generate([Request(i, list(p), max_new_tokens=6)]))
    batched = _engine(tp).generate(
        [Request(i, list(p), max_new_tokens=6) for i, p in enumerate(PROMPTS)]
    )
    assert batched == solo


def test_continuous_refill_matches_solo(weights):
    _, tp = weights
    reqs = [Request(i, list(p), max_new_tokens=4 + i) for i, p in enumerate(PROMPTS)]
    eng = _engine(tp, batch_size=2)
    batched = eng.generate(reqs)
    assert all(r.done for r in reqs)
    assert len(eng.call_seconds["prefill"]) == len(PROMPTS)
    for i, p in enumerate(PROMPTS):
        out = _engine(tp).generate([Request(i, list(p), max_new_tokens=4 + i)])
        assert batched[i] == out[i]


def test_over_budget_raises_by_default(weights):
    eng = _engine(weights[1])
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.generate([Request(0, [1] * 60, max_new_tokens=10)])
    with pytest.raises(ValueError, match="no room to generate"):
        eng.generate([Request(0, [1] * 64, max_new_tokens=1)])
    with pytest.raises(ValueError, match="empty prompt"):
        eng.generate([Request(0, [], max_new_tokens=1)])
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.generate([Request(0, [1], max_new_tokens=0)])


def test_overflow_truncate_marks_request(weights):
    r = Request(0, [1] * 60, max_new_tokens=10)
    out = _engine(weights[1], overflow="truncate").generate([r])
    assert r.truncated and r.done
    assert len(out[0]) == 4  # 64 - 60: capped, not silently short


def test_eos_terminates_and_is_excluded(weights):
    _, tp = weights
    base = _engine(tp).generate([Request(0, [5, 6, 7], max_new_tokens=8)])[0]
    assert len(base) == 8
    eos = base[3]
    cut = base.index(eos)
    r = Request(0, [5, 6, 7], max_new_tokens=8)
    out = _engine(tp, eos_id=eos).generate([r])
    assert out[0] == base[:cut]
    assert r.done


def test_sliding_window_config_rejected(weights):
    with pytest.raises(NotImplementedError, match="sliding_window"):
        _engine(weights[1], cfg=dataclasses.replace(CFG, sliding_window=16))


# --------------------------------------------------------------------------
# SSM serving (reduced mamba2-370m)
# --------------------------------------------------------------------------

MCFG = reduced_config("mamba2-370m")
# The JAX engine's conv cache is wrong for prompts shorter than
# ssm_conv - 1 = 3 tokens (ROADMAP.md, C1): it raises on 2 tokens and
# drifts on 1.  Prompts of 3 or more tokens are held against the JAX
# engine, shorter ones against the JAX model's own recurrence.
LONG_PROMPTS = [[5, 6, 7], [9, 10, 11, 2, 5, 3, 8], [1, 2, 3, 4], [4, 8, 15, 16, 23, 42, 1, 9, 30]]
SHORT_PROMPTS = [[5], [7, 3]]


@pytest.fixture(scope="module")
def mamba_weights():
    jm = JModel(MCFG)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, params_from_jax(jax.tree.map(np.asarray, jp), MCFG)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_mamba_tokens_match_jax_engine(mamba_weights, temperature):
    _, jp, tp = mamba_weights
    reqs = [(i, list(p), 6, temperature) for i, p in enumerate(LONG_PROMPTS)]
    jout = JEngine(MCFG, jp, max_len=64, seed=3, batch_size=2).generate(
        [JRequest(*r) for r in reqs]
    )
    tout = _engine(tp, cfg=MCFG, seed=3, batch_size=2).generate([Request(*r) for r in reqs])
    assert tout == jout


def _greedy_by_recurrence(jm, jp, prompt, n_new):
    """Greedy tokens from the JAX model's decode_step, fed one token at a
    time from init_cache: the recurrence with the causal conv's zero
    padding, which a short prompt's prefill must reproduce."""
    cache = jm.init_cache(1, 64, jnp.float32)
    out, tok = [], None
    for t in range(len(prompt) + n_new - 1):
        tok = prompt[t] if t < len(prompt) else out[-1]
        logits, cache = jm.decode_step(
            jp, cache, jnp.asarray([[tok]], jnp.int32), jnp.asarray(t, jnp.int32)
        )
        if t >= len(prompt) - 1:
            row = np.asarray(logits, np.float64)[0, 0]
            row[MCFG.vocab_size :] = -1e30
            out.append(int(np.argmax(row)))
    return out


def test_mamba_short_prompts_follow_the_recurrence(mamba_weights):
    jm, jp, tp = mamba_weights
    reqs = [Request(i, list(p), max_new_tokens=6) for i, p in enumerate(SHORT_PROMPTS)]
    tout = _engine(tp, cfg=MCFG).generate(reqs)
    for i, p in enumerate(SHORT_PROMPTS):
        assert tout[i] == _greedy_by_recurrence(jm, jp, p, 6), p


def test_mamba_solo_vs_batched_identical(mamba_weights):
    _, _, tp = mamba_weights
    prompts = LONG_PROMPTS + SHORT_PROMPTS
    solo = {}
    for i, p in enumerate(prompts):
        solo.update(_engine(tp, cfg=MCFG).generate([Request(i, list(p), max_new_tokens=6)]))
    batched = _engine(tp, cfg=MCFG).generate(
        [Request(i, list(p), max_new_tokens=6) for i, p in enumerate(prompts)]
    )
    assert batched == solo


def test_mamba_continuous_refill_matches_solo(mamba_weights):
    """Six requests on two rows: every row is refilled over a row whose
    conv window and state a longer request left behind."""
    _, _, tp = mamba_weights
    prompts = LONG_PROMPTS + SHORT_PROMPTS
    reqs = [Request(i, list(p), max_new_tokens=3 + i) for i, p in enumerate(prompts)]
    eng = _engine(tp, cfg=MCFG, batch_size=2)
    batched = eng.generate(reqs)
    assert all(r.done for r in reqs)
    assert len(eng.call_seconds["prefill"]) == len(prompts)
    for i, p in enumerate(prompts):
        out = _engine(tp, cfg=MCFG).generate([Request(i, list(p), max_new_tokens=3 + i)])
        assert batched[i] == out[i]


def test_mamba_insert_row_carries_conv_and_state(mamba_weights):
    _, _, tp = mamba_weights
    model = _engine(tp, cfg=MCFG).model
    cache = model.init_cache(3, 64, torch.float32)
    _, row = model.prefill(tp, {"tokens": torch.tensor([[3, 1]])}, model.init_cache(1, 64, torch.float32))
    ServeEngine.insert_row(cache, row, 1)
    conv, ssm = cache["sub0"]["conv"], cache["sub0"]["ssm"]
    assert conv.shape == (MCFG.n_scan_blocks, 3, MCFG.ssm_conv - 1, MCFG.d_inner + 2 * MCFG.ssm_state)
    assert ssm.dtype == torch.float32
    torch.testing.assert_close(conv[:, 1], row["sub0"]["conv"][:, 0], atol=0, rtol=0)
    torch.testing.assert_close(ssm[:, 1], row["sub0"]["ssm"][:, 0], atol=0, rtol=0)
    assert not conv[:, 1, 0].any()  # a 2-token prompt's window starts with a zero row
    assert not conv[:, [0, 2]].any() and not ssm[:, [0, 2]].any()


# --------------------------------------------------------------------------
# latency
# --------------------------------------------------------------------------


def test_latency_model_validation():
    with pytest.raises(ValueError, match="per_req"):
        BatchLatencyModel(base=0.1, per_req=0.0)
    with pytest.raises(ValueError, match="base"):
        BatchLatencyModel(base=-1.0, per_req=0.1)
    with pytest.raises(ValueError, match="tokens_per_request"):
        BatchLatencyModel(base=0.1, per_req=0.1, tokens_per_request=0)
    with pytest.raises(ValueError, match="batch"):
        H100_SERVE_MODEL.step_time(0)
    m = BatchLatencyModel(base=0.5, per_req=0.25, tokens_per_request=4)
    assert m.service_time(2) == 4.0 and m.throughput(2) == 0.5
    assert (m.batch_base, m.batch_per_req) == (2.0, 1.0)


def test_calibrate_on_cpu_returns_valid_model(weights):
    model = calibrate(_engine(weights[1]), batch_sizes=(1, 2, 4), steps=3, device="cpu")
    assert isinstance(model, BatchLatencyModel)
    assert math.isfinite(model.base) and model.per_req > 0
    with pytest.raises(ValueError, match="must exceed steps"):
        calibrate(_engine(weights[1]), steps=64, device="cpu")


def test_h100_curve_is_a_valid_model():
    assert H100_SERVE_MODEL.base > 0 and H100_SERVE_MODEL.per_req > 0
    assert H100_SERVE_MODEL.tokens_per_request == 32
