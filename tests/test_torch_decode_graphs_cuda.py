"""The serving engine's prefills and decode steps from CUDA graphs
(``ServeEngine``'s ``cuda_graphs``, ``repro_torch.models.graphs``) against
its eager calls, on the card: the same tokens and logits bit for bit, the
same routing read out, and the decode steps' mixture-of-experts spans with
their counters and device stamps.  Every test here is marked ``cuda`` and skips without a CUDA
device; the file imports no JAX."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import Model, moe  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

# (prompt length, new tokens): more requests than rows, so that rows retire,
# ride along and are filled again; 12 rows of top-2 over 4 experts give each
# expert 8 slots for 24 pairs, so decode calls drop pairs
REQUESTS = [(3 + (7 * i) % 11, 2 + (5 * i) % 7) for i in range(16)]
ROWS = 12


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs are captured and replayed on the card")


def _params(arch: str, dtype: str):
    cfg = dataclasses.replace(reduced_config(arch), dtype=dtype)
    return cfg, Model(cfg, "cuda").init(torch.Generator("cuda").manual_seed(0))


def _serve(cfg, params, cuda_graphs: bool, waves: int = 2):
    """``waves`` generate calls of REQUESTS (the later ones replay the first
    one's graphs): (tokens of each, every logits read back, the routing
    records, the engine)."""
    eng = ServeEngine(cfg, params, max_len=64, batch_size=ROWS, device="cuda", cuda_graphs=cuda_graphs)
    logits = []
    read = eng._logits_to_host
    eng._logits_to_host = lambda lg: logits.append(read(lg)) or logits[-1]
    out = []
    with moe.record_routing() as rec:
        for w in range(waves):
            reqs = [Request(100 * w + i, [(17 * i + j) % (cfg.vocab_size - 1) + 1 for j in range(p)], max_new_tokens=n)
                    for i, (p, n) in enumerate(REQUESTS)]
            out.append(eng.generate(reqs))
    return out, logits, rec.records, eng


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_decode_is_the_eager_decode_bit_for_bit(arch, dtype):
    _cuda()
    cfg, params = _params(arch, dtype)
    eager, eager_logits, eager_rec, _ = _serve(cfg, params, False)
    graphed, graphed_logits, graphed_rec, eng = _serve(cfg, params, True)
    # captured once, replayed after: a decode step's sub-layers and expert layers, a prefill a prompt length
    assert len(eng._graphs) == cfg.n_layers * (2 if cfg.n_experts else 1)
    assert len(eng._prefills) == len({p for p, _ in REQUESTS})
    assert graphed == eager
    assert len(graphed_logits) == len(eager_logits)
    assert all((a == b).all() for a, b in zip(graphed_logits, eager_logits))
    assert len(graphed_rec) == len(eager_rec)
    for a, b in zip(graphed_rec, eager_rec):
        assert (a.call, a.layer, a.kind, a.rows) == (b.call, b.layer, b.kind, b.rows)
        assert torch.equal(a.top_i, b.top_i) and torch.equal(a.slot, b.slot) and torch.equal(a.keep, b.keep)
    if cfg.n_experts:
        decode = [r for r in graphed_rec if r.kind == "decode"]
        assert decode and int(sum((~r.keep).sum() for r in decode)) > 0  # decode calls dropped pairs
        # each record its own copy: the graphs' buffers are overwritten by the next replay
        assert len({r.top_i.data_ptr() for r in graphed_rec}) == len(graphed_rec)


@pytest.mark.cuda
def test_graphed_moe_layers_keep_their_spans_and_counters():
    _cuda()
    cfg, params = _params("qwen3-moe-30b-a3b", "bfloat16")
    eng = ServeEngine(cfg, params, max_len=64, batch_size=ROWS, device="cuda", cuda_graphs=True)

    def wave(first):
        return [Request(first + i, [i + 1] * p, max_new_tokens=n) for i, (p, n) in enumerate(REQUESTS)]

    eng.generate(wave(0))  # captured outside the profile
    with moe.record_routing() as rec, profile(activities=[ProfilerActivity.CUDA]):
        eng.generate(wave(100))
        torch.cuda.synchronize()
    got = spans.session()
    routes = [s for s in got if s.name == "moe.route"]
    decode = [r for r in rec.records if r.kind == "decode"]
    assert len(routes) == len(decode)  # a span a decode step's routing call, in order; none in a replayed prefill
    for span, r in zip(routes, decode):
        load = torch.bincount(r.top_i.reshape(-1), minlength=cfg.n_experts)
        kept, live, most = (int(span.attrs[k]) for k in moe.COUNTED)
        assert (kept, live, most) == (int(r.keep.sum()), int((load > 0).sum()), int(load.max()))
        assert span.attrs["pairs"] == r.top_i.numel()
    steps = [s for s in got if s.name == "serve.decode"]
    assert steps
    for step in steps:
        inside = [s for s in routes if step.start <= s.start and s.end <= step.end]
        assert len(inside) == cfg.n_layers
        parts = [s for s in got if s.name == "moe.experts" and s.parent in {r.id for r in inside}]
        assert len(parts) == cfg.n_layers and all(s.device_ms() >= 0 for s in parts)
