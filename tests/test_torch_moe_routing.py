"""The MoE layer's routing read-out (``moe.record_routing``), the serving
engine's tags on it, the layer's spans and counters, and the benchmark's
reference that follows recorded routing (``portbench/reference/routed.py``),
on the CPU.  The last serves a small qwen3-moe shape in float32 at a decode
batch whose calls drop pairs (more rows than an expert has slots), which
the unpinned reference cannot follow."""
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CFG = reduced_config("qwen3-moe-30b-a3b")
# (prompt length, new tokens) at decode batch 2, as tests/test_torch_spans.py
# serves them: request 10 retires after the second step and rides along
# until request 12 takes its row; request 12 retires at once and rides
# along in the last step.
REQUESTS = [(3, 2), (5, 4), (2, 1)]
CALLS = [("prefill", (10,), 3), ("prefill", (11,), 5), ("decode", (10, 11), 2), ("decode", (None, 11), 2),
         ("prefill", (12,), 2), ("decode", (None, 11), 2)]


@pytest.fixture(scope="module")
def params():
    return Model(CFG, "cpu").init(torch.Generator().manual_seed(0))


def serve(params, logits=None):
    """The three requests at decode batch 2; ``logits`` collects every
    call's logits as read back, in order."""
    eng = ServeEngine(CFG, params, max_len=32, batch_size=2, device="cpu")
    if logits is not None:
        read = eng._logits_to_host
        eng._logits_to_host = lambda lg: logits.append(read(lg)) or logits[-1]
    reqs = [Request(10 + i, list(range(1, p + 1)), max_new_tokens=n) for i, (p, n) in enumerate(REQUESTS)]
    return eng.generate(reqs)


def test_the_recorder_keeps_what_route_chose():
    gen = torch.Generator().manual_seed(1)
    router = torch.randn(CFG.d_model, CFG.n_experts, generator=gen)
    x = torch.randn(40, CFG.d_model, generator=gen)
    with moe.record_routing() as rec:
        r = moe.route(router, CFG, x)
        moe.tag_routing("prefill", [7])
        r2 = moe.route(router, CFG, x[:9])
    assert [(g.call, g.layer, g.kind, g.rows) for g in rec.records] == [(-1, 0, "", ()), (0, 0, "prefill", (7,))]
    for got, want in zip(rec.records, (r, r2)):
        # the routing's own tensors, not copies
        assert got.top_i is want.top_i and got.slot is want.slot and got.keep is want.keep
    assert rec.records[0].top_i.shape == (40, CFG.top_k)


def test_outputs_are_the_same_bits_with_the_recorder_on_and_off(params):
    off_logits, on_logits = [], []
    off = serve(params, off_logits)
    with moe.record_routing() as rec:
        on = serve(params, on_logits)
    assert on == off
    assert len(on_logits) == len(off_logits) == len(CALLS)
    assert all((a == b).all() for a, b in zip(on_logits, off_logits))
    kept = len(rec.records)
    assert kept == len(CALLS) * CFG.n_layers
    assert not moe.recording()
    serve(params)  # nothing is kept once the block is left
    moe.tag_routing("decode", [1])  # and a tag with no recorder is a no-op
    assert len(rec.records) == kept and not moe.recording()
    with pytest.raises(RuntimeError):
        with moe.record_routing(), moe.record_routing():
            pass
    assert not moe.recording()


def test_the_engine_tags_prefill_decode_and_riding_rows(params):
    with moe.record_routing() as rec:
        serve(params)
    got = [(g.call, g.layer, g.kind, g.rows, g.top_i.shape[0]) for g in rec.records]
    want = [(i, layer, kind, rows, T) for i, (kind, rows, T) in enumerate(CALLS) for layer in range(CFG.n_layers)]
    assert got == want


def test_the_span_counters_are_the_routings_own_counts(params):
    assert spans.begin("between sessions") is None
    with moe.record_routing() as rec, profile(activities=[ProfilerActivity.CPU]):
        serve(params)
    session = spans.session()
    routes = [s for s in session if s.name == "moe.route"]
    experts = [s for s in session if s.name == "moe.experts"]
    assert len(routes) == len(experts) == len(rec.records) == len(CALLS) * CFG.n_layers
    for s, e, r in zip(routes, experts, rec.records):
        T = r.top_i.shape[0]
        load = torch.bincount(r.top_i.reshape(-1), minlength=CFG.n_experts)
        held = set(r.top_i.reshape(-1)[r.keep].tolist())
        assert s.attrs["pairs"] == T * CFG.top_k
        assert int(s.attrs["kept"]) == int(r.keep.sum())
        assert int(s.attrs["live"]) == len(held)
        assert int(s.attrs["max_load"]) == int(load.max())
        assert e.parent == s.id and s.start <= e.start <= e.end <= s.end
        assert e.device_ms() is None  # no device stamps on the CPU
    decode = [s for s in session if s.name == "serve.decode"]
    assert len(decode) == 3 and all(
        sum(d.start <= s.start and s.end <= d.end for s in routes) == CFG.n_layers for d in decode)


def test_without_a_profiler_the_layer_opens_no_span(params, monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda **kw: made.append(kw))
    monkeypatch.setattr(moe, "_counts", lambda r: made.append(r))
    serve(params)
    assert made == []


# --------------------------------------------------------------------------
# the reference that follows the recorded routing
# --------------------------------------------------------------------------

TINY = ROOT / "portbench" / "tests" / "tiny"
SEED = 3_141_592_653
BATCH = 16  # rows of a decode call: 8 slots an expert (capacity of 16 rows), fewer than the rows
TOL = 1e-4  # float32 logits on both sides after 2 layers; sums run in another order


@pytest.fixture(scope="module")
def tiny():
    """tiny-moe (a qwen3-moe shape: 8 experts, top 2, q/k norm) in float32,
    its weights drawn as the benchmark draws them, 24 requests whose
    prompts and answers vary."""
    from portbench import weights

    cfg = json.loads((TINY / "tiny-moe.json").read_text())
    cfg = dict(cfg, torch_dtype="float32", reduced=cfg["reduced"] + ["torch_dtype"])
    gen = torch.Generator().manual_seed(2)
    reqs = [(torch.randint(0, cfg["vocab_size"], (int(torch.randint(8, 60, (1,), generator=gen)),),
                           generator=gen).tolist(), int(torch.randint(3, 9, (1,), generator=gen)))
            for _ in range(24)]
    return cfg, weights.draw(cfg, SEED, "cpu"), reqs


def serve_tiny(tiny):
    """Serve the requests, recording the routing: ``(checked, calls,
    logits)``, ``checked`` each request's ``(id, prompt, served)``, ``calls``
    the recorded routing as the reference takes it, ``logits`` each
    request's served logits over the published vocabulary."""
    from portbench import program
    from portbench.bench import _load

    cfg, params, reqs = tiny
    kind = _load(ROOT / "portbench" / "traffic" / "serve_waves_routed.py")
    eng = ServeEngine(program.arch(cfg), params, max_len=128, batch_size=BATCH, device="cpu")
    read, seen = eng._logits_to_host, []
    eng._logits_to_host = lambda lg: seen.append(read(lg)) or seen[-1]
    with moe.record_routing() as rec:
        out = eng.generate([Request(i, p, max_new_tokens=n) for i, (p, n) in enumerate(reqs)])
    calls = kind.calls_of(rec.records, cfg["num_hidden_layers"])
    assert len(calls) == len(seen)
    per: dict = {i: [] for i in out}
    for c, lg in zip(calls, seen):
        for row, rid in enumerate(c["rows"]):
            if rid is not None:
                per[rid].append(torch.from_numpy(lg[row, :cfg["vocab_size"]]))
    checked = [(i, p, out[i]) for i, (p, _) in enumerate(reqs)]
    return checked, calls, [torch.stack(per[i][:len(out[i])]) for i in out]


def test_the_routed_reference_follows_the_engine_where_decode_calls_drop_pairs(tiny):
    from portbench.reference import model as R
    from portbench.reference import routed

    cfg, params, _ = tiny
    checked, calls, served = serve_tiny(tiny)
    decode = [k for c in calls if c["kind"] == "decode" for k in c["keep"]]
    assert not torch.cat(decode).all()  # some decode call dropped a pair
    with pytest.raises(ValueError):  # which the unpinned reference cannot follow
        R.served_logits(cfg, params, [(p, g) for _, p, g in checked], batch_rows=BATCH)
    want, ref = routed.served_logits(cfg, params, checked, calls)
    for got, w in zip(served, want):
        torch.testing.assert_close(got, w, rtol=TOL, atol=TOL)
    assert float(ref.margin) < 1e-4 and routed.keep_mismatch(cfg, calls) == 0


def test_the_route_fault_moves_route_margin(tiny, monkeypatch):
    """At one layer, each token's K-th expert swapped for its K+1-th."""
    from portbench.reference import routed

    cfg = tiny[0]
    scores, n = moe._scores, [0]

    def swapped(router, c, xt):
        probs, top_p, top_i = scores(router, c, xt)
        n[0] += 1
        if n[0] % c.n_layers == 1:  # the first layer of each call
            top_i = torch.cat([top_i[:, :-1], torch.topk(probs, c.top_k + 1, dim=-1).indices[:, -1:]], 1)
        return probs, top_p, top_i

    monkeypatch.setattr(moe, "_scores", swapped)
    checked, calls, _ = serve_tiny(tiny)
    _, ref = routed.served_logits(cfg, tiny[1], checked, calls)
    assert float(ref.margin) > 0.1 and routed.keep_mismatch(cfg, calls) == 0


@pytest.mark.parametrize("off", [-1, 1])
def test_a_capacity_one_slot_off_moves_keep_mismatch(tiny, monkeypatch, off):
    from portbench.reference import routed

    capacity = moe.moe_capacity
    monkeypatch.setattr(moe, "moe_capacity", lambda c, n: capacity(c, n) + off)
    _, calls, _ = serve_tiny(tiny)
    assert routed.keep_mismatch(tiny[0], calls) > 0
