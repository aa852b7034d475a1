"""The port's span recorder (``repro_torch.spans``) and the spans that the
serving engine and the train step record, on the CPU: kept only under an
active profiler, one session a profiled window, and the engine's spans
matching what it did."""
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train.train_step import TrainState, make_train_step  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

CFG = reduced_config("deepseek-7b")
# (prompt length, new tokens) at decode batch 2: request 0 retires after the
# second step and rides along as a dummy until request 2 takes its row;
# request 2 retires at once and rides along in the last step.
REQUESTS = [(3, 2), (5, 4), (2, 1)]
# the keys each decode step visits, row by row (slots 0..pos): row positions
# [3, 5], then [4 (retired), 6], then [2 (retired), 7]
KEYS = [(3 + 1) + (5 + 1), (4 + 1) + (6 + 1), (2 + 1) + (7 + 1)]


@pytest.fixture(scope="module")
def params():
    return Model(CFG, "cpu").init(torch.Generator().manual_seed(0))


def profiled(fn):
    """``fn()`` in a new recording session: a span asked for with no
    profiler active ends the last one."""
    assert spans.begin("between sessions") is None
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def serve(params, eng=None):
    eng = eng or ServeEngine(CFG, params, max_len=32, batch_size=2, device="cpu")
    reqs = [Request(10 + i, list(range(1, p + 1)), max_new_tokens=n) for i, (p, n) in enumerate(REQUESTS)]
    return eng, eng.generate(reqs)


def by_name(got):
    out = {}
    for s in got:
        out.setdefault(s.name, []).append(s)
    return out


def test_no_span_is_kept_or_cuda_event_made_without_a_profiler(params, monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda **kw: made.append(kw))
    profiled(lambda: spans.end(spans.begin("kept")))
    assert [s.name for s in spans.session()] == ["kept"]
    assert spans.begin("off", device=True) is None
    spans.end(None)
    serve(params)
    assert [s.name for s in spans.session()] == ["kept"]  # the last session, untouched
    assert made == []


def test_generate_records_its_spans(params):
    eng, out = profiled(lambda: serve(params))
    got = by_name(spans.session())
    ids = [10 + i for i in range(len(REQUESTS))]
    assert sorted(out) == ids
    assert [s.attrs["request_id"] for s in got["serve.request"]] == ids
    assert [(s.attrs["request_id"], s.attrs["prompt_len"]) for s in got["serve.prefill"]] == \
        [(10 + i, p) for i, (p, _) in enumerate(REQUESTS)]
    assert [s.attrs["request_id"] for s in got["serve.insert_row"]] == ids
    assert len(got["serve.decode"]) == len(eng.call_seconds["decode"]) == len(KEYS)
    assert [s.attrs["keys"] for s in got["serve.decode"]] == KEYS
    assert all(s.attrs["rows"] == 2 for s in got["serve.decode"])
    assert len(got["serve.sample"]) == len(KEYS) + 1  # the last step samples and stops
    # the parents: cache_init, forward and readback in each prefill, forward
    # and readback in each decode step; the rest at the top
    kids = {}
    for s in spans.session():
        kids.setdefault(s.parent, []).append(s.name)
    for s in got["serve.prefill"]:
        assert kids[s.id] == ["serve.cache_init", "serve.forward", "serve.readback"]
    for s in got["serve.decode"]:
        assert kids[s.id] == ["serve.forward", "serve.readback"]
    top = {"serve.request", "serve.prefill", "serve.insert_row", "serve.sample", "serve.decode"}
    assert set(kids[None]) == top
    assert len(got["serve.forward"]) == len(got["serve.readback"]) == len(REQUESTS) + len(KEYS)
    for s in spans.session():  # closed, inside their parents, each request in its own span
        assert s.end is not None and s.start <= s.end
        if s.parent is not None:
            p = spans.session()[s.parent]
            assert p.start <= s.start and s.end <= p.end
    req = {s.attrs["request_id"]: s for s in got["serve.request"]}
    for s in got["serve.prefill"] + got["serve.insert_row"]:
        r = req[s.attrs["request_id"]]
        assert r.start <= s.start and s.end <= r.attrs["first_token"] <= r.end


def test_call_seconds_are_the_call_spans_durations(params):
    eng, _ = profiled(lambda: serve(params))
    got = by_name(spans.session())
    for kind in ("prefill", "decode"):
        assert eng.call_seconds[kind] == [(s.end - s.start) / 1e9 for s in got[f"serve.{kind}"]]
    assert len(eng.call_seconds["prefill"]) == len(REQUESTS)
    unprofiled, _ = serve(params)
    assert {k: len(v) for k, v in unprofiled.call_seconds.items()} == \
        {k: len(v) for k, v in eng.call_seconds.items()}
    assert all(v > 0 for v in unprofiled.call_seconds["prefill"] + unprofiled.call_seconds["decode"])


def test_a_new_session_clears_the_last(params):
    profiled(lambda: serve(params))
    first = spans.session()
    spans.begin("not kept")
    profiled(lambda: spans.end(spans.begin("second")))
    assert [s.name for s in spans.session()] == ["second"]
    assert first and first[0].name == "serve.request"


def test_a_session_keeps_at_most_cap_spans(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 3)
    kept = profiled(lambda: [spans.begin(f"s{i}") for i in range(5)])
    assert [s.name for s in spans.session()] == ["s0", "s1", "s2"] and kept[3:] == [None, None]
    spans.end(kept[4])


def test_a_parent_of_an_earlier_session_is_not_named():
    old = profiled(lambda: spans.begin("old"))
    spans.begin("not kept")
    child = profiled(lambda: spans.begin("child", old))
    assert child.parent is None


@pytest.mark.parametrize("microbatches", [1, 2])
def test_a_train_step_records_its_phases(params, microbatches):
    model = Model(CFG, "cpu")
    state = TrainState(params=tree_map(torch.clone, params), opt=adamw_init(params))
    step = make_train_step(model, AdamWConfig(), num_microbatches=microbatches)
    g = torch.Generator().manual_seed(1)
    batches = [{"tokens": torch.randint(0, CFG.vocab_size, (2, 8), generator=g, dtype=torch.int32),
                "labels": torch.randint(0, CFG.vocab_size, (2, 8), generator=g, dtype=torch.int32)}
               for _ in range(2)]

    def two():
        s = state
        for b in batches:
            s, _ = step(s, b)

    profiled(two)
    got = spans.session()
    steps = [s for s in got if s.name == "train.step"]
    assert len(steps) == 2 and all(s.parent is None for s in steps)
    for st in steps:
        inside = [s.name for s in got if s.parent == st.id]
        assert inside == ["train.forward", "train.backward"] * microbatches + ["train.adamw"]
        for s in got:
            if s.parent == st.id:
                assert st.start <= s.start <= s.end <= st.end
                assert s.device_ms() is None  # host stamps only on the CPU
