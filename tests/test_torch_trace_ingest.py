"""The port's ``repro_torch.core.trace_ingest`` against the reference's
``repro.core.trace_ingest``, on the repo's own data: the committed sample
trace (tests/golden/sample_trace.csv) gives the same JobSpecs, the same
IngestStats and the same A-SRPT schedule digest, eagerly, lazily and as a
replayable source; every malformed row of tests/test_trace_ingest.py
raises the same error with the same message, or, under
``on_error="skip"``, is skipped and counted the same; header errors,
out-of-order submits and the CLI's JSONL shard are the same.  No public
trace is read."""
import dataclasses

import pytest

pytestmark = pytest.mark.sched
pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
import test_trace_ingest as T  # noqa: E402
from repro.core import scenario as r_scenario  # noqa: E402
from repro.core import trace_ingest as r_ingest  # noqa: E402
from repro_torch.core import scenario as p_scenario  # noqa: E402
from repro_torch.core import trace_ingest as p_ingest  # noqa: E402

SAMPLE = T.SAMPLE
HEADER = T.HEADER


def _spec(core):
    return core.ClusterSpec(num_servers=8, gpus_per_server=8, b_inter=1.25e9, b_intra=300e9)


def _jobs(core_scenario, jobs):
    return core_scenario.jobs_to_dicts(list(jobs))


def _load(core, path, **kw):
    """(job dicts, stats) of an eager load, or the error's type name and
    message."""
    stats = core.IngestStats()
    try:
        jobs = core.load_trace_csv(path, stats=stats, **kw)
    except core.TraceSchemaError as exc:
        return "TraceSchemaError", str(exc)
    sc = r_scenario if core is R else p_scenario
    return _jobs(sc, jobs), dataclasses.asdict(stats)


def _lazy(core, path, **kw):
    try:
        jobs = list(core.iter_trace_csv(path, **kw))
    except core.TraceSchemaError as exc:
        return "TraceSchemaError", str(exc)
    return _jobs(r_scenario if core is R else p_scenario, jobs)


def test_sample_trace_jobs_and_stats():
    want, got = _load(R, SAMPLE), _load(P, SAMPLE)
    assert got == want and len(want[0]) == 30 and want[1]["n_skipped"] == 0
    assert _lazy(P, SAMPLE) == _lazy(R, SAMPLE) == want[0]


def test_sample_trace_schedule_digest():
    def run(core):
        pol = core.ASRPTPolicy(core.make_predictor("mean"))
        eager = core.simulate(core.ingest_scenario(SAMPLE, _spec(core)), pol)
        src = core.trace_jobs_source(SAMPLE)
        lazy = core.simulate(core.Scenario(jobs=src, cluster=_spec(core)),
                             core.ASRPTPolicy(core.make_predictor("mean")))
        return eager.schedule_digest(), lazy.schedule_digest(), eager.total_flow_time

    want = run(R)
    assert run(P) == want and want[0] == want[1]
    assert p_ingest.ingest_scenario(SAMPLE, _spec(P)).to_json() == \
        r_ingest.ingest_scenario(SAMPLE, _spec(R)).to_json()


MALFORMED = T.test_malformed_row_raises_with_location.pytestmark[0].args[1]


@pytest.mark.parametrize("row,needle", MALFORMED)
def test_malformed_row_same_error(tmp_path, row, needle):
    p = T._write(tmp_path, "0.0,1,600,ok,,\n" + row)
    want = _load(R, p)
    assert want[0] == "TraceSchemaError" and needle in want[1] and f"{p}:3:" in want[1]
    assert _load(P, p) == want
    # skipped and counted alike
    assert _load(P, p, on_error="skip") == _load(R, p, on_error="skip")


def test_skip_policy_same_counts(tmp_path):
    p = T._write(tmp_path, "0.0,1,600,a,,\n1.0,0,600,a,,\n2.0,1,bad,a,,\n3.0,1,600,a,,\n")
    want = _load(R, p, on_error="skip")
    assert _load(P, p, on_error="skip") == want
    assert want[1]["n_skipped"] == 2 and want[1]["skipped_lines"] == [3, 4]


@pytest.mark.parametrize("header,body", [
    ("num_gpus,duration\n", "1,600\n"),
    ("submit_time,num_gpus\n", "0.0,1\n"),
    ("", ""),
    (HEADER, "10.0,1,600,a,,\n5.0,1,600,b,,\n"),
    ("submitted_time,plan_gpu,run_time\n", "5.0,4,120\n"),
    (HEADER, "2017-10-03 14:00:00,1,600,alice,resnet152,\n2017-10-03 14:05:30,1,600,bob,resnet152,\n"),
    (HEADER, "0.0,2,100,dave,,sweep\n1.0,2,100,dave,,sweep\n2.0,2,100,erin,bert_large,\n"
             "3.0,2,100,erin,bert_large,\n4.0,4,100,erin,bert_large,\n"),
])
def test_headers_order_and_tags_same(tmp_path, header, body):
    p = tmp_path / "t.csv"
    p.write_text(header + body)
    for kw in ({}, {"on_error": "skip"}):
        assert _lazy(P, p, **kw) == _lazy(R, p, **kw)
        assert _load(P, p, **kw) == _load(R, p, **kw)


def test_cli_jsonl_shard_same(tmp_path):
    a, b = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    assert r_ingest._main(["convert", SAMPLE, "--jsonl", str(a)]) == 0
    assert p_ingest._main(["convert", SAMPLE, "--jsonl", str(b)]) == 0
    assert b.read_text() == a.read_text() and a.read_text()
