"""The port's scheduler core (``repro_torch.core``) against the JAX
package's (``repro.core``), bit for bit: every golden schedule and the
straggler scenario's replay, traces job for job, the digests of A-SRPT
(refine on and off) and every baseline, the predictors' arrays, the
prediction-noise perturbations, and the ``--serve`` regime on the default
curve and on the H100's.  The copy's code is also held against the
reference's, and linted by detlint under the reference's own configuration."""
import ast
import dataclasses
import importlib.util
import json
import tomllib
from pathlib import Path

import numpy as np
import pytest

pytestmark = pytest.mark.sched
pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from benchmarks import sched_scale  # noqa: E402
from repro.analysis import detlint  # noqa: E402
from repro.core import scenario as r_scenario  # noqa: E402
from repro.serve import latency as r_latency  # noqa: E402
from repro_torch.core import scenario as p_scenario  # noqa: E402
from repro_torch.serve import latency as p_latency  # noqa: E402

# pytest puts the tests directory on sys.path (no tests/__init__.py)
import test_golden as G  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF_DIR = ROOT / "src" / "repro" / "core"
PORT_DIR = ROOT / "src" / "repro_torch" / "core"
COPIED = ("job", "graph", "timing", "profiles", "scenario", "quantile", "cluster", "heavy_edge",
          "srpt", "simulator", "migration", "predictor", "prediction_loop", "asrpt", "baselines",
          "trace")
LEFT_OUT = ("fleet", "trace_ingest", "ilp")


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_cluster(spec):
    """A reference ClusterSpec rebuilt in the port through the scenario
    schema (each side's own ``cluster_to_dict`` / ``cluster_from_dict``)."""
    got = p_scenario.cluster_from_dict(r_scenario.cluster_to_dict(spec))
    assert p_scenario.cluster_to_dict(got) == r_scenario.cluster_to_dict(spec)
    return got


def _port_jobs(jobs):
    return p_scenario.jobs_from_dicts(r_scenario.jobs_to_dicts(jobs))


def _mean(**kw):
    return P.ASRPTPolicy(P.make_predictor("mean"), tau=2.0, **kw)


def _baseline(name):
    return lambda: P.BASELINES[name](P.make_predictor("mean"))


# tests/test_golden.py's matrix with the port's policies: name -> (policy
# factory); the clusters and simulate kwargs are test_golden's own
PORT_POLICIES = {
    "A-SRPT @hom": _mean,
    "A-SRPT (uncached) @hom": lambda: _mean(placement_cache=False),
    "SPJF @hom": _baseline("SPJF"),
    "SPWF @hom": _baseline("SPWF"),
    "WCS-Duration @hom": _baseline("WCS-Duration"),
    "WCS-Workload @hom": _baseline("WCS-Workload"),
    "WCS-SubTime @hom": _baseline("WCS-SubTime"),
    "A-SRPT @het": _mean,
    "A-SRPT @het+fault": _mean,
    "A-SRPT (migrate) @het+straggler": lambda: _mean(migrate=True, migration_penalty=20.0),
}


@pytest.fixture(scope="module")
def golden_jobs():
    return p_scenario.jobs_from_dicts(json.loads(G.TRACE_PATH.read_text()))


@pytest.fixture(scope="module")
def expected():
    return json.loads(G.EXPECTED_PATH.read_text())


def test_port_matrix_is_the_golden_matrix(expected):
    assert set(PORT_POLICIES) == set(G.SCENARIOS) == set(expected)


@pytest.mark.parametrize("name", sorted(G.SCENARIOS))
def test_golden_schedule_in_port(name, golden_jobs, expected):
    cluster_fn, _, kwargs = G.SCENARIOS[name]
    res = P.simulate(golden_jobs, _port_cluster(cluster_fn()), PORT_POLICIES[name](), **kwargs)
    want = expected[name]
    assert res.schedule_digest() == want["sha256"], name
    assert res.total_flow_time == want["total_flow"], name
    assert res.peak_queue_depth == want["peak_depth"], name
    assert res.n_migrations == want["n_migrations"], name


def test_scenario_fixture_replays_straggler_golden_in_port(golden_jobs, expected):
    sc = P.Scenario.load(G.SCENARIO_PATH)
    assert sc.to_dict() == R.Scenario.load(G.SCENARIO_PATH).to_dict()
    assert sc.jobs == tuple(golden_jobs)
    res = P.simulate(sc, _mean(migrate=True, migration_penalty=20.0))
    assert res.schedule_digest() == expected[G.SCENARIO_OF]["sha256"]
    assert res.total_flow_time == expected[G.SCENARIO_OF]["total_flow"]


TRACE_CFGS = {
    "golden": dict(n_jobs=240, horizon=2400.0, seed=11, single_gpu_frac=0.4, max_gpus_per_job=16),
    "serve": dict(n_jobs=120, horizon=120 * 24.0, seed=3, single_gpu_frac=0.3,
                  max_gpus_per_job=32, mean_iters=400, sigma_iters=1.6),
    "default": dict(n_jobs=300, seed=5),
}


@pytest.mark.parametrize("cfg", sorted(TRACE_CFGS))
def test_generate_trace_equal(cfg):
    want = R.generate_trace(R.TraceConfig(**TRACE_CFGS[cfg]))
    got = P.generate_trace(P.TraceConfig(**TRACE_CFGS[cfg]))
    assert p_scenario.jobs_to_dicts(got) == r_scenario.jobs_to_dicts(want)
    assert P.trace_stats(got) == R.trace_stats(want)


def test_stream_trace_equal():
    kw = dict(n_jobs=2000, seed=7, chunk=512)
    got = list(P.stream_trace(P.StreamTraceConfig(**kw)))
    want = list(R.stream_trace(R.StreamTraceConfig(**kw)))
    assert p_scenario.jobs_to_dicts(got) == r_scenario.jobs_to_dicts(want)


def _policy(core, name):
    if name.startswith("A-SRPT"):
        kw = {"A-SRPT": {"refine_mapping": False}, "A-SRPT refine": {"refine_mapping": True},
              "A-SRPT migrate": {"refine_mapping": False, "migrate": True,
                                 "migration_penalty": 20.0}}[name]
        return core.ASRPTPolicy(core.make_predictor("mean"), tau=2.0, **kw)
    return core.BASELINES[name](core.make_predictor("median"))


def _seeded_run(core, name):
    jobs = core.generate_trace(core.TraceConfig(
        n_jobs=90, horizon=1500.0, seed=21, single_gpu_frac=0.4, max_gpus_per_job=16))
    cluster = core.mixed_cluster_spec(num_servers=8, seed=1)
    events = tuple(core.Degradation(t, m, factor=f) for t, m, f in G._STRAGGLERS)
    return core.simulate(core.Scenario(jobs=tuple(jobs), cluster=cluster, events=events),
                         _policy(core, name))


@pytest.mark.parametrize("name", ["A-SRPT", "A-SRPT refine", "A-SRPT migrate", *sorted(R.BASELINES)])
def test_simulate_digests_equal(name):
    """The refine pipeline's swap deltas run through BLAS dgemm: held here
    in one process on one numpy, as the reference's own suites hold it."""
    want, got = _seeded_run(R, name), _seeded_run(P, name)
    assert got.schedule_digest() == want.schedule_digest()
    assert got.total_flow_time == want.total_flow_time
    assert (got.peak_queue_depth, got.n_migrations) == (want.peak_queue_depth, want.n_migrations)


@pytest.mark.parametrize("refine", [False, True])
def test_map_job_equal(refine):
    """Heavy-edge mapping on fragmented free capacity: the same placements
    and the same alpha.  Refined, the swaps (BLAS dgemm) better the greedy
    placement of one of these 150 jobs (seed 1), so the path decides
    something here; in the seeded simulations above it changes no
    schedule."""
    moved = 0
    for seed in range(6):
        specs = [core.mixed_cluster_spec(num_servers=7, seed=seed, n_classes=3) for core in (R, P)]
        jobs = R.generate_trace(R.TraceConfig(
            n_jobs=25, horizon=1500.0, seed=seed, max_gpus_per_job=24, mean_iters=50,
            session_spread=30.0))
        rng = np.random.default_rng(seed)
        for job, port_job in zip(jobs, _port_jobs(jobs)):
            while True:
                free = {m: int(rng.integers(0, specs[0].server_gpus(m) + 1))
                        for m in range(specs[0].num_servers)}
                if sum(free.values()) >= job.g:
                    break
            consolidate = bool(rng.integers(0, 2))
            caps = R.select_servers(free, job.g, consolidate=consolidate, spec=specs[0])
            assert P.select_servers(free, job.g, consolidate=consolidate, spec=specs[1]) == caps
            want = R.map_job(job, caps, specs[0], refine=refine)
            got = P.map_job(port_job, caps, specs[1], refine=refine)
            assert got[1] == want[1]
            assert {m: np.asarray(v).tolist() for m, v in got[0].items()} == \
                {m: np.asarray(v).tolist() for m, v in want[0].items()}
            if refine:
                moved += got[1] != P.map_job(port_job, caps, specs[1], refine=False)[1]
    assert moved > 0 or not refine


def _observed_and_asked():
    jobs = R.generate_trace(R.TraceConfig(n_jobs=400, horizon=4000.0, seed=9))
    return jobs[:300], jobs[300:]


@pytest.mark.parametrize("kind", ["perfect", "mean", "median", "rf"])
def test_predictors_equal(kind):
    """Each predictor kind fed the same completions answers the same
    predictions (the forest fits twice: at 150 completions and at 300)."""
    seen, asked = _observed_and_asked()
    kw = {"retrain_every": 150, "n_estimators": 8} if kind == "rf" else {}
    preds = []
    for core in (R, P):
        pred = core.make_predictor(kind, seed=3, **kw)
        for job in (_port_jobs(seen) if core is P else seen):
            pred.observe(job, job.n_iters)
        preds.append(np.array([pred.predict(j) for j in (_port_jobs(asked) if core is P else asked)]))
    np.testing.assert_array_equal(preds[1], preds[0])
    if kind == "rf":
        assert preds[0].any()


@pytest.mark.parametrize("leaf", ["mean", "median"])
def test_random_forest_regressor_equal(leaf):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(500, 6))
    y = X[:, 0] * 3.0 + np.sin(X[:, 1]) + rng.normal(scale=0.1, size=500)
    Xq = rng.normal(size=(64, 6))
    kw = dict(n_estimators=6, max_depth=8, n_bins=64, max_samples=0.7, seed=4, leaf=leaf)
    want = R.RandomForestRegressor(**kw).fit(X, y).predict(Xq)
    got = P.RandomForestRegressor(**kw).fit(X, y).predict(Xq)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["oracle", "forest", "zero", "lognormal", "rankflip", "coldstart"])
def test_prediction_models_equal(kind):
    seen, asked = _observed_and_asked()
    kw = {"forest": {"retrain_every": 100, "n_estimators": 5}}.get(kind, {})
    out = []
    for core in (R, P):
        model = core.make_prediction_model(kind, seed=2, **kw)
        for job in (_port_jobs(seen) if core is P else seen):
            model.observe(job, job.n_iters)
        js = _port_jobs(asked) if core is P else asked
        out.append(np.array([[model.predict(j), model.reestimate(j, 10.0 * (i + 1))]
                             for i, j in enumerate(js)]))
    np.testing.assert_array_equal(out[1], out[0])


@pytest.mark.parametrize("mode", ["lognormal", "rankflip", "coldstart"])
def test_prediction_noise_perturbation_equal(mode):
    """``perturb_scenario`` with a noise mode reaches ``prediction_loop``
    through the scenario module's deferred imports."""
    results = []
    for core in (R, P):
        jobs = core.generate_trace(core.TraceConfig(
            n_jobs=80, horizon=1200.0, seed=13, max_gpus_per_job=16))
        base = core.Scenario(jobs=tuple(jobs), cluster=core.mixed_cluster_spec(num_servers=8, seed=2))
        perturbations = [core.PredictionNoisePerturbation(mode=mode),
                         core.StragglerPerturbation()]
        rng = np.random.default_rng(5)
        sc = core.perturb_scenario(base, perturbations, rng)
        policy = core.ASRPTPolicy(core.make_predictor("mean"), tau=2.0, refine_mapping=False)
        for p in perturbations:
            p.perturb_policy(policy, base, rng)
        results.append(core.simulate(sc, policy))
    want, got = results
    assert got.schedule_digest() == want.schedule_digest()
    assert (got.total_flow_time, got.n_reestimates) == (want.total_flow_time, want.n_reestimates)


def test_default_serve_model_is_the_reference_curve():
    assert dataclasses.asdict(p_latency.DEFAULT_SERVE_MODEL) == \
        dataclasses.asdict(r_latency.DEFAULT_SERVE_MODEL)
    stream = P.RequestStream(stream_id=0, rate=1.0, duration=1.0, slo=1.0)
    assert (stream.svc_base, stream.svc_per_req) == (
        r_latency.DEFAULT_SERVE_MODEL.batch_base, r_latency.DEFAULT_SERVE_MODEL.batch_per_req)


SERVE_N_JOBS = 25


@pytest.fixture(scope="module")
def chip_smoke():
    return _load_chip_smoke()


@pytest.mark.parametrize("curve", ["default", "H100"])
def test_serve_regime_equal(curve, chip_smoke, monkeypatch):
    """chip_smoke.py's phase 12 through the port against
    ``sched_scale_serve`` through the reference (its rounded rows), and
    against the same regime through the reference's scheduler (every
    number exact), at 25 jobs, on the default curve and on
    ``H100_SERVE_MODEL``'s."""
    model = None if curve == "default" else p_latency.H100_SERVE_MODEL
    if model is not None:
        stream = sched_scale._serve_stream
        monkeypatch.setattr(sched_scale, "_serve_stream", lambda horizon: dataclasses.replace(
            stream(horizon), svc_base=model.batch_base, svc_per_req=model.batch_per_req))
    rows = {r["metric"]: r for r in sched_scale.sched_scale_serve(n_jobs=SERVE_N_JOBS)}
    got = chip_smoke.serve_summary(*chip_smoke.serve_regime(P, n_jobs=SERVE_N_JOBS, curve=model))
    inter = rows["train_interference"]
    assert (got["sha256"], got["train_sha256"]) == (inter["sha256"], inter["train_sha256"])
    assert (got["n_slo_met"], got["n_requests"]) == (
        rows["slo_attainment"]["n_slo_met"], rows["slo_attainment"]["n_requests"])
    assert round(got["slo_attainment"], 5) == rows["slo_attainment"]["value"]
    assert round(got["p99_s"], 5) == rows["p99_request_latency_s"]["value"]
    assert round(got["p50_s"], 5) == rows["p99_request_latency_s"]["p50_request_latency_s"]
    assert round(got["train_interference"], 4) == inter["value"]
    assert got["n_preemptions"] == inter["n_preemptions"]
    # the default curve serves every request in time, the card's none
    assert got["slo_attainment"] == (1.0 if model is None else 0.0)
    # unrounded: the same regime through the reference's scheduler
    assert got == chip_smoke.serve_summary(*chip_smoke.serve_regime(R, n_jobs=SERVE_N_JOBS, curve=model))


def test_chip_smoke_restates_the_serve_regime(chip_smoke):
    for name in ("SERVE_JOBS", "SERVE_NUM_SERVERS", "SERVE_SECONDS_PER_JOB", "SERVE_RATE",
                 "SERVE_SLO", "SERVE_GPUS", "SERVE_MAX_REPLICAS", "SERVE_MAX_BATCH"):
        assert getattr(chip_smoke, name) == getattr(sched_scale, name), name
    # the trace, the stream and the policy are held by the digests above
    base = json.loads(chip_smoke.SERVE_BASELINE.read_text())
    assert base["n_jobs"] == chip_smoke.SERVE_JOBS


def _code(source: str) -> str:
    """A module's code without its comments and docstrings: the AST with
    every docstring dropped."""
    tree = ast.parse(source)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


# the code of the copy is the reference's but for the command line's
# program name; the import that leaves the package (scenario.py's
# ``..serve.latency``) is the same text, resolved inside the port
CHANGED = {"scenario": ('prog="python -m repro.core.scenario"',
                        'prog="python -m repro_torch.core.scenario"')}


@pytest.mark.parametrize("module", COPIED)
def test_the_copy_is_the_reference(module):
    """Only comments and docstrings may differ (the copy's drop the
    reference's development history), and the one named change."""
    ref = (REF_DIR / f"{module}.py").read_text()
    port = (PORT_DIR / f"{module}.py").read_text()
    if module in CHANGED:
        old, new = CHANGED[module]
        assert ref.count(old) == 1 and port.count(new) == 1
        ref = ref.replace(old, new)
    assert _code(port) == _code(ref)


def _exports(init: Path) -> dict:
    """Relative module -> names that a package's ``__init__`` imports."""
    out = {}
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            out[node.module] = sorted(a.name for a in node.names)
    return out


def test_port_exports_the_copied_modules():
    want = _exports(REF_DIR / "__init__.py")
    got = _exports(PORT_DIR / "__init__.py")
    assert set(want) - set(got) == set(LEFT_OUT)
    assert got == {m: names for m, names in want.items() if m not in LEFT_OUT}
    assert sorted(p.stem for p in PORT_DIR.glob("*.py")) == sorted(("__init__", *COPIED))


def _port_config():
    """The repo's ``[tool.detlint]`` configuration with every path under
    ``src/repro/core`` moved to ``src/repro_torch/core``, linting the copy
    alone."""
    def moved(value):
        if isinstance(value, str):
            return value.replace("src/repro/core", "src/repro_torch/core")
        if isinstance(value, list):
            return [moved(v) for v in value]
        if isinstance(value, dict):
            return {k: moved(v) for k, v in value.items()}
        return value

    with (ROOT / "pyproject.toml").open("rb") as fh:
        section = tomllib.load(fh)["tool"]["detlint"]
    section = {**moved(section), "paths": ["src/repro_torch/core"]}
    return detlint.config_from_dict({"tool": {"detlint": section}}, root=ROOT)


def test_detlint_on_the_copy(monkeypatch):
    """Zero unsuppressed findings, and each suppressed one pairs with one
    of the reference's at the same rule and function (of the reference's,
    only the left-out modules' have no pair)."""
    monkeypatch.chdir(ROOT)
    ref = detlint.lint_paths(["src/repro/core"], config=detlint.load_config(ROOT / "pyproject.toml"))
    cfg = _port_config()
    assert [a.path for a in cfg.allow] == ["src/repro_torch/core/simulator.py",
                                           "src/repro_torch/core/fleet.py"]
    got = detlint.lint_paths(cfg.paths, config=cfg)
    assert got.n_files == len(COPIED) + 1
    assert got.unsuppressed == [], [(f.path, f.line, f.rule) for f in got.unsuppressed]
    assert ref.unsuppressed == []

    def key(f, prefix):
        return (f.path[len(prefix):], f.rule, f.qualname, f.suppression)

    want = sorted(key(f, "src/repro/core/") for f in ref.findings if f.suppressed
                  and Path(f.path).stem not in LEFT_OUT)
    mine = sorted(key(f, "src/repro_torch/core/") for f in got.findings if f.suppressed)
    assert mine == want and mine
    left = [f for f in ref.findings if f.suppressed and Path(f.path).stem in LEFT_OUT]
    assert len(mine) + len(left) == len([f for f in ref.findings if f.suppressed])
