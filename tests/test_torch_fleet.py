"""The port's ``repro_torch.core.fleet`` against the reference's pinned
results: ``run_fleet`` at the CI regime of benchmarks/sched_scale.py
(``sched_scale_fleet``: 300 jobs on the 16-server mixed cluster, 3 x 12 s
of horizon a job, 3 stragglers, 2 elastic servers, arrival jitter of
sigma 60 s, migrating A-SRPT without refine_mapping, 64 variants, seed 0)
gives every per-variant digest and the ``fleet_digest`` of
benchmarks/BENCH_fleet_baseline.json; ``chip_smoke.py``'s restatement of
that regime equals ``sched_scale``'s; and, as tests/test_fleet.py holds
the reference, the shared-cache fleet equals the sequential path and
plain ``simulate`` on every golden scenario, and is a pure function of
its seed.  ``exact_min_cut`` gives the reference's cut and assignment on
tests/test_ilp.py's graphs."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

pytestmark = pytest.mark.sched
pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from benchmarks import sched_scale  # noqa: E402
from repro.core.graph import JobGraph as RJobGraph  # noqa: E402
from repro.core.ilp import exact_min_cut as r_min_cut  # noqa: E402
from repro_torch.core import scenario as p_scenario  # noqa: E402
from repro_torch.core.fleet import fleet_variants  # noqa: E402
from repro_torch.core.graph import JobGraph as PJobGraph  # noqa: E402
from repro_torch.core.ilp import exact_min_cut as p_min_cut  # noqa: E402

import test_golden as G  # noqa: E402
import test_torch_sched as S  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BASELINE = ROOT / "benchmarks" / "BENCH_fleet_baseline.json"


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fleet_reproduces_the_ci_baseline(chip_smoke):
    want = json.loads(BASELINE.read_text())
    fr = chip_smoke.fleet_regime(P)
    assert (want["n_variants"], want["seed"]) == (chip_smoke.FLEET_VARIANTS, chip_smoke.FLEET_SEED)
    assert [v.digest for v in fr.variants] == want["digests"]
    assert fr.digest() == want["fleet_digest"]
    assert fr.to_dict()["digests"] == want["digests"]


def test_chip_smoke_restates_the_fleet_regime(chip_smoke):
    assert chip_smoke.FLEET_VARIANTS == sched_scale.FLEET_VARIANTS_DEFAULT
    assert chip_smoke.FLEET_JOBS == sched_scale.FLEET_JOBS
    assert chip_smoke.FLEET_NUM_SERVERS == sched_scale.FLEET_NUM_SERVERS
    assert chip_smoke.FLEET_SECONDS_PER_JOB == sched_scale.FLEET_SECONDS_PER_JOB
    base, perts, policy = chip_smoke.fleet_inputs(R)
    assert base.to_dict() == sched_scale._fleet_base().to_dict()
    assert [repr(p) for p in perts] == [repr(p) for p in sched_scale._fleet_perturbations()]
    got, ref = policy(), sched_scale._fleet_policy()
    for key in ("tau", "refine_mapping", "migrate"):
        assert getattr(got, key) == getattr(ref, key), key
    assert type(got.predictor).__name__ == type(ref.predictor).__name__
    # the port's inputs are the reference's
    pbase, pperts, _ = chip_smoke.fleet_inputs(P)
    assert pbase.to_dict() == base.to_dict()
    assert [repr(p) for p in pperts] == [repr(p) for p in perts]


def _perturbations(core):
    return (core.StragglerPerturbation(n_stragglers=2), core.ElasticPerturbation(n_servers=1),
            core.ArrivalJitterPerturbation(sigma=30.0))


@pytest.mark.parametrize("name", sorted(G.SCENARIOS))
def test_fleet_matches_sequential_on_goldens(name):
    """tests/test_fleet.py's check in the port: the shared-cache,
    prewarmed fleet equals the sequential fleet and plain ``simulate``,
    variant for variant."""
    cluster_fn, _, kwargs = G.SCENARIOS[name]
    jobs = p_scenario.jobs_from_dicts(json.loads(G.TRACE_PATH.read_text()))
    base = P.scenario_from_legacy(
        jobs, S._port_cluster(cluster_fn()), faults=kwargs.get("faults"),
        degradations=kwargs.get("degradations"), name=f"golden:{name}")
    policy = S.PORT_POLICIES[name]
    perts = _perturbations(P)
    fleet = P.run_fleet(base, policy, perts, 2, seed=3)
    seq = P.run_fleet(base, policy, perts, 2, seed=3, share=False, prewarm=False)
    assert [v.digest for v in fleet.variants] == [v.digest for v in seq.variants], name
    assert fleet.digest() == seq.digest()
    for (_i, variant), v in zip(fleet_variants(base.materialize(), perts, 2, seed=3), seq.variants):
        assert P.simulate(variant, policy(), validate=False).schedule_digest() == v.digest, name


def test_fleet_matches_the_reference_and_its_seed():
    jobs = json.loads(G.TRACE_PATH.read_text())[:80]

    def run(core, seed):
        from importlib import import_module

        sc = import_module(core.__name__ + ".scenario")
        base = core.Scenario(jobs=tuple(sc.jobs_from_dicts(jobs)), cluster=core.ClusterSpec(
            num_servers=8, gpus_per_server=4, b_inter=1.25e9, b_intra=300e9), name="det")
        mk = lambda: core.ASRPTPolicy(core.make_predictor("mean"), tau=2.0,  # noqa: E731
                                      refine_mapping=True, migrate=True)
        return core.run_fleet(base, mk, _perturbations(core), 4, seed=seed)

    a, b = run(P, 7), run(P, 7)
    assert a.digest() == b.digest() and a.stats == b.stats
    assert run(P, 8).digest() != a.digest()
    ref = run(R, 7)
    assert [v.digest for v in a.variants] == [v.digest for v in ref.variants]
    assert a.digest() == ref.digest() and a.to_dict()["stats"] == ref.to_dict()["stats"]


def _graphs():
    """tests/test_ilp.py's graphs: its two cliques, and 50 random graphs
    drawn as its property test draws them (2-8 vertices, each edge with
    probability 1/2 and weight in [0.1, 100], 1-3 parts)."""
    yield ([(0, i) for i in range(4)],
           {((0, 0), (0, 1)): 100.0, ((0, 2), (0, 3)): 100.0, ((0, 1), (0, 2)): 1.0},
           [(0, 2), (1, 2)])
    rng = np.random.default_rng(0)
    for _ in range(50):
        n = int(rng.integers(2, 9))
        vertices = [(0, i) for i in range(n)]
        edges = {((0, i), (0, j)): float(rng.uniform(0.1, 100.0))
                 for i in range(n) for j in range(i + 1, n) if rng.random() < 0.5}
        n_parts = int(rng.integers(1, min(3, n) + 1))
        sizes = [1] * n_parts
        for _ in range(n - n_parts):
            sizes[int(rng.integers(0, n_parts))] += 1
        yield vertices, edges, list(enumerate(sizes))


def test_exact_min_cut_matches_the_reference():
    for vertices, edges, caps in _graphs():
        want = r_min_cut(RJobGraph(vertices, edges), caps)
        got = p_min_cut(PJobGraph(vertices, edges), caps)
        assert got == want, (vertices, edges, caps)
