"""Closing the prediction loop (paper Sec. IV-C3).

Until this module, the benchmark scenarios ran A-SRPT with effectively
oracle iteration counts: a predictor was consulted once per arrival, but
nothing in the engine reacted when the prediction was *wrong*.  The
paper's headline is prediction-assisted scheduling, and its robustness
story has two halves:

* **Prediction plurality.**  :class:`PredictionModel` wraps any
  :class:`~repro.core.predictor.IterationPredictor` with the run-time
  contract the simulator understands: whether predicted completions
  should be *watched* (``track_overruns``) and how to re-estimate a job
  that ran past its prediction (``reestimate``).  Concrete models:
  :class:`OracleModel` (true iteration counts, nothing watched — the
  legacy engine byte for byte), :class:`OnlineForestModel` (the paper's
  random forest retraining online from completed jobs inside the run on
  a bounded cadence), :class:`ZeroColdStartModel` (every job predicted 0
  — the paper's unseen-job rule taken to its extreme), and
  :class:`NoisyModel` (controlled error injection against the true
  counts: multiplicative lognormal, sign-flipped rank order, cold-start
  fraction).

* **Mid-flight re-estimation with exponential backoff.**  A job whose
  true work exceeds its prediction reaches its *predicted* completion
  while still running.  The simulator fires a predicted-completion check
  there (``simulator._PredCheck``) and asks the policy to re-estimate;
  the default :meth:`PredictionModel.reestimate` is the classic robust
  SRPT-with-predictions move — the new predicted total is
  ``max(elapsed, floor) * backoff_factor`` — so the iterations completed
  between consecutive re-estimates grow geometrically and a job with
  ``n`` true iterations is re-estimated at most
  ``O(log(n / max(floor, n_pred)))`` times regardless of how wrong the
  initial prediction was (property-tested in
  tests/test_prediction_loop.py).  The paper's unseen -> 0 jobs are the
  extreme case: predicted instantly complete, scheduled ASAP, then
  re-estimated 1, 2, 4, ... iterations as they keep running — they
  terminate without ever starving the queue because physical completions
  are always timed with true work; predictions only steer *decisions*
  (release order, delay budgets, migration races).

Error injection is also a first-class fleet axis:
:class:`~repro.core.scenario.PredictionNoisePerturbation` installs a
seeded :class:`NoisyModel` on each fleet variant's policy through the
``Perturbation.perturb_policy`` hook, so the fleet's Monte-Carlo machinery
sweeps prediction-error regimes exactly like it sweeps stragglers.  The
``sched_scale --predict`` benchmark turns the flow-time-vs-oracle ratios
into a CI-gated number (benchmarks/README.md).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .job import JobSpec
from .predictor import (
    IterationPredictor,
    PerfectPredictor,
    RandomForestPredictor,
)

BACKOFF_FACTOR_DEFAULT = 2.0
# New predicted totals never shrink below this many iterations: it is the
# first re-estimate of a 0-predicted (unseen) job and the growth floor
# that makes the backoff terminate in O(log n) steps.
BACKOFF_FLOOR_DEFAULT = 1.0


class PredictionModel(IterationPredictor):
    """An :class:`IterationPredictor` plus the run-time prediction-loop
    contract.

    ``track_overruns`` is what the policies forward to the simulator
    (``Policy.track_overruns``): when truthy, every start carries its
    predicted iteration count (``Allocation.n_pred``) and the simulator
    watches for the job running past ``start + n_pred * alpha``; when
    false the engine runs the pre-prediction-loop event sequence byte
    for byte (the golden fixtures pin this — an ``OracleModel`` or a
    plain unwrapped predictor is bit-identical to the legacy engine).

    The base class is a transparent pass-through over ``base``: wrapping
    any predictor with ``track_overruns=False`` changes nothing
    observable (tests/test_prediction_loop.py holds that against all 10
    golden schedules).
    """

    def __init__(
        self,
        base: IterationPredictor,
        track_overruns: bool = True,
        backoff_factor: float = BACKOFF_FACTOR_DEFAULT,
        backoff_floor: float = BACKOFF_FLOOR_DEFAULT,
    ):
        if backoff_factor <= 1.0:
            raise ValueError(
                f"backoff_factor must exceed 1.0 for the re-estimation "
                f"loop to terminate, got {backoff_factor}"
            )
        if backoff_floor <= 0.0:
            raise ValueError(
                f"backoff_floor must be positive, got {backoff_floor}"
            )
        self.base = base
        self.track_overruns = track_overruns
        self.backoff_factor = backoff_factor
        self.backoff_floor = backoff_floor

    def observe(self, job: JobSpec, true_iters: int) -> None:
        self.base.observe(job, true_iters)

    def predict(self, job: JobSpec) -> float:
        return self.base.predict(job)

    def reestimate(self, job: JobSpec, elapsed_iters: float) -> float:
        """New predicted *total* iterations for a job that has completed
        ``elapsed_iters`` and run past its last prediction.

        Exponential backoff on the elapsed work: each re-estimate at
        least multiplies the implied remaining-work window by
        ``backoff_factor - 1`` of the elapsed, so consecutive checks are
        geometrically spaced and the count is logarithmic in the true
        iteration count.  Subclasses may consult fresher model state
        instead, as long as the returned total strictly exceeds
        ``elapsed_iters`` (the simulator clamps pathological answers).
        """
        return max(elapsed_iters, self.backoff_floor) * self.backoff_factor


class OracleModel(PredictionModel):
    """True iteration counts, no overrun watching: the engine's event
    sequence — and therefore every schedule digest — is byte-identical
    to the pre-prediction-loop engine (the ``--predict`` benchmark's
    ratio-1.0 baseline)."""

    def __init__(self) -> None:
        super().__init__(PerfectPredictor(), track_overruns=False)


class OnlineForestModel(PredictionModel):
    """The paper's random-forest predictor, retrained *inside* the run.

    Wraps :class:`~repro.core.predictor.RandomForestPredictor`: every
    completed job feeds ``observe`` (recurrence is the paper's key
    observation), the forest refits every ``retrain_every`` completions
    over a ``max_history``-bounded window (bounded cadence *and* bounded
    cost on long streams), and unseen jobs predict 0 per the paper —
    the backoff re-estimator is what keeps those from being scheduling
    landmines.
    """

    def __init__(
        self,
        seed: int = 0,
        retrain_every: int = 300,
        n_estimators: int = 50,
        max_history: Optional[int] = 20_000,
        backoff_factor: float = BACKOFF_FACTOR_DEFAULT,
        backoff_floor: float = BACKOFF_FLOOR_DEFAULT,
    ):
        super().__init__(
            RandomForestPredictor(
                seed=seed,
                retrain_every=retrain_every,
                n_estimators=n_estimators,
                max_history=max_history,
            ),
            track_overruns=True,
            backoff_factor=backoff_factor,
            backoff_floor=backoff_floor,
        )

    def warm_start(self) -> None:
        """Force a fit on everything observed so far (paper Sec. V-A.1-c)."""
        self.base.warm_start()


class ZeroColdStartModel(PredictionModel):
    """Every job predicted 0 — the unseen-job rule with no learning.

    The worst case the acceptance criterion names: all jobs release ASAP
    in arrival order (zero virtual work), every job overruns
    immediately, and the backoff re-estimator alone bounds the check
    count.  ``observe`` is deliberately a no-op.
    """

    def __init__(
        self,
        backoff_factor: float = BACKOFF_FACTOR_DEFAULT,
        backoff_floor: float = BACKOFF_FLOOR_DEFAULT,
    ):
        super().__init__(
            _ZeroPredictor(),
            track_overruns=True,
            backoff_factor=backoff_factor,
            backoff_floor=backoff_floor,
        )


class _ZeroPredictor(IterationPredictor):
    def observe(self, job: JobSpec, true_iters: int) -> None:
        pass

    def predict(self, job: JobSpec) -> float:
        return 0.0


NOISE_MODES = ("lognormal", "rankflip", "coldstart")


class NoisyModel(PredictionModel):
    """Controlled prediction-error injection against the true counts.

    Three error regimes (``mode``):

    * ``"lognormal"`` — multiplicative lognormal noise,
      ``pred = true * exp(N(0, sigma^2))``: median-unbiased, heavy
      two-sided relative error (the realistic drift regime of
      arXiv 2109.01313).
    * ``"rankflip"`` — sign-flipped rank order, ``pred = scale^2 /
      max(true, 1)``: long jobs predicted short and short jobs long —
      adversarial for any SRPT-family policy, since the *ordering* is
      exactly inverted while the magnitude stays plausible.
    * ``"coldstart"`` — a ``cold_frac`` fraction of jobs predicted 0
      (the paper's unseen-job rule hitting a random subset), the rest
      exact.

    Noise is a pure function of ``(seed, job_id)`` — each job draws from
    ``numpy.random.default_rng([seed, job_id])`` — so predictions are
    deterministic and independent of call order / call count, which
    keeps noisy schedules replayable and fleet variants a pure function
    of the fleet seed.
    """

    def __init__(
        self,
        mode: str = "lognormal",
        sigma: float = 0.5,
        cold_frac: float = 0.3,
        scale: float = 400.0,
        seed: int = 0,
        backoff_factor: float = BACKOFF_FACTOR_DEFAULT,
        backoff_floor: float = BACKOFF_FLOOR_DEFAULT,
    ):
        if mode not in NOISE_MODES:
            raise ValueError(
                f"unknown noise mode {mode!r} (one of {NOISE_MODES})"
            )
        if not 0.0 <= cold_frac <= 1.0:
            raise ValueError(f"cold_frac must be in [0, 1], got {cold_frac}")
        super().__init__(
            PerfectPredictor(),
            track_overruns=True,
            backoff_factor=backoff_factor,
            backoff_floor=backoff_floor,
        )
        self.mode = mode
        self.sigma = sigma
        self.cold_frac = cold_frac
        self.scale = scale
        self.seed = seed

    def observe(self, job: JobSpec, true_iters: int) -> None:
        pass  # the injected error never "learns" away

    def predict(self, job: JobSpec) -> float:
        true = float(job.n_iters)
        if self.mode == "rankflip":
            return self.scale * self.scale / max(true, 1.0)
        rng = np.random.default_rng([self.seed, job.job_id])
        if self.mode == "coldstart":
            return 0.0 if rng.random() < self.cold_frac else true
        return true * float(np.exp(rng.normal(0.0, self.sigma)))


def make_prediction_model(kind: str, seed: int = 0, **kw) -> PredictionModel:
    """Factory mirroring ``predictor.make_predictor`` for the run-time
    models: ``oracle`` / ``forest`` / ``zero`` / ``lognormal`` /
    ``rankflip`` / ``coldstart``."""
    if kind == "oracle":
        return OracleModel()
    if kind == "forest":
        return OnlineForestModel(seed=seed, **kw)
    if kind == "zero":
        return ZeroColdStartModel(**kw)
    if kind in NOISE_MODES:
        return NoisyModel(kind, seed=seed, **kw)
    raise ValueError(f"unknown prediction model kind {kind!r}")
