"""repro_torch.analysis: static analysis for the scheduling core (the
port's copy of the JAX package's ``repro.analysis``, which lints
``repro_torch.core`` as the reference lints ``repro.core``).

The schedules this repo gates on (golden sha256s, fleet digests, the
serve/streaming fast paths) are bit-identical across runs and machines
only because the core follows a handful of conventions — explicit
``default_rng([seed, ...])`` substreams, no observable set-iteration
order, Shewchuk-partials accumulation in digest-bearing aggregates, a
virtual-time-only event loop.  This package checks those conventions
*statically*, before a golden fixture ever has to fail:

* :mod:`repro_torch.analysis.detlint` — the determinism linter (rules
  DET001-DET007) plus the pluggable AST rule engine it is built on.
  CLI: ``python -m repro_torch.analysis.detlint [paths] --format=text|json|github``.
* :mod:`repro_torch.analysis.policy_rules` — a second pass on the same
  walker: ``SchedulingPolicy`` dispatch-contract and frozen-dataclass
  invariants (rules POL001/POL002).

The invariants themselves are documented in ``docs/DETERMINISM.md``,
each cross-referenced to its rule id.

(Import :mod:`repro_torch.analysis.detlint` directly — the package init stays
empty so ``python -m repro_torch.analysis.detlint`` does not double-import
the module it is about to execute.)
"""
