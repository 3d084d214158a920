"""simlint: AST-based invariant linting for this repository.

Every correctness guarantee the reproduction rests on — same-seed
bit-identity, golden-trace byte-stability, engine-vs-ledger billing
parity — is enforced *after the fact* by runtime tests. This package
moves the recurring failure classes to review time with four static
passes over the source tree:

- **determinism** (:mod:`repro_torch.analysis.determinism`): global-state
  ``random``/``np.random`` draws, wall-clock reads (``time.time``,
  ``datetime.now``), raw ``np.random.RandomState`` construction outside
  each package's ``core.rng``, and iteration over ``set``/``dict.keys()``
  in the event-scheduling layers (``serverless``/``workflow``), where
  ordering feeds event schedules, traces, and hashes.
- **billing units** (:mod:`repro_torch.analysis.units`): suffix-based
  dimension inference (``_s``, ``_gbps``, ``_mb``/``_gb``, ``_usd``,
  ``_ev``) flagging arithmetic that mixes incompatible units and
  unconverted cross-unit assignments — the static version of the
  keep-alive parity bugs.
- **trace/event coverage** (:mod:`repro_torch.analysis.coverage`): every
  literal kind passed to ``TraceEvent(...)`` must be declared in
  ``TraceEvent.KINDS`` and every declared kind must be emitted
  somewhere (the typo class, both directions), and every event
  pushed at a ``CalendarQueue``/``ContentionDomain`` must name a
  handler that resolves to a function defined in the module.
- **API misuse** (:mod:`repro_torch.analysis.api`): ``seed``-taking code that
  constructs fresh *unseeded* RNGs, and mutation of frozen-dataclass
  fields outside ``dataclasses.replace`` /  the owning class.

Run it over the repository (the JAX package's copy is the one CI runs)::

    python -m repro_torch.analysis.lint src/ benchmarks/ examples/ --fail-on warning

Findings carry ``file:line``, a rule id, and a message. A finding is
suppressed with an inline comment carrying a written reason::

    t0 = time.time()  # simlint: ok(det-wallclock, operator-facing log stamp)

A suppression without a reason is itself an error. See
docs/STATIC_ANALYSIS.md for the rule catalogue and policy.

The port's copy of the JAX package's ``analysis`` package: the same
passes and rules, with the path-scoped determinism rules widened to the
port's own package (``repro_torch/...``) as well as ``repro/...``.
"""
from repro_torch.analysis.core import Finding, Linter, RULES, lint_paths

__all__ = ["Finding", "Linter", "RULES", "lint_paths"]
