"""Static verification for the port's plan/executor stack.

The port's counterpart of the JAX package's ``analysis/``: five static
passes plus one runtime cross-check, all reporting through one
structured, JSON-dumpable :class:`Diagnostic` stream (:mod:`.diagnostics`
— deduplicated across passes, deterministic JSON ordering):

* :mod:`.schedule_check` — model-checks a ``PlanStreamExecutor``'s
  planned dispatch against the orders its dispatch mode can reach
  (launch *order*: under the executor's turns one order, the planned
  merge, on every rank);
* :mod:`.provenance` — storage-identity alias analysis over the same
  queue (views that are ``is``-distinct but share a storage, operands a
  donation already emptied) plus the shared-plan donation audit surfaced
  through ``DistributedFFT.verify()``;
* :mod:`.timed_check` — replays perf-model-priced segment durations
  through the blocking dispatch semantics (timed mode's per-segment
  blocking, the pool's Eq. 6 steal-vs-block gate, the ``StepWatchdog``
  flag window);
* :mod:`.contracts` — checks a plan's segment chain against the sharding
  contracts the pipeline relies on (boundary layout equality via
  independent hop replay, chunk-schedule divisibility, plan-key collision
  audit);
* :mod:`.lint` — AST-based repo-specific rules for the port, runnable as
  ``python -m repro_torch.analysis.lint``;
* :mod:`.sanitize` — the differential sanitizer:
  ``PlanStreamExecutor(sanitize=True)`` records the actual launch order
  and buffer donations, and :func:`diff_trace` diffs the trace against
  the static model, and on several ranks each rank's order against the
  others' — "the verifier models the executor" is a tested invariant,
  not an assumption.

Nothing here imports JAX or the JAX package.

Rule codes
----------
========  ========  =====================================================
code      severity  meaning
========  ========  =====================================================
SCHED001  error     pool-mode cross-lane collective-ordering deadlock
                    reachable (dispatch without turns)
SCHED002  error     an entry's segments dispatched out of index order /
                    not exactly once
SCHED003  warning   blocking-mode starvation: a comm-heavy entry chain
                    monopolizes a lane past the watchdog window while
                    other entries wait (steal-gated in pool mode)
SCHED004  warning   watchdog false-flag hazard: a statically predictable
                    straggler (priced duration over tolerance x rolling
                    median) — pre-set ``reset_window()`` baselines
DON001    error     cross-entry use-after-donate (same operand object)
DON002    error     donation against a shared (wrapper-memoized) plan,
                    or a shared plan holding donating segment variants
ALIAS001  error     one operand object donated by two entries
ALIAS002  error     view-aliased donation across entries (is-distinct
                    tensors over one storage)
ALIAS003  error     operand already emptied (donated by an earlier run
                    and re-submitted)
CON001..5 error     sharding-contract violations (boundary layout replay,
                    chunk/grid divisibility, plan/wisdom key collisions)
REP000..4 error     repro-lint for the port (syntax, compat-shimmed torch
                    APIs, injectable timers, locked wisdom writes, bounded
                    caches)
SAN001    error     sanitizer divergence: an instrumented run did not
                    match the static model (order, coverage, donation
                    provenance, or the order of another rank)
========  ========  =====================================================
"""
from .diagnostics import (Diagnostic, DiagnosticReport,
                          PlanVerificationError)
from .contracts import audit_plan_keys, check_plan
from .schedule_check import check_schedule
from .provenance import (buffers_alias, check_plan_buffers,
                         check_provenance, expected_donations)
from .timed_check import check_timed_schedule, replay_watchdog
from .sanitize import ExecutionTrace, diff_ranks, diff_trace, trace_json

__all__ = [
    "Diagnostic", "DiagnosticReport", "PlanVerificationError",
    "check_plan", "audit_plan_keys", "check_schedule",
    "buffers_alias", "check_plan_buffers", "check_provenance",
    "expected_donations",
    "check_timed_schedule", "replay_watchdog",
    "ExecutionTrace", "diff_ranks", "diff_trace", "trace_json",
]
