"""Differential sanitizer: diff an instrumented run against the static model.

The port's counterpart of the JAX package's ``analysis/sanitize.py``.
The static passes (:mod:`.schedule_check`, :mod:`.provenance`,
:mod:`.timed_check`) are only as good as their model of the executor.
``PlanStreamExecutor(sanitize=True)`` turns one run into a test of that
model: the executor records an :class:`ExecutionTrace` — every segment
launch, recorded under the dispatch lock with its turn (order, dispatch
timestamps from the executor's injectable ``timer``, measured walls in
timed runs) and the fate of every buffer it fed a segment, read just
after the launch that consumed it (the trace holds no tensor) — and
:func:`diff_trace` diffs the trace against what the static model says
is reachable:

* **launch order** — every mode must launch exactly the planned merge.
  The JAX package lets its pool mode launch any merge that preserves
  each entry's segment chain, because one JAX process enqueues every
  device's work under one lock.  The port is multi-controller: each rank
  launches its own collectives, and only the turn counter of
  ``PlanStreamExecutor._dispatch`` keeps the collective order the same
  on every rank, by making pool workers too launch the planned merge
  verbatim.  So the single-order branch of the diff holds for pool mode
  too: a pool run that launched another merge has lost the invariant
  that keeps NCCL from hanging;
* **donation provenance** — after the run, every buffer the executor fed
  a segment is checked against the provenance model's donation table
  (:func:`~.provenance.expected_donations`): a caller operand must be
  emptied iff the entry donated, an interior boundary buffer iff the
  executor double-buffers.  ``pipeline.release`` marks what it empties,
  so ``pipeline.released`` is ground truth;
* **coverage** — every planned segment launched exactly once, none
  invented;
* **the same order on every rank** — on a mesh of several ranks the
  executor all-gathers each rank's ``(entry, index)`` launch order over
  the mesh's process group after the run (:func:`diff_ranks`): the
  multi-controller form of the order check.  Only a run that returned
  makes that gather: a rank that raised makes none, and its peers wait
  in it as they would in the run's next collective.

Any divergence is a **SAN001** diagnostic: the verifier's model of the
executor is wrong (or the executor regressed), and every static verdict
built on that model is suspect.  Per-segment walls ride along in the
trace JSON for operators but never produce SAN001 — wall clocks are
machine noise, order and provenance are not.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .diagnostics import Diagnostic, DiagnosticReport
from .schedule_check import entry_tag


@dataclasses.dataclass
class TraceEvent:
    """One observed segment launch."""
    entry: int
    index: int
    tag: str
    turn: int                     # position in the planned merge it held
    t_dispatch_s: float           # executor timer at launch
    wall_s: float = 0.0           # measured duration (timed runs only)


@dataclasses.dataclass
class BufferRecord:
    """One buffer the executor fed a segment, and its observed fate."""
    tag: str                      # segment tag that consumed this buffer
    role: str                     # "operand" | "interior"
    expect_deleted: bool          # the provenance model's donation table
    deleted: Optional[bool] = None  # observed after the run


@dataclasses.dataclass
class ExecutionTrace:
    """Everything one instrumented run observed."""
    mode: str                     # effective dispatch mode of the run
    events: List[TraceEvent] = dataclasses.field(default_factory=list)
    buffers: List[BufferRecord] = dataclasses.field(default_factory=list)

    def launch_order(self) -> List[Tuple[int, int]]:
        """The ``(entry, index)`` launch order, what ranks compare."""
        return [(e.entry, e.index) for e in self.events]

    def to_json(self) -> Dict[str, Any]:
        return {
            "mode": self.mode,
            "events": [dataclasses.asdict(e) for e in self.events],
            "buffers": [dataclasses.asdict(b) for b in self.buffers],
        }


def _san(message: str, hint: str, key: str) -> Diagnostic:
    return Diagnostic(code="SAN001", severity="error", message=message,
                      hint=hint, plan_key=key)


def _first_difference(a: Sequence, b: Sequence) -> int:
    """The first position where two launch orders differ."""
    return next((p for p, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def diff_trace(trace: ExecutionTrace, order: Sequence,
               entries: Sequence) -> DiagnosticReport:
    """Diff one observed trace against the planned dispatch it ran.

    ``order``/``entries`` are the *model* — the planned dispatch order
    the static passes verified (not whatever the executor actually did).
    """
    report = DiagnosticReport()
    planned: List[Tuple[int, int]] = [(s.entry, s.index) for s in order]
    observed = trace.launch_order()

    # Coverage + per-entry chain order (a dependency-chain violation in
    # any mode).
    per_entry: Dict[int, List[int]] = {}
    for ent, idx in observed:
        per_entry.setdefault(ent, []).append(idx)
    for i, e in enumerate(entries):
        want = list(range(len(e.segments)))
        got = per_entry.get(i, [])
        if got != want:
            tag = entry_tag(entries, i)
            report.add(_san(
                f"entry {tag}: executor launched segment indices {got}, the "
                f"model requires {want} (each exactly once, in index "
                f"order) — each segment reads the boundary buffer the "
                f"previous one wrote",
                "the executor diverged from the schedule model; fix the "
                "dispatch loop or update the model before trusting static "
                "verdicts", tag))

    # Every mode launches the planned merge verbatim: the turn order.
    if observed != planned:
        k = _first_difference(observed, planned)
        o_tag = (trace.events[k].tag if k < len(trace.events)
                 else "<missing>")
        m_tag = order[k].tag if k < len(order) else "<none>"
        report.add(_san(
            f"{trace.mode}-mode launch order diverges from the planned "
            f"dispatch order at position {k}: launched {o_tag!r}, model "
            f"says {m_tag!r} ({len(observed)} observed vs {len(planned)} "
            f"planned launches)",
            "every mode must launch the planned merge verbatim (the turn "
            "order keeps the collective order equal on every rank); the "
            "single-order model (and SCHED001's argument) is unsound "
            "otherwise", f"{trace.mode}@{k}"))

    # Donation provenance: observed buffer fates vs the model's table.
    for rec in trace.buffers:
        if rec.deleted is None or rec.deleted == rec.expect_deleted:
            continue
        want = "donated (emptied)" if rec.expect_deleted else "live"
        got = "emptied" if rec.deleted else "live"
        report.add(_san(
            f"buffer fed to {rec.tag} ({rec.role} input): the provenance "
            f"model expects it {want} after the run, the runtime left it "
            f"{got}",
            "the donation model (DON001/ALIAS002's foundation) diverged "
            "from the segments run; check the donate_input/"
            "donate_intermediates plumbing", rec.tag))
    return report


def diff_ranks(orders: Sequence[Sequence[Tuple[int, int]]],
               rank: int) -> DiagnosticReport:
    """SAN001 when the ranks of one mesh launched different orders.

    ``orders[r]`` is mesh position ``r``'s ``(entry, index)`` launch order
    (all-gathered after the run); ``rank`` is this rank's position.  On
    NCCL a difference in the collective segments hangs; a difference
    anywhere means the ranks did not run one schedule.
    """
    report = DiagnosticReport()
    mine = [tuple(o) for o in orders[rank]]
    for r, theirs in enumerate(orders):
        theirs = [tuple(o) for o in theirs]
        if r == rank or theirs == mine:
            continue
        k = _first_difference(mine, theirs)
        report.add(_san(
            f"mesh ranks {rank} and {r} launched different segment orders: "
            f"first difference at position {k} ({len(mine)} vs "
            f"{len(theirs)} launches) — their collectives rendezvous out "
            f"of order",
            "every rank must plan the same queue (same submits in the same "
            "order, same executor knobs) and launch it in turn order",
            f"ranks@{k}"))
    return report


def trace_json(trace: Optional[ExecutionTrace],
               report: Optional[DiagnosticReport]) -> Dict[str, Any]:
    """The trace-diff artifact CI uploads: observed trace + SAN001 diff."""
    diags = list(report) if report is not None else []
    return {
        "trace": trace.to_json() if trace is not None else None,
        "diff": {
            "count": len(diags),
            "san001": sum(1 for d in diags if d.code == "SAN001"),
            "diagnostics": [d.to_dict() for d in diags],
        },
    }
