"""Timed schedule model: blocking semantics, not just launch order.

The port's counterpart of the JAX package's ``analysis/timed_check.py``:
pure Python, replayed against the port's own ``core/scheduler.py``
(``CostModel``, ``TaskSpec``) and ``distributed/fault.py``
(``StepWatchdog``: the replay feeds the priced durations through a fresh
one on a fake clock, so it flags by the watchdog's own rule).

:func:`~.schedule_check.check_schedule` reasons about *order* — which
launch interleavings are reachable.  That model is exact for async
dispatch, where a launched segment never blocks the dispatcher.  The
executor's other two modes block:

* ``mode="timed"`` (implied by ``watchdog=``/``profile=``) dispatches
  the merged order from one thread and **blocks per segment** (the
  lane's stream is synchronized and the watchdog fed a measured
  duration), so a long run of one entry's segments monopolizes dispatch
  — every other entry waits out the whole run;
* ``mode="pool"`` runs one worker per lane dispatching whole entry
  chains; a waiting entry queued behind a long chain is rescued only if
  an idle lane's Eq. 6 steal gate fires (predicted idle — half the
  victim's queued backlog — must exceed the steal cost).

This pass replays the *priced* segment durations (the same perf-model
``cost_s`` the merge used) through those blocking semantics:

* **SCHED003 — blocking-mode starvation** (warning).  A comm-heavy
  entry chain whose priced duration exceeds the watchdog's whole rolling
  window span (``window x median segment duration``) while other entries
  wait: in timed mode any contiguous monopoly run, in pool mode a chain
  whose waiting lane-mates the steal gate provably leaves un-stolen.
  The watchdog cannot see this — it flags slow *segments*, and every
  segment of the chain is individually normal.
* **SCHED004 — watchdog false-flag hazard** (warning).  Replaying the
  priced durations through a ``StepWatchdog`` with the wired one's
  tolerance and window (>= 8 samples, duration > tolerance x rolling
  median, flagged samples excluded from the window) predicts which
  segments a timed run will flag as stragglers *before anything
  executes*.  A predicted flag is schedule-inherent, not a
  fault: operators can pre-set a fresh baseline with ``reset_window()``
  (the same escape hatch degraded-mesh failover uses) instead of paging
  on it.

Both rules are warnings — they describe performance/observability
hazards, not correctness violations — so ``verify="strict"`` never
refuses a queue over them.  Nothing here touches a device.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.scheduler import CostModel, TaskSpec
from ..distributed.fault import StepWatchdog
from .diagnostics import Diagnostic, DiagnosticReport
from .schedule_check import entry_tag

# A chain is "comm-heavy" when at least this fraction of its priced time
# is communication-dominant segments — the overlap the blocking mode
# forfeits is what the co-scheduled entries would have used.
COMM_HEAVY_FRACTION = 0.5


def fresh_watchdog(like: Optional[StepWatchdog] = None) -> StepWatchdog:
    """An empty ``StepWatchdog`` with ``like``'s tolerance and window (a
    default-constructed one's when ``like`` is None)."""
    if like is None:
        return StepWatchdog()
    return StepWatchdog(tolerance=like.tolerance,
                        window=like.durations.maxlen)


def replay_watchdog(durations: Sequence[float],
                    like: Optional[StepWatchdog] = None) -> List[int]:
    """Indices a fresh watchdog (:func:`fresh_watchdog`) flags when each
    of ``durations`` is one step's measured time, read off a fake clock
    that gives every step exactly its duration."""
    stamps: List[float] = []
    wd = fresh_watchdog(like)
    wd.timer = stamps.pop
    for i, d in enumerate(durations):
        stamps[:] = [d, 0.0]          # start() reads 0.0, stop() reads d
        wd.start(i)
        wd.stop()
    return [step for step, _ in wd.flagged]


def _chain_costs(segs: Sequence) -> Tuple[float, float]:
    total = sum(s.cost_s for s in segs)
    comm = sum(s.cost_s for s in segs if s.kind == "comm")
    return total, comm


def _sched003(entry_i: int, entries: Sequence, total: float, comm: float,
              window_span: float, waiting: Sequence[str], why: str,
              hint: str) -> Diagnostic:
    return Diagnostic(
        code="SCHED003", severity="warning",
        message=(f"blocking-mode starvation: entry "
                 f"{entry_tag(entries, entry_i)}'s comm-heavy chain "
                 f"(priced {total:.3g}s, {100.0 * comm / total:.0f}% "
                 f"communication) monopolizes its lane for longer than the "
                 f"watchdog's whole rolling window ({window_span:.3g}s) "
                 f"while {', '.join(waiting)} wait(s); {why}"),
        hint=hint, plan_key=entry_tag(entries, entry_i))


def check_timed_schedule(order: Sequence, entries: Sequence, *,
                         mode: str = "timed", cost_model=None,
                         watchdog: Optional[StepWatchdog] = None
                         ) -> DiagnosticReport:
    """Replay one planned dispatch under blocking semantics.

    ``order``/``entries`` as :func:`~.schedule_check.check_schedule`
    receives them, with segments priced (``cost_s``/``kind`` filled) and
    entries placed (``stream`` filled).  ``mode`` is the *effective*
    dispatch mode: ``"timed"`` for per-segment blocking dispatch (what a
    wired watchdog or ``profile=True`` implies), ``"pool"`` for
    per-lane entry chains with Eq. 6 stealing.  Async dispatch never
    blocks, so the pass returns an empty report for it.  ``watchdog`` is
    the executor's wired ``StepWatchdog``, whose tolerance and window the
    replay takes (a default-constructed one's when None).
    """
    report = DiagnosticReport()
    costs = [s.cost_s for s in order]
    if not costs or mode not in ("timed", "pool"):
        return report
    wd = fresh_watchdog(watchdog)
    window = wd.durations.maxlen
    window_span = window * statistics.median(costs)

    if mode == "timed":
        # SCHED004: the watchdog replay over the exact blocking dispatch
        # sequence (timed mode measures segments in merged order).
        for i in replay_watchdog(costs, wd):
            seg = order[i]
            win_med = statistics.median(costs[max(0, i - window):i])
            report.add(Diagnostic(
                code="SCHED004", severity="warning",
                message=(f"watchdog false-flag hazard: segment {seg.tag} is "
                         f"priced at {seg.cost_s:.3g}s, over "
                         f"{wd.tolerance}x "
                         f"the rolling median of the preceding dispatch "
                         f"(~{win_med:.3g}s) — a timed run will flag it as "
                         f"a straggler even though the duration is "
                         f"schedule-inherent, not a fault"),
                hint="pre-set the baseline with watchdog.reset_window() "
                     "before this queue, raise the tolerance, or re-chunk "
                     "the hop so its priced duration drops",
                plan_key=seg.tag))

        # SCHED003 (timed): any contiguous monopoly run.  Timed dispatch
        # is one blocking thread, so every co-queued entry waits out the
        # whole run — no lane parallelism exists to rescue them.
        if len(entries) >= 2:
            runs: List[Tuple[int, List]] = []
            for seg in order:
                if runs and runs[-1][0] == seg.entry:
                    runs[-1][1].append(seg)
                else:
                    runs.append((seg.entry, [seg]))
            for entry_i, segs in runs:
                total, comm = _chain_costs(segs)
                if total <= window_span or comm < COMM_HEAVY_FRACTION * total:
                    continue
                waiting = [entry_tag(entries, j)
                           for j in range(len(entries)) if j != entry_i]
                report.add(_sched003(
                    entry_i, entries, total, comm, window_span, waiting,
                    why=("timed dispatch blocks per segment, so no other "
                         "entry launches until the chain completes, and no "
                         "single segment crosses the straggler threshold"),
                    hint="use async or pool dispatch for this queue, or "
                         "split the entry so competing entries interleave "
                         "inside the chain"))
        return report

    # mode == "pool": per-lane entry chains.  A waiting entry behind a
    # long chain is rescued only if an idle lane's Eq. 6 steal fires:
    # idle_pred (half the victim's queued backlog) > steal_cost.  The
    # executor submits entry chains with data_bytes=0, so the steal cost
    # is the pure tau_s term.
    if len(entries) < 2:
        return report
    if cost_model is None:
        cost_model = CostModel()
    tau_s = cost_model.steal_cost(TaskSpec(data_bytes=0))
    lanes: Dict[int, List[int]] = {}
    seen = set()
    for seg in order:          # pool arrival order: first appearance wins
        if seg.entry in seen:
            continue
        seen.add(seg.entry)
        lanes.setdefault(getattr(entries[seg.entry], "stream", 0),
                         []).append(seg.entry)
    for lane_entries in lanes.values():
        for k, entry_i in enumerate(lane_entries[:-1]):
            total, comm = _chain_costs(entries[entry_i].segments)
            if total <= window_span or comm < COMM_HEAVY_FRACTION * total:
                continue
            waiting = lane_entries[k + 1:]
            backlog = sum(sum(s.cost_s for s in entries[w].segments)
                          for w in waiting)
            # Another lane exists and stealing the backlog is profitable:
            # the waiting entries get rescued, no starvation.
            if len(lanes) >= 2 and backlog / 2.0 > tau_s:
                continue
            report.add(_sched003(
                entry_i, entries, total, comm, window_span,
                [entry_tag(entries, w) for w in waiting],
                why=(f"the Eq. 6 steal gate leaves them queued (half the "
                     f"backlog, {backlog / 2.0:.3g}s, does not exceed the "
                     f"steal cost {tau_s:.3g}s)" if len(lanes) >= 2 else
                     "no other lane exists to steal them"),
                hint="split the entry, raise n_streams, or lower the cost "
                     "model's steal overhead so idle lanes can steal the "
                     "waiting entries"))
    return report
