"""Model-check a PlanStreamExecutor's planned dispatch — before it runs.

The port's counterpart of the JAX package's ``analysis/schedule_check.py``.
The executor's :meth:`~repro_torch.core.executor.PlanStreamExecutor.
_plan_schedule` prices, places and orders the queue *without executing
anything*, so the chosen dispatch order plus the dispatch mode fully
determine which launch interleavings are reachable at run time.  This
pass checks those interleavings statically.

**The port's model.**  The port is multi-controller: every rank launches
its own NCCL (or gloo) collectives, and a rank's launch order is what
its collectives rendezvous in.  With ``serialize_dispatch=True`` (the
default) every launch waits for its *turn*, its position in the planned
merge, under the dispatch lock (``PlanStreamExecutor._dispatch``).  Every
rank computes the same merge, so the reachable set is one interleaving,
the planned one, in *every* mode, pool included: the checker models that
single order, and SCHED001 cannot fire.  With ``serialize_dispatch=False``
pool workers would launch without turns, so every chain-preserving merge
of the entries' chains is reachable on each rank independently, as in
the JAX package's model of its lock-free pool.  The executor never
launches that setting: ``run()`` checks such a queue and refuses it with
the report, before any launch.

* **SCHED001 — cross-lane collective-ordering deadlock.**  Every segment
  with ``index >= 1`` holds the hop's ``all_to_all`` collectives over the
  mesh.  Unserialized pool dispatch: entries' chains are independent, so
  two collectives of different chains are reachable in both orders, and
  two of one chain never are (:func:`racy_collective_pairs`).  On NCCL
  such a pair hangs the ranks that launched it in different orders;
  nothing raises.
* **DON001 — cross-entry use-after-donate.**  An entry submitted with
  ``donate=True`` gives up its operand at segment 0.  If another entry was
  submitted with the *same* tensor, a reachable order that runs the
  donating segment 0 first hands the other entry an emptied operand.
* **DON002 — donation on a shared plan** (wrapper-memoized plans refuse
  donation; re-checked here so a verify pass catches plans whose
  ``shared`` flag was set after submit).
* **ALIAS001 — double donation**: one tensor donated by two entries is
  wrong in every order.
* **SCHED002 — per-entry segment-order violation**: each entry's segments
  must appear exactly once, in index order, in the dispatch order (each
  segment reads the boundary buffer the previous one wrote).
* **ALIAS002 / ALIAS003** (via :mod:`.provenance`): the storage-identity
  versions of the donation rules — DON001/ALIAS001 compare operands with
  ``is``, which misses ``is``-distinct views of one storage and operands
  that an earlier donation already emptied.

All findings are :class:`~.diagnostics.Diagnostic` records; nothing here
touches a device (the provenance pass reads storage pointers, it never
moves memory).
"""
from __future__ import annotations

from itertools import combinations
from typing import Dict, List, Sequence, Tuple

from .diagnostics import Diagnostic, DiagnosticReport


def entry_tag(entries: Sequence, i: int) -> str:
    """Entry ``i``'s tag (``entry<i>`` when it has none)."""
    tag = getattr(entries[i], "tag", None)
    return tag if tag else f"entry{i}"


def racy_dispatch(mode: str, serialized: bool) -> bool:
    """Whether more than the planned order is reachable: only pool workers
    launching without turns (``serialize_dispatch=False``) race."""
    return mode == "pool" and not serialized


def racy_collective_pairs(chains: Sequence[Sequence[str]]
                          ) -> List[Tuple[str, str]]:
    """Collective pairs reachable in both launch orders when each chain
    keeps its own order and nothing else orders them: every pair of tags
    from two different chains (the reachable merges of a union of chains
    order no two elements of different chains)."""
    pairs = {(a, b) if a <= b else (b, a)
             for ci, cj in combinations([c for c in chains if c], 2)
             for a in ci for b in cj}
    return sorted(pairs)


# -- the checker -------------------------------------------------------------

def check_schedule(order: Sequence, entries: Sequence, *,
                   mode: str = "async",
                   serialized: bool = True) -> DiagnosticReport:
    """Statically verify one planned dispatch.

    ``order`` is the executor's merged dispatch order (``SegmentTask``
    records) and ``entries`` the queue it was planned from (objects with
    ``plan`` / ``x`` / ``donate`` / ``tag`` / ``segments``).  ``mode`` and
    ``serialized`` describe how the executor would launch it.
    """
    report = DiagnosticReport()

    # SCHED002: each entry's segments exactly once, in index order.
    per_entry: Dict[int, List[int]] = {}
    for seg in order:
        per_entry.setdefault(seg.entry, []).append(seg.index)
    for i, entry in enumerate(entries):
        want = list(range(len(entry.segments)))
        got = per_entry.get(i, [])
        if got != want:
            report.add(Diagnostic(
                code="SCHED002", severity="error",
                message=(f"entry {entry_tag(entries, i)}: dispatch order "
                         f"visits segments {got}, expected {want} (each "
                         f"exactly once, in index order)"),
                hint="segment chains are dependency chains; do not reorder "
                     "or duplicate an entry's segments across lanes",
                plan_key=entry_tag(entries, i)))

    # DON002: donation against a shared plan.
    for i, entry in enumerate(entries):
        if entry.donate and getattr(entry.plan, "shared", False):
            report.add(Diagnostic(
                code="DON002", severity="error",
                message=(f"entry {entry_tag(entries, i)} donates its "
                         f"operand to a shared (wrapper-memoized) plan"),
                hint="build a private plan via plan_fft for donation, or "
                     "submit with donate=False",
                plan_key=entry_tag(entries, i)))

    # ALIAS001 / DON001: operand identity against donation.
    racy = racy_dispatch(mode, serialized)
    donors = [i for i, e in enumerate(entries) if e.donate]
    for a, b in combinations(donors, 2):
        if entries[a].x is entries[b].x:
            report.add(Diagnostic(
                code="ALIAS001", severity="error",
                message=(f"entries {entry_tag(entries, a)} and "
                         f"{entry_tag(entries, b)} both donate the same "
                         f"operand tensor — the second launch reads a "
                         f"tensor already emptied in every order"),
                hint="donate a tensor from at most one entry per run",
                plan_key=(f"{entry_tag(entries, a)}+"
                          f"{entry_tag(entries, b)}")))
    seg0_pos = {seg.entry: pos for pos, seg in enumerate(order)
                if seg.index == 0}
    for i in donors:
        for j, other in enumerate(entries):
            if j == i or other.x is not entries[i].x or other.donate:
                continue
            pos_i, pos_j = seg0_pos.get(i), seg0_pos.get(j)
            ordered_hazard = (pos_i is not None and pos_j is not None
                              and pos_i < pos_j)
            if racy or ordered_hazard:
                why = ("an unserialized pool order can run the donating "
                       "segment 0 first" if racy else
                       "the dispatch order runs the donating segment 0 "
                       "first")
                report.add(Diagnostic(
                    code="DON001", severity="error",
                    message=(f"entry {entry_tag(entries, j)} reads the "
                             f"operand entry {entry_tag(entries, i)} "
                             f"donates: {why}, so entry "
                             f"{entry_tag(entries, j)} reads an emptied "
                             f"operand"),
                    hint="submit the reading entry first, or copy the "
                         "operand before donating",
                    plan_key=(f"{entry_tag(entries, i)}->"
                              f"{entry_tag(entries, j)}")))

    # SCHED001: cross-lane collective launch ordering.  Collective
    # segments (index >= 1 — each holds the hop's all_to_alls) must be
    # launched in one order on every rank.
    if racy:
        chains = [[s.tag for s in e.segments if s.index >= 1]
                  for e in entries]
        pairs = racy_collective_pairs(chains)
        if pairs:
            a, b = pairs[0]
            report.add(Diagnostic(
                code="SCHED001", severity="error",
                message=(f"pool-mode dispatch without turns "
                         f"(serialize_dispatch=False): {len(pairs)} "
                         f"collective pair(s) are reachable in both launch "
                         f"orders (e.g. {a!r} vs {b!r}); ranks may launch "
                         f"the collectives in different orders and hang in "
                         f"the rendezvous"),
                hint="keep serialize_dispatch=True (every launch waits for "
                     "its turn in the planned order) or use mode='async' "
                     "(one dispatch thread)",
                plan_key=f"{a}|{b}"))

    # ALIAS002 / ALIAS003: storage-identity alias analysis (views and
    # emptied operands the is-identity rules above cannot see).
    from .provenance import check_provenance  # provenance imports this
    report.extend(check_provenance(order, entries, mode=mode,
                                   serialized=serialized))
    return report
