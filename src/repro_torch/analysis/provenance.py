"""Storage-provenance alias analysis for the plan-stream executor.

The port's counterpart of the JAX package's ``analysis/provenance.py``.
The schedule checker's DON001/ALIAS001 rules compare operands with ``is``
— object identity.  That misses every *view-aliased* hazard: two torch
tensors can be ``is``-distinct views of one storage (slicing,
``as_strided``, ``.conj()``, ``view_as_real`` all return a new tensor over
the same memory).  This pass tracks storage *identity* instead:

* **ALIAS002 — view-aliased donation across entries.**  An entry
  submitted with ``donate=True`` whose operand overlaps another entry's
  ``is``-distinct operand in memory.  The reachability rule mirrors
  DON001: an unserialized pool order makes the hazard a race; under the
  executor's turns it is real iff the dispatch order runs the donating
  segment 0 first.  Two donors over overlapping storage are wrong in
  every order (the view-aliased form of ALIAS001).
* **ALIAS003 — donated operand re-submitted.**  An entry whose operand
  was *already emptied* by a donation when the queue is planned
  (:func:`~repro_torch.core.pipeline.released`: ``pipeline.release``
  empties a donated tensor with ``set_()`` and marks it, so a tensor that
  was empty to begin with is not mistaken for one).  The marker is ground
  truth, so this cannot false-positive on allocator pointer reuse.  An
  emptied tensor has lost its shape, so ``submit`` already refuses one;
  ALIAS003 catches an operand another run donated *after* it was
  submitted here.

Storage identity is the storage's base pointer (``untyped_storage().
data_ptr()``) on its device together with the byte range the tensor
spans in it (``storage_offset`` and, from the sizes and strides, the last
element it can reach); two tensors alias iff they share a storage and
their ranges overlap.  The range is conservative: interleaved views such
as ``x[::2]`` and ``x[1::2]`` overlap by range though they share no
element.  Everything here is a read — no segment executes and no memory
moves.

**What donation does in the port at run time.**  Donation is out of
place: ``pipeline.release`` empties *one tensor object*, and the memory
returns to the allocator only once no other tensor holds the storage.
A view-aliased sibling keeps the storage alive and its values intact, so
the ALIAS002 queue does not corrupt the sibling's input as it does in the
JAX package (where donation deletes the shared device buffer).  The
static finding stays an error all the same: the donor asked for its
memory to be given up, and the sibling silently keeps it held.

The plan-level pass (:func:`check_plan_buffers`, surfaced through
``DistributedFFT.verify()``) audits the other provenance boundary the
executor relies on: a ``shared`` (wrapper-memoized) plan must hold no
donating segment variants.  ``submit()``/``segments()`` refuse donation
for shared plans at call time, but a plan whose segments were built
donating *before* it was marked shared carries those variants into the
memo — this pass catches that ordering (reported as DON002).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from ..core.pipeline import released
from .diagnostics import Diagnostic, DiagnosticReport
from .schedule_check import entry_tag, racy_dispatch

Span = Tuple[torch.device, int, int, int]


def device_buffers(x: Any) -> Optional[Span]:
    """``(device, storage pointer, first byte, end byte)`` of the memory
    ``x`` can reach; ``None`` for non-tensors, emptied or empty tensors
    and tensors without a storage."""
    if not isinstance(x, torch.Tensor) or x.numel() == 0:
        return None
    try:
        ptr = x.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return None
    item = x.element_size()
    lo = x.storage_offset() * item
    reach = sum((n - 1) * s for n, s in zip(x.shape, x.stride())) + 1
    return (x.device, ptr, lo, lo + reach * item)


def buffers_alias(a: Any, b: Any) -> bool:
    """True iff ``a`` and ``b`` share memory (``is``-identical objects
    trivially do)."""
    if a is b:
        return True
    sa, sb = device_buffers(a), device_buffers(b)
    if sa is None or sb is None:
        return False
    return sa[:2] == sb[:2] and sa[2] < sb[3] and sb[2] < sa[3]


def check_provenance(order: Sequence, entries: Sequence, *,
                     mode: str = "async",
                     serialized: bool = True) -> DiagnosticReport:
    """Alias-analyze one planned dispatch (ALIAS002 / ALIAS003).

    ``order``/``entries`` are the executor's planned dispatch order and
    queue, exactly as :func:`~.schedule_check.check_schedule` receives
    them; this pass adds storage-identity reasoning on top of the
    ``is``-identity rules there.
    """
    report = DiagnosticReport()

    # ALIAS003: an operand a donation already emptied.  Ground truth —
    # no order can read it back.
    for i, e in enumerate(entries):
        if released(e.x):
            report.add(Diagnostic(
                code="ALIAS003", severity="error",
                message=(f"entry {entry_tag(entries, i)}: operand was "
                         f"already emptied — an earlier run donated "
                         f"(released) it after this entry was submitted"),
                hint="keep a donation-free copy for re-submission, or drop "
                     "donate=True from the earlier entry that released it",
                plan_key=entry_tag(entries, i)))

    donors = [i for i, e in enumerate(entries) if getattr(e, "donate", False)]
    if not donors:
        return report
    racy = racy_dispatch(mode, serialized)
    seg0_pos = {seg.entry: pos for pos, seg in enumerate(order)
                if seg.index == 0}
    for i in donors:
        for j, other in enumerate(entries):
            # Same-object pairs are DON001/ALIAS001 territory; this pass
            # only adds the is-distinct, storage-aliased cases.
            if j == i or other.x is entries[i].x:
                continue
            if not buffers_alias(entries[i].x, other.x):
                continue
            if getattr(other, "donate", False):
                if j < i:
                    continue  # one finding per donor pair
                report.add(Diagnostic(
                    code="ALIAS002", severity="error",
                    message=(f"entries {entry_tag(entries, i)} and "
                             f"{entry_tag(entries, j)} both donate "
                             f"is-distinct views of one storage — each "
                             f"gives up memory the other still holds, in "
                             f"every order"),
                    hint="donate a storage from at most one entry per run; "
                         "views share it even when the tensors compare "
                         "is-distinct",
                    plan_key=(f"{entry_tag(entries, i)}+"
                              f"{entry_tag(entries, j)}")))
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
                    code="ALIAS002", severity="error",
                    message=(f"entry {entry_tag(entries, j)}'s operand is "
                             f"an is-distinct view of the storage entry "
                             f"{entry_tag(entries, i)} donates: {why}, so "
                             f"the donation gives up memory entry "
                             f"{entry_tag(entries, j)} still reads"),
                    hint="copy the operand before donating (views share "
                         "the storage even when the tensors compare "
                         "is-distinct), or drop donate=True",
                    plan_key=(f"{entry_tag(entries, i)}->"
                              f"{entry_tag(entries, j)}")))
    return report


def expected_donations(entries: Sequence, *,
                       donate_intermediates: bool = True
                       ) -> Tuple[Tuple[str, bool], ...]:
    """The static provenance model's donation table for one queue.

    One ``(segment_tag, input_released)`` row per dispatchable segment:
    segment 0 releases the caller operand iff the entry donates; interior
    segments release the executor-owned boundary buffer iff the executor
    double-buffers (``donate_intermediates``).  The differential
    sanitizer diffs observed releases against exactly this table.
    """
    rows = []
    for e in entries:
        for seg in e.segments:
            expect = (bool(getattr(e, "donate", False)) if seg.index == 0
                      else bool(donate_intermediates))
            rows.append((seg.tag, expect))
    return tuple(rows)


def check_plan_buffers(plan: Any) -> DiagnosticReport:
    """Plan-level provenance: a shared plan must hold no donating segment
    variants (built-before-shared ordering; see module docstring).  The
    port's plans keep their segment lists in ``_segs``, keyed
    ``(inverse, donate_input, donate_intermediates)``; only segment 0 of
    a ``donate_input`` variant consumes a caller's operand."""
    report = DiagnosticReport()
    if not getattr(plan, "shared", False):
        return report
    lock = getattr(plan, "_build_lock", None)
    donating = []
    if lock is not None:
        with lock:
            donating = [f"segments(inverse={k[0]})"
                        for k in getattr(plan, "_segs", {}) if k[1]]
    if donating:
        report.add(Diagnostic(
            code="DON002", severity="error",
            message=(f"shared (wrapper-memoized) plan holds "
                     f"{len(donating)} input-donating segment variant(s) "
                     f"({', '.join(sorted(donating))}) — they were built "
                     f"before the plan was marked shared, and any caller "
                     f"reaching one releases an operand other callers may "
                     f"still own"),
            hint="mark the plan shared before handing it out (donating "
                 "segments are refused once the flag is set), or build a "
                 "private plan via plan_fft for donation",
            plan_key=repr(plan)))
    return report
