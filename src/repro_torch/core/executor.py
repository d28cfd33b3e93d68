"""Plan-stream executor: interleave stage segments of heterogeneous plans.

The port's counterpart of the JAX package's ``core/executor.py``.  The
paper's thesis is that FFTs run as dynamically scheduled tasks beat static
bulk-synchronous pipelines.  ``DistributedFFT.forward`` is the static
baseline: one pipeline per call, so nothing overlaps one plan's
``all_to_all`` with another plan's local FFTs.  :class:`PlanStreamExecutor`
is the dynamic counterpart: a queue of plan executions (say many small
batched 2-D plans and one large 3-D plan) run as interleaved **stage
segments** (``pipeline.compile_segment``: segment 0 is the stage-0
transform, segment ``j`` hop ``j-1`` at its own chunk count and then stage
``j``).  Chained segments are bitwise identical to the fused pipeline, so
submitting work here changes when compute and communication happen, never
the result.

Pricing and placement are the reference's: every segment becomes a
:class:`~.scheduler.TaskSpec` priced by the perf model (stage compute from
``perfmodel.stage_comp_times``, hop phases from ``hop_cost_terms`` through
``scheduler.hop_phase_time`` at the hop's chunk count) and classified
communication- or compute-dominant; entries are placed on ``n_streams``
lanes by ``scheduler.place_tasks``; a greedy merge builds the dispatch
order, preferring a segment whose phase type differs from the last one's,
then the least-fed lane, keeping each entry's segment order; and
``report()`` replays that order in ``scheduler.ScheduleSimulator``.

Lanes are CUDA streams, one per lane on each device.  An entry's segments
run under ``torch.cuda.stream(lane)``: the kernel launches on the current
stream, and ``redistribute``'s ``work.wait()`` orders NCCL's stream before
it, so both follow the lane.  The operand enters a lane after
``lane.wait_stream(caller)``, the outputs return after
``caller.wait_stream(lane)``, and every tensor that crosses streams is
``record_stream``-ed, so the caching allocator never hands its memory to
another stream while a lane still reads it.  On the CPU there are no
streams: the lanes only set the order.

Three dispatch modes:

* ``"async"`` (default) — one thread launches the merged order without
  waiting; the lanes' streams overlap on the card.
* ``"pool"`` — a :class:`~.scheduler.WorkStealingPool` thread per lane
  runs whole entry chains, an idle one stealing whole entries; each
  thread enters its own lane's stream (PyTorch's current stream is
  thread-local).
* ``"timed"`` (implied by ``watchdog=`` or ``profile=True``) — the lane is
  synchronized after every segment and the injectable ``timer`` read, so
  ``report()["segment_times"]``, ``entry_times()`` and the
  ``StepWatchdog``'s stragglers are measured per segment.

**The dispatch lock.**  Segments hold collectives over the mesh.  Every
launch happens under one lock, and the launches follow the planned order,
which every rank computes alike.  On NCCL two lanes that issued
collectives in a different order on different ranks would deadlock (the
pool-mode fault the JAX package's lock was added for); so pool workers,
too, wait for their segment's turn in the planned order before they
launch.

**Donation.**  Interior segments give up their input once they ran, so an
entry holds at most two boundary buffers (the one being read and the one
being written).  The caller's operand is given up only for entries
submitted with ``donate=True`` (refused for ``shared`` plans): once
segment 0 ran, it is emptied in place (``pipeline.release``) and its
memory returns to the allocator; neighbouring entries' operands are
untouched.

**Verification** (``repro_torch.analysis``).  ``verify="warn"`` or
``"strict"`` model-checks every planned order before anything launches
(``verify_schedule()`` does it without consuming the queue): the
schedule and storage-provenance pass, and for the blocking modes the
timed model.  ``sanitize=True`` records each launch under the dispatch
lock with its turn, and the fate of every buffer fed to a segment, then
diffs that trace against the planned order, and on a mesh of several
ranks every rank's order against the others' (SAN001).
``serialize_dispatch=False`` (pool workers without turns) is never
launched: ``run()`` checks the queue and refuses it, because on NCCL or
gloo the ranks could launch their collectives in different orders and
hang.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .perfmodel import (as_profile, default_machine, hop_cost_terms,
                        predict_plan_time, stage_comp_times)
from .pipeline import release, released
from .scheduler import (CostModel, ScheduleSimulator, TaskSpec,
                        WorkStealingPool, hop_phase_time, place_tasks)

DISPATCH_MODES = ("async", "pool", "timed")
VERIFY_MODES = ("off", "warn", "strict")

# Lanes are process-wide: lane k on a device is the same CUDA stream for
# every executor, so the caching allocator's per-stream pools stay warm
# across runs.  A fresh stream starts with an empty pool, and each of its
# boundary buffers then costs a cudaMalloc.
_LANES: Dict[Tuple[torch.device, int], Any] = {}
_LANES_LOCK = threading.Lock()


def lane_stream(device: torch.device, lane: int):
    """Lane ``lane``'s CUDA stream on ``device`` (None on the CPU)."""
    if device.type != "cuda":
        return None
    with _LANES_LOCK:
        s = _LANES.get((device, lane))
        if s is None:
            s = _LANES[(device, lane)] = torch.cuda.Stream(device=device)
        return s


@dataclasses.dataclass
class SegmentTask:
    """One dispatchable stage segment of one queue entry."""
    entry: int                    # queue index of the owning entry
    index: int                    # segment index within the entry
    kind: str                     # "comp" | "comm" (dominant phase)
    cost_s: float                 # predicted wall seconds (perf model)
    bytes_out: int                # boundary buffer size this segment emits
    tag: str
    stream: int = 0               # dispatch lane (filled by placement)
    measured_s: float = 0.0       # filled by timed runs


@dataclasses.dataclass
class _Entry:
    plan: Any
    x: torch.Tensor
    inverse: bool
    sharded_in: bool
    donate: bool
    tag: str
    segments: List[SegmentTask] = dataclasses.field(default_factory=list)
    total_cost_s: float = 0.0
    stream: int = 0
    out: Optional[torch.Tensor] = None


def _struct_bytes(struct) -> int:
    return math.prod(struct.shape) * struct.dtype.itemsize


def _entry_segments(idx: int, entry: _Entry, machine,
                    cost_model: CostModel) -> List[SegmentTask]:
    """Price one entry's segments as scheduler tasks (perf-model terms)."""
    plan = entry.plan
    spec = plan.pipeline_spec(inverse=entry.inverse)
    axis_sizes = plan.mesh.axis_sizes
    structs = plan.segment_boundary_structs(inverse=entry.inverse)
    dtype_bytes = structs[-1].dtype.itemsize
    batch = max(1, math.prod(plan.batch_shape))
    prof = as_profile(machine)

    stage_t = stage_comp_times(spec.grid, spec.decomp, axis_sizes, prof,
                               backend=spec.backend, dtype_bytes=dtype_bytes,
                               kinds=spec.kinds, eff_grid=spec.eff_grid,
                               dtype=structs[0].dtype)
    hops = hop_cost_terms(spec.grid, spec.decomp, axis_sizes, prof,
                          backend=spec.backend, dtype_bytes=dtype_bytes,
                          kinds=spec.kinds, eff_grid=spec.eff_grid,
                          stage_times=stage_t)
    if spec.inverse:
        # perfmodel prices in forward stage/hop order; the inverse pipeline
        # runs stages and hops LIFO (executed hop k == forward hop
        # n_hops-1-k, its downstream stage the matching forward stage).
        stage_t = stage_t[::-1]
        hops = hops[::-1]
    tau_s = cost_model.steal_cost(TaskSpec(data_bytes=0))

    segs = [SegmentTask(
        entry=idx, index=0, kind="comp", cost_s=batch * stage_t[0],
        bytes_out=_struct_bytes(structs[1]), tag=f"{entry.tag}/seg0")]
    for j in range(1, len(stage_t)):
        _, beta, alpha, _ = hops[j - 1]
        k = spec.chunk_schedule[j - 1]
        t_comm = beta + alpha * max(k, 1)
        phase = hop_phase_time(stage_t[j], beta, alpha, k, tau_s=tau_s,
                               overlap_floor=prof.overlap)
        segs.append(SegmentTask(
            entry=idx, index=j,
            kind="comm" if t_comm >= stage_t[j] else "comp",
            cost_s=batch * phase, bytes_out=_struct_bytes(structs[j + 1]),
            tag=f"{entry.tag}/seg{j}"))
    return segs


class _Aborted(Exception):
    """A pool worker gave up waiting for its turn: another one failed."""


class PlanStreamExecutor:
    """Queue heterogeneous plan executions; run them as interleaved segments.

    Parameters
    ----------
    n_streams:
        Dispatch lanes (``place_tasks`` workers, one CUDA stream each per
        device).  Default 2: one lane's exchange runs under the other's
        local FFTs.
    machine:
        ``Machine``/``MachineProfile`` for segment pricing (default: the
        perf model's constants for the entries' device; pass a calibrated
        profile for measured terms).
    cost_model:
        LogP :class:`~.scheduler.CostModel` for placement and ``tau_s``.
    watchdog:
        Optional :class:`~..distributed.fault.StepWatchdog`.  When set,
        runs are timed: each segment is waited for and fed to the
        watchdog, so straggler segments land in ``stragglers``.
    mode:
        ``"async"`` | ``"pool"`` | ``"timed"`` (see the module docstring).
    donate_intermediates:
        Interior segments give up their input (at most two live boundary
        buffers per entry).  Default True.
    profile:
        Record measured per-segment times without a watchdog (forces timed
        dispatch).
    verify:
        ``"off"`` (default) | ``"warn"`` | ``"strict"`` — run the static
        checkers on every planned order before anything launches
        (``repro_torch.analysis.check_schedule`` and, for the blocking
        modes, ``check_timed_schedule``).  ``"warn"`` reports findings
        and proceeds; ``"strict"`` raises
        :class:`~repro_torch.analysis.PlanVerificationError` on *errors*
        with the queue intact (SCHED003/SCHED004 are warnings and never
        refuse a queue).
    verify_sink:
        Optional callable receiving every non-empty
        :class:`~repro_torch.analysis.DiagnosticReport` the verify and
        sanitize paths produce, *instead of* a Python warning (strict
        errors still raise).  The service points it at
        ``ServingMetrics.record_verify_findings``.
    sanitize:
        Record an :class:`~repro_torch.analysis.ExecutionTrace` of every
        run and diff it against the static model (and, on several ranks,
        against the other ranks' orders); divergences are SAN001
        diagnostics, reported through ``verify_sink`` or a warning and
        kept on :meth:`last_sanitize_report`.  Each buffer's fate is
        read just after the launch that consumed it, so the trace holds
        no tensor and the run's peak memory is the plain run's.  On
        several ranks the order check is one object all-gather after the
        run: a rank that raised makes none, and its peers wait in it as
        they would in the run's next collective.
    serialize_dispatch:
        Launch in turn order (default True: the collective-order
        invariant).  False models pool workers launching without turns,
        as the JAX package's pool may: ``verify_schedule()`` flags it
        (SCHED001) whenever the queue makes a collective-order hang
        reachable, and ``run()`` always refuses it before any launch,
        with the report and the queue intact.
    timer:
        Clock of the timed runs and of the trace's dispatch stamps
        (injectable for hermetic tests).
    """

    def __init__(self, *, n_streams: int = 2, machine=None,
                 cost_model: Optional[CostModel] = None, watchdog=None,
                 mode: str = "async", donate_intermediates: bool = True,
                 profile: bool = False, verify: str = "off",
                 serialize_dispatch: bool = True, sanitize: bool = False,
                 verify_sink: Optional[Callable[[Any], None]] = None,
                 timer: Callable[[], float] = time.perf_counter):
        if mode not in DISPATCH_MODES:
            raise ValueError(f"mode must be one of {DISPATCH_MODES}, "
                             f"got {mode!r}")
        if verify not in VERIFY_MODES:
            raise ValueError(f"verify must be one of {VERIFY_MODES}, "
                             f"got {verify!r}")
        self.n_streams = max(int(n_streams), 1)
        self.machine = machine
        self.cost_model = cost_model if cost_model is not None else CostModel()
        self.watchdog = watchdog
        self.mode = mode
        self.donate_intermediates = bool(donate_intermediates)
        self.profile = bool(profile)
        self.verify = verify
        self.serialize_dispatch = bool(serialize_dispatch)
        self.sanitize = bool(sanitize)
        self.verify_sink = verify_sink
        self.timer = timer
        self._queue: List[_Entry] = []
        # Every launch happens under this lock, in the planned order (the
        # turn counter): the collective launch order is the same on every
        # rank.  Pool workers wait on the condition for their turn.
        self._dispatch_lock = threading.Lock()
        self._turn_cv = threading.Condition(self._dispatch_lock)
        self._turn = 0
        self._failed: Optional[BaseException] = None
        self._running = False               # run() re-entrancy guard
        self._step = 0                      # watchdog step counter
        self._step_tags: Dict[int, str] = {}
        self._last_schedule: List[SegmentTask] = []
        self._last_report: Dict[str, Any] = {}
        self._caller: Dict[torch.device, Any] = {}   # run()'s own streams
        self._thread_lanes: Dict[int, int] = {}
        self._last_verify = None            # DiagnosticReport of last check
        # Sanitizer state: the in-flight trace (appended under the
        # dispatch lock), the model order the diff runs against, and the
        # last run's trace and SAN001 report.
        self._trace = None
        self._planned_order: List[SegmentTask] = []
        self._last_trace = None
        self._last_sanitize = None

    # -- queue management ---------------------------------------------------

    def submit(self, plan, x: torch.Tensor, *, inverse: bool = False,
               sharded_in: bool = False, donate: bool = False,
               tag: Optional[str] = None) -> int:
        """Enqueue one plan execution; returns its queue index.

        ``x`` is the global operand, or this rank's stage-0 block with
        ``sharded_in=True``.  ``donate=True`` gives the caller's operand
        up to segment 0 (refused for ``shared`` wrapper-memoized plans).
        Nothing runs until :meth:`run`.
        """
        if donate and getattr(plan, "shared", False):
            raise ValueError(
                "refusing donate=True for a shared (wrapper-memoized) plan: "
                "other callers may still own the input buffer; build a "
                "private plan via plan_fft for donation")
        struct = plan.in_struct if not inverse else plan.inv_in_struct
        want = struct.local_shape if sharded_in else struct.shape
        if tuple(x.shape) != tuple(want):
            raise ValueError(
                f"entry {len(self._queue)}: operand shape {tuple(x.shape)} "
                f"!= plan {'inverse' if inverse else 'forward'} input "
                f"{'block ' if sharded_in else ''}{tuple(want)}")
        idx = len(self._queue)
        self._queue.append(_Entry(
            plan=plan, x=x, inverse=inverse, sharded_in=sharded_in,
            donate=donate, tag=tag if tag is not None else f"entry{idx}"))
        return idx

    def __len__(self) -> int:
        return len(self._queue)

    # -- scheduling ---------------------------------------------------------

    def _plan_schedule(self, entries: Optional[List[_Entry]] = None
                       ) -> List[SegmentTask]:
        """Price, place and order the queue; returns the dispatch order."""
        if entries is None:
            entries = self._queue
        for i, e in enumerate(entries):
            e.segments = _entry_segments(i, e, self._machine(e.plan.device),
                                         self.cost_model)
            e.total_cost_s = sum(s.cost_s for s in e.segments)

        # Alg. 3 placement over entry aggregates: heterogeneous entries
        # spread across lanes by predicted cost, with the rebalance pass
        # fixing a lane stuck with one big 3-D plan plus small 2-D ones.
        entry_tasks = [TaskSpec(home=i % self.n_streams, cost=e.total_cost_s,
                                data_bytes=_struct_bytes(
                                    e.plan.in_struct if not e.inverse
                                    else e.plan.inv_in_struct),
                                tag=e.tag)
                       for i, e in enumerate(entries)]
        sigma = place_tasks(entry_tasks, self.n_streams, self.cost_model)
        for i, e in enumerate(entries):
            e.stream = sigma[i]
            for s in e.segments:
                s.stream = sigma[i]

        # Greedy comm/comp-alternating merge of the per-lane queues.
        lanes: List[List[SegmentTask]] = [[] for _ in range(self.n_streams)]
        for e in entries:
            lanes[e.stream].extend(e.segments)
        heads = [0] * self.n_streams
        dispatched = [0.0] * self.n_streams
        order: List[SegmentTask] = []
        last_kind = "comm"  # start with compute: fills the device first
        while any(h < len(lane) for h, lane in zip(heads, lanes)):
            ready = [(w, lanes[w][heads[w]]) for w in range(self.n_streams)
                     if heads[w] < len(lanes[w])]
            # Prefer a phase-type flip; among those, the least-fed lane.
            w, seg = min(
                ready, key=lambda ws: (ws[1].kind == last_kind,
                                       dispatched[ws[0]], ws[0]))
            heads[w] += 1
            dispatched[w] += seg.cost_s
            last_kind = seg.kind
            order.append(seg)
        return order

    def _machine(self, device: torch.device):
        return self.machine if self.machine is not None \
            else default_machine(device)

    def _effective_mode(self) -> str:
        """A watchdog or ``profile=True`` forces timed dispatch."""
        if self.mode == "timed" or self.watchdog is not None or self.profile:
            return "timed"
        return self.mode

    def _simulate(self, order: Sequence[SegmentTask],
                  use_measured: bool = False) -> Dict[str, float]:
        """Deterministic replay of the chosen placement (steal disabled:
        segment order within a lane is a dependency chain)."""
        tasks = []
        for s in order:
            cost = s.measured_s if use_measured and s.measured_s > 0 \
                else s.cost_s
            tasks.append(TaskSpec(home=s.stream, cost=cost,
                                  data_bytes=s.bytes_out, tag=s.tag))
        sim = ScheduleSimulator(self.n_streams, steal=False,
                                cost_model=self.cost_model)
        stats = sim.run(tasks, trace=True)
        serial = sum(t.cost for t in tasks)
        stats["serial_s"] = serial
        stats["overlap_efficiency"] = (stats["wall_s"] / serial
                                       if serial > 0 else 1.0)
        return stats

    def _check_schedule(self, order: Sequence[SegmentTask],
                        entries: List[_Entry]):
        """Static checkers over one planned order (nothing launches): the
        order + provenance pass, plus the blocking-semantics model for the
        modes that block (timed/pool)."""
        from ..analysis import (check_schedule,  # analysis imports core
                                check_timed_schedule)
        eff = self._effective_mode()
        report = check_schedule(order, entries, mode=eff,
                                serialized=self.serialize_dispatch)
        report.extend(check_timed_schedule(
            order, entries, mode=eff, cost_model=self.cost_model,
            watchdog=self.watchdog))
        return report

    def verify_schedule(self):
        """Plan the current queue and statically verify it — without
        consuming the queue or launching a single segment.  Returns the
        :class:`~repro_torch.analysis.DiagnosticReport`."""
        return self._check_schedule(self._plan_schedule(self._queue),
                                    self._queue)

    def last_verify_report(self):
        """The :class:`~repro_torch.analysis.DiagnosticReport` of the last
        verify pass of ``run()`` (``None`` when ``verify="off"`` or
        nothing ran)."""
        return self._last_verify

    def last_sanitize_report(self):
        """The SAN001 diff of the last instrumented run (``None`` until a
        ``sanitize=True`` run completes; empty means the executor matched
        the static model exactly)."""
        return self._last_sanitize

    def last_trace(self):
        """The :class:`~repro_torch.analysis.ExecutionTrace` of the last
        instrumented run (``None`` until a ``sanitize=True`` run)."""
        return self._last_trace

    def sanitize_json(self) -> Dict[str, Any]:
        """The trace-diff artifact (observed trace + SAN001 diff) of the
        last instrumented run, JSON-serializable."""
        from ..analysis import trace_json
        return trace_json(self._last_trace, self._last_sanitize)

    def _report(self, report, what: str) -> None:
        """Hand a non-empty report to the sink, else warn."""
        if not report:
            return
        if self.verify_sink is not None:
            self.verify_sink(report)
        else:
            warnings.warn(f"PlanStreamExecutor {what}:\n" + report.render(),
                          stacklevel=3)

    # -- execution ----------------------------------------------------------

    def _dispatch(self, entry: _Entry, seg: SegmentTask, turn: int,
                  fns: List[Callable], bufs: Dict[int, torch.Tensor],
                  stream) -> None:
        """Launch one segment on ``stream`` when its turn comes."""
        with self._turn_cv:
            while self._turn != turn:
                if self._failed is not None:
                    raise _Aborted()
                self._turn_cv.wait()
            try:
                ctx = (torch.cuda.stream(stream) if stream is not None
                       else contextlib.nullcontext())
                with ctx:
                    cur = bufs[seg.entry]
                    if stream is not None and seg.index == 0:
                        # The operand was prepared on the caller's stream;
                        # later boundaries stay on this lane.
                        stream.wait_stream(self._caller[cur.device])
                        cur.record_stream(stream)
                    rec = (self._record_launch(entry, seg, turn)
                           if self._trace is not None else None)
                    out = fns[seg.index](cur)
                    if rec is not None:
                        # Every release happens inside its launch.
                        rec.deleted = released(cur)
                    del cur
                bufs[seg.entry] = out
                if seg.index == len(entry.segments) - 1:
                    entry.out = out
            finally:
                self._turn += 1
                self._turn_cv.notify_all()

    def _segment_exes(self, entry: _Entry) -> List[Callable]:
        """The callables of one entry's segments.  A donating entry's
        segment 0 gives up the prepared operand (``donate_input``) and
        then the caller's tensor too, which differs from it when
        ``prepare_input`` copied or sliced it."""
        fns = entry.plan.segments(
            inverse=entry.inverse, donate_input=entry.donate,
            donate_intermediates=self.donate_intermediates)
        if not entry.donate:
            return fns
        first, x = fns[0], entry.x

        def seg0(v: torch.Tensor) -> torch.Tensor:
            out = first(v)
            release(x)
            return out

        return [seg0, *fns[1:]]

    def _record_launch(self, entry: _Entry, seg: SegmentTask, turn: int):
        """Sanitizer hook, called under the dispatch lock just before a
        launch: records the event (with its turn) and returns the record
        of the buffer it consumes, whose fate ``_dispatch`` reads just
        after the launch.

        The donation expectation mirrors the segment flags exactly —
        segment 0 gives up its input iff the entry donated, interior
        segments iff the executor double-buffers — which is also what
        :func:`repro_torch.analysis.expected_donations` derives, so the
        diff tests the model, not this mirror.
        """
        from ..analysis.sanitize import BufferRecord, TraceEvent
        rec = BufferRecord(
            tag=seg.tag,
            role="operand" if seg.index == 0 else "interior",
            expect_deleted=(entry.donate if seg.index == 0
                            else self.donate_intermediates))
        self._trace.events.append(TraceEvent(
            entry=seg.entry, index=seg.index, tag=seg.tag, turn=turn,
            t_dispatch_s=self.timer()))
        self._trace.buffers.append(rec)
        return rec

    def _finish_sanitize(self, entries: List[_Entry]) -> None:
        """Close out one instrumented run: attach measured walls, diff
        the trace against the planned order and, on a mesh of several
        ranks, against every other rank's order (one object all-gather
        over the mesh's group, which every rank makes), and report any
        SAN001 divergence."""
        from ..analysis import diff_ranks, diff_trace
        trace, self._trace = self._trace, None
        walls = {s.tag: s.measured_s for s in self._planned_order
                 if s.measured_s > 0}
        for ev in trace.events:
            ev.wall_s = walls.get(ev.tag, 0.0)
        report = diff_trace(trace, self._planned_order, entries)
        meshes: List[Any] = []
        for e in entries:
            if all(e.plan.mesh is not m for m in meshes):
                meshes.append(e.plan.mesh)
        for mesh in meshes:
            if mesh.size > 1 and dist.is_available() \
                    and dist.is_initialized():
                orders: List[Any] = [None] * mesh.size
                dist.all_gather_object(orders, trace.launch_order(),
                                       group=mesh.group)
                report.extend(diff_ranks(
                    orders, mesh.ranks.index(dist.get_rank())))
        self._last_trace = trace
        self._last_sanitize = report
        self._report(report, "sanitizer divergence")

    def _worker_lane(self) -> int:
        """The lane of the calling pool thread (one per thread)."""
        with self._dispatch_lock:
            ident = threading.get_ident()
            if ident not in self._thread_lanes:
                self._thread_lanes[ident] = len(self._thread_lanes) \
                    % self.n_streams
            return self._thread_lanes[ident]

    def run(self) -> List[torch.Tensor]:
        """Execute every queued entry; returns this rank's output blocks in
        submit order.

        The outputs are ordered after every lane on the caller's current
        stream, so the caller may use them at once (CUDA work may still be
        in flight, as after any PyTorch call).  The queue is cleared;
        ``report()`` describes the run.  ``run()`` is not reentrant.
        """
        if not self._queue:
            return []
        if self._running:
            raise RuntimeError(
                "PlanStreamExecutor.run() is already in progress; "
                "submit() more work and call run() after it returns")
        entries, self._queue = self._queue, []
        order = self._plan_schedule(entries)
        self._planned_order = list(order)    # the model the sanitizer diffs
        # Without turns the ranks may launch their collectives in
        # different orders and hang, so such a run is never launched.
        refuse = not self.serialize_dispatch
        if self.verify != "off" or refuse:
            report = self._check_schedule(order, entries)
            self._last_verify = report
            if refuse or (report.errors and self.verify == "strict"):
                from ..analysis import PlanVerificationError
                self._queue = entries        # leave the queue resubmittable
                raise PlanVerificationError(report, context=(
                    "PlanStreamExecutor(serialize_dispatch=False) is never "
                    "launched" if refuse else
                    "PlanStreamExecutor.run(verify='strict')"))
            self._report(report, "schedule check")
        self._running = True
        if self.sanitize:
            from ..analysis import ExecutionTrace
            self._trace = ExecutionTrace(mode=self._effective_mode())
        try:
            outs = self._run_order(order, entries)
        except BaseException:
            self._trace = None
            raise
        finally:
            self._running = False
        if self._trace is not None:
            self._finish_sanitize(entries)
        return outs

    def _run_order(self, order: List[SegmentTask],
                   entries: List[_Entry]) -> List[torch.Tensor]:
        self._last_schedule = order
        self._last_report = {"predicted": self._simulate(order)}
        fns = [self._segment_exes(e) for e in entries]
        devices = {e.plan.device for e in entries}
        self._caller = {d: torch.cuda.current_stream(d) for d in devices
                        if d.type == "cuda"}
        # Every operand is laid out on the caller's stream before any lane
        # reads it.
        bufs: Dict[int, torch.Tensor] = {
            i: e.plan.prepare_input(e.x, inverse=e.inverse,
                                    sharded_in=e.sharded_in)
            for i, e in enumerate(entries)}
        turns = {(s.entry, s.index): t for t, s in enumerate(order)}
        self._turn, self._failed = 0, None
        used = set()
        mode = self._effective_mode()
        if mode == "timed":
            for t, seg in enumerate(order):
                e = entries[seg.entry]
                stream = lane_stream(e.plan.device, seg.stream)
                used.add((e.plan.device, seg.stream))
                step = self._step
                self._step += 1
                self._step_tags[step] = seg.tag
                if self.watchdog is not None:
                    self.watchdog.start(step)
                t0 = self.timer()
                self._dispatch(e, seg, t, fns[seg.entry], bufs, stream)
                if stream is not None:
                    stream.synchronize()
                seg.measured_s = self.timer() - t0
                if self.watchdog is not None:
                    self.watchdog.stop()
            self._last_report["measured"] = self._simulate(
                order, use_measured=True)
            self._last_report["segment_times"] = {
                s.tag: s.measured_s for s in order}
        elif mode == "pool":
            self._thread_lanes = {}
            pool = WorkStealingPool(self.n_streams,
                                    cost_model=self.cost_model,
                                    timer=self.timer)

            def chain(e_idx: int) -> None:
                entry = entries[e_idx]
                lane = self._worker_lane()
                stream = lane_stream(entry.plan.device, lane)
                with self._dispatch_lock:
                    used.add((entry.plan.device, lane))
                try:
                    for seg in entry.segments:
                        self._dispatch(entry, seg, turns[(e_idx, seg.index)],
                                       fns[e_idx], bufs, stream)
                except _Aborted:
                    pass
                except BaseException as exc:  # re-raised by run() below
                    with self._turn_cv:
                        if self._failed is None:
                            self._failed = exc
                        self._turn_cv.notify_all()

            seen = set()
            for seg in order:         # lane-merged order, entry granularity
                if seg.entry in seen:
                    continue
                seen.add(seg.entry)
                e = entries[seg.entry]
                pool.submit(TaskSpec(fn=chain, args=(seg.entry,),
                                     home=e.stream, cost=e.total_cost_s,
                                     data_bytes=0, tag=e.tag))
            self._last_report["pool"] = pool.run()
            if self._failed is not None:
                raise self._failed
        else:
            for t, seg in enumerate(order):
                e = entries[seg.entry]
                used.add((e.plan.device, seg.stream))
                self._dispatch(e, seg, t, fns[seg.entry], bufs,
                               lane_stream(e.plan.device, seg.stream))

        for device, lane in used:
            stream = lane_stream(device, lane)
            if stream is not None:
                self._caller[device].wait_stream(stream)
        for e in entries:
            if e.out is not None and e.out.is_cuda:
                e.out.record_stream(self._caller[e.out.device])
        outs = [e.out for e in entries]
        for e in entries:
            e.x = e.out = None
        return outs

    # -- introspection ------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        """Last run's schedule validation: ``predicted`` (simulator over
        perf-model costs), plus ``measured``/``segment_times`` after a
        timed run and ``pool`` stats after a pooled one."""
        return dict(self._last_report)

    @property
    def last_schedule(self) -> List[SegmentTask]:
        """The dispatch order the last run chose (SegmentTask records)."""
        return list(self._last_schedule)

    def entry_times(self) -> Dict[str, float]:
        """Measured wall seconds per entry tag from the last **timed** run
        (sum of its segments' measured durations; empty after async/pool
        runs).  The serving layer uses this for per-request latency
        attribution when the watchdog is wired."""
        out: Dict[str, float] = {}
        for seg in self._last_schedule:
            if seg.measured_s > 0:
                base = seg.tag.rsplit("/seg", 1)[0]
                out[base] = out.get(base, 0.0) + seg.measured_s
        return out

    @property
    def stragglers(self) -> List[Tuple[str, float]]:
        """Watchdog-flagged segments of all runs: ``(tag, seconds)``."""
        if self.watchdog is None:
            return []
        return [(self._step_tags.get(step, f"step{step}"), dt)
                for step, dt in self.watchdog.flagged]

    def predict_entry_time(self, plan, *, inverse: bool = False) -> float:
        """Perf-model wall-seconds for one solo entry (pricing helper)."""
        spec = plan.pipeline_spec(inverse=inverse)
        pred = predict_plan_time(
            spec.grid, spec.decomp, plan.mesh.axis_sizes,
            as_profile(self._machine(plan.device)), backend=spec.backend,
            kinds=spec.kinds, eff_grid=spec.eff_grid,
            chunk_schedule=spec.chunk_schedule,
            dtype=plan.segment_boundary_structs(inverse=inverse)[0].dtype)
        batch = max(1, math.prod(plan.batch_shape))
        return batch * pred["t_total_s"]


def execute_many(entries: Sequence, **executor_kw) -> List[torch.Tensor]:
    """Run a heterogeneous queue in one interleaved stream.

    ``entries`` are ``(plan, x)`` pairs or ``(plan, x, opts)`` triples
    (``opts`` forwarded to :meth:`PlanStreamExecutor.submit`: ``inverse``,
    ``sharded_in``, ``donate``, ``tag``).  Returns this rank's output
    blocks in entry order, bitwise identical to calling each plan solo.
    """
    ex = PlanStreamExecutor(**executor_kw)
    for item in entries:
        plan, x, opts = (*item, {}) if len(item) == 2 else item
        ex.submit(plan, x, **opts)
    return ex.run()
