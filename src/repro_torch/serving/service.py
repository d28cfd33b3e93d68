"""The long-running FFT service: warm plans, route traffic, survive loss.

The port's counterpart of the JAX package's ``serving/service.py``.
``FFTService`` composes the stack under a serving contract:

* **startup** — ``warm()`` replays the wisdom file into hot plan families
  and built segments (:mod:`.warmer`);
* **steady state** — ``submit()`` queues requests; ``drain()`` routes
  them through the :class:`~.router.ShapeRouter` (bucketing, padding,
  batching), pushes the coalesced entries through **one persistent**
  :class:`~..core.executor.PlanStreamExecutor` (the buckets' segment
  chains interleave; the wired :class:`~..distributed.fault.StepWatchdog`
  times every segment and names the stragglers), then gathers and unpads
  each result and stamps its latency into :class:`~.metrics.ServingMetrics`;
* **failure** — ``lose_devices()`` drops the tail of the mesh's ranks
  mid-stream: the survivors re-shape through ``choose_fft_mesh_shape``
  (divisibility against every grid the service has promised), a fresh
  router re-plans every known family on the degraded mesh, the watchdog's
  window resets (the slower baseline is legitimate), and pending and later
  requests keep completing: degraded, not down.

**SPMD semantics.**  Every rank of the mesh runs the same service and
makes the same calls in the same order: it submits the same global
operand per request (as ``plan.forward(x)`` takes the global tensor
without ``sharded_in``), and ``drain()`` returns the same results, each
``FFTResult.y`` the whole result, gathered with ``compat.gather`` on every
serving rank (the reference's ``y`` is a global array).  ``lose_devices``
is called by every rank, since building the survivors' process groups
(``dist.new_group``) is collective over the default group; the survivors
are the first ``world - n`` ranks, shaped by ``choose_fft_mesh_shape``,
and a rank left outside the degraded mesh marks its service lost: from
then on its ``submit`` and ``drain`` raise.

The executor and its step counter persist across the mesh change: plans
are mesh-bound, the segment stream is not, so watchdog step ids stay
monotonic through a failover.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..compat import gather, make_mesh
from ..core.executor import PlanStreamExecutor
from ..core.plan import TuningCache
from ..core.tuner import BACKENDS
from ..distributed.fault import StepWatchdog, choose_fft_mesh_shape
from .metrics import ServingMetrics
from .router import DEFAULT_BUCKET_EDGES, FFTRequest, FFTResult, ShapeRouter
from .warmer import PlanWarmer, WarmReport


class FFTService:
    """Plan-warmed, shape-bucketed, loss-tolerant distributed FFT serving.

    Runs where ``mesh`` lives: a CUDA mesh (``compat.make_mesh``'s
    default, which raises without a GPU) or a CPU one.  ``backends``
    restricts the tuner's searches for the service's families.
    ``verify="warn"``/``"strict"`` model-checks every drain's planned
    order before it launches (the executor's ``verify``); findings land
    in ``metrics`` per rule code, and strict refuses a queue with errors.
    """

    def __init__(self, mesh, *, tune_cache: Optional[TuningCache] = None,
                 bucket_edges: Sequence[int] = DEFAULT_BUCKET_EDGES,
                 max_batch: int = 8, watchdog: Optional[StepWatchdog] = None,
                 watchdog_tolerance: float = 4.0,
                 metrics: Optional[ServingMetrics] = None,
                 verify: str = "off",
                 backends: Sequence[str] = BACKENDS,
                 timer: Callable[[], float] = time.perf_counter):
        self.tune_cache = tune_cache
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.watchdog = (watchdog if watchdog is not None
                         else StepWatchdog(tolerance=watchdog_tolerance))
        self.timer = timer
        # ONE executor for the service lifetime (it is not mesh-bound);
        # watchdog= implies timed dispatch, so every segment is measured.
        # verify= is forwarded: every drain's planned segment order passes
        # the static schedule/provenance/timed checkers before anything
        # launches, and findings land in ServingMetrics as per-code
        # counters (the verify_sink) rather than Python warnings — the
        # JSON dump's "verify_warnings" section is the production surface.
        self.executor = PlanStreamExecutor(
            watchdog=self.watchdog, verify=verify, timer=timer,
            verify_sink=(self.metrics.record_verify_findings
                         if verify != "off" else None))
        self._bucket_edges = tuple(bucket_edges)
        self._max_batch = max_batch
        self.backends = tuple(backends)
        self.degraded = False
        self.lost = False
        self._pending: List[FFTRequest] = []
        self._next_id = 0
        self._install_mesh(mesh)

    def _install_mesh(self, mesh) -> None:
        self.mesh = mesh
        self.router = ShapeRouter(mesh, tune_cache=self.tune_cache,
                                  bucket_edges=self._bucket_edges,
                                  max_batch=self._max_batch,
                                  metrics=self.metrics,
                                  backends=self.backends)
        self.warmer = PlanWarmer(mesh, self.tune_cache, router=self.router)

    def _check_serving(self) -> None:
        if self.lost:
            raise RuntimeError(
                "this rank left the service's mesh in lose_devices(); the "
                "survivors serve the traffic")

    # -- startup ------------------------------------------------------------

    def warm(self, *, ensure: Sequence[Tuple] = (),
             prebuild_segments: bool = True) -> WarmReport:
        """Warm plan families from the wisdom file (plus ``ensure`` seeds)."""
        self._check_serving()
        return self.warmer.warm(ensure=ensure,
                                prebuild_segments=prebuild_segments)

    # -- steady state -------------------------------------------------------

    def submit(self, x: torch.Tensor, kinds: Optional[Sequence[str]] = None,
               *, exact: bool = False) -> int:
        """Queue one request (a single batch-free global operand); returns
        its id.  Nothing runs until :meth:`drain`: coalescing needs a
        queue."""
        self._check_serving()
        kinds = tuple(kinds) if kinds is not None else ("fft",) * x.dim()
        rid = self._next_id
        self._next_id += 1
        self._pending.append(FFTRequest(id=rid, x=x, kinds=kinds,
                                        exact=exact))
        self.metrics.record_submit()
        self.metrics.record_queue_depth(len(self._pending))
        return rid

    @property
    def queue_depth(self) -> int:
        return len(self._pending)

    def drain(self) -> Dict[int, FFTResult]:
        """Route and execute every pending request; returns results by id.

        One drain is one executor stream: every bucket's segment chain
        interleaves with the others', each segment feeding the watchdog.
        Latencies are stamped after the device finished.
        """
        self._check_serving()
        if not self._pending:
            return {}
        pending, self._pending = self._pending, []
        routed = self.router.route(pending)
        self.metrics.record_batch(len(routed),
                                  [rb.bucket_grid for rb in routed])
        for rb in routed:
            self.executor.submit(rb.plan, rb.x, tag=rb.tag)
        outs = [gather(y, rb.plan.out_struct.spec, self.mesh)
                for rb, y in zip(routed, self.executor.run())]
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)
        self.metrics.record_stragglers(len(self.watchdog.flagged))
        now = self.timer()
        results: Dict[int, FFTResult] = {}
        for rb, y in zip(routed, outs):
            for i, member in enumerate(rb.members):
                yi = ShapeRouter.unpad(y[i], member, rb.bucket_grid)
                res = FFTResult(
                    id=member.id, y=yi, bucket_grid=rb.bucket_grid,
                    padded=tuple(member.x.shape) != tuple(rb.bucket_grid),
                    plan_hit=rb.plan_hit, degraded=self.degraded,
                    latency_s=now - member.t_submit)
                self.metrics.record_done(res.latency_s)
                results[member.id] = res
        return results

    def run_pending_retunes(self, max_n: Optional[int] = None) -> int:
        """Drain the router's background re-tune queue (measured searches,
        persisted to the wisdom file).  Call between drains, never during."""
        self._check_serving()
        return self.router.run_pending_retunes(max_n)

    # -- failure ------------------------------------------------------------

    def _served_dims(self) -> Tuple[int, ...]:
        """Every dim extent the degraded mesh must keep divisible: all
        known family grids plus the bucket grids of pending requests."""
        dims = set()
        for grid in self.router.known_grids:
            dims.update(grid)
        for req in self._pending:
            dims.update(self.router.bucket_grid(req.grid, req.kinds,
                                                exact=req.exact))
        return tuple(sorted(dims))

    def lose_devices(self, n_lost: int) -> Tuple[int, ...]:
        """Lose the last ``n_lost`` ranks of the mesh; re-plan onto the
        survivors.  Every rank calls this (see the module docstring).

        The survivors (the first ``size - n_lost`` ranks: deterministic, so
        a test can build an identical survivors-only mesh) are shaped with
        ``choose_fft_mesh_shape`` so every served grid stays divisible;
        the router is rebuilt and every known family re-planned on the
        degraded mesh.  Pending requests are not dropped: the next
        :meth:`drain` completes them on the survivors.  Returns the
        degraded mesh shape.
        """
        self._check_serving()
        ranks = self.mesh.ranks or tuple(range(self.mesh.size))
        survivors = ranks[:len(ranks) - int(n_lost)]
        if not survivors:
            raise ValueError("device loss left no survivors")
        shape = choose_fft_mesh_shape(len(survivors),
                                      grid=self._served_dims() or None)
        names = (tuple(self.mesh.axis_names) if
                 len(self.mesh.axis_names) == 2 else ("data", "model"))
        old_families = list(self.router.families.values())
        mesh = make_mesh(shape, names, ranks=survivors[:shape[0] * shape[1]],
                         device="cpu" if self.mesh.device.type == "cpu"
                         else None)
        self.degraded = True
        self.metrics.mark_degraded()
        if mesh is None:
            self.lost = True
            self._pending = []
            return shape
        self._install_mesh(mesh)
        # Known families re-plan at once (heuristic knobs on the new
        # geometry; measured upgrades queue behind run_pending_retunes) so
        # in-flight and later traffic stays plan-cache hot.
        for fam in old_families:
            self.router.resolve_family(fam.grid, fam.kinds, fam.dtype)
        # The degraded mesh is legitimately slower: a fresh straggler
        # baseline instead of flagging every later segment.
        self.watchdog.reset_window()
        return shape

    # -- introspection ------------------------------------------------------

    def describe(self) -> str:
        if self.lost:
            return "FFTService(lost: this rank left the mesh)"
        fams = self.router.families
        return (f"FFTService(mesh={tuple(self.mesh.shape)}, "
                f"families={len(fams)}, pending={len(self._pending)}, "
                f"degraded={self.degraded}, "
                f"hit_rate={self.metrics.plan_hit_rate:.2f})")
