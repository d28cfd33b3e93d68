"""Plan warming: turn the wisdom file into hot plans before traffic lands.

The port's counterpart of the JAX package's ``serving/warmer.py``.  A cold
request pays two layers: a tuning *search* (measured, seconds) and the
*build* of its plans — the pipeline and segment callables in the LRU plan
cache and, on the kernel backend, the CUDA library (``kernels/build.py``:
``nvcc`` once per source, a load per process).  Both are functions of
(problem, mesh, platform).  The wisdom file keeps the first; the warmer
spends the second at startup instead of on the first unlucky request:

1. enumerate persisted :class:`~..core.plan.TunedPlan` keys matching this
   platform, mesh geometry and backend restriction
   (``tuner.warm_candidates``);
2. rebuild each winning plan through ``plan_fft(tuned=...)`` from its
   stored record — no measurement — and build its segments
   (``plan.segments()``, which also loads the kernel library);
3. register each batch-free problem as a router *plan family*, and build
   the batch-bucket variants the router serves with, so the first request
   of that (grid, kinds, dtype) builds nothing.

``ensure=`` also seeds families for problems the operator expects traffic
on but has no wisdom for (heuristic knobs, background re-tune queued).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..core.api import plan_fft
from ..core.plan import TuningCache
from ..core.tuner import BACKENDS, warm_candidates
from .router import BATCH_BUCKETS


@dataclasses.dataclass
class WarmReport:
    """What one ``PlanWarmer.warm()`` pass accomplished."""
    candidates: int = 0          # wisdom keys matching platform + mesh
    warmed: int = 0              # plans rebuilt (zero-measurement hits)
    segments_prebuilt: int = 0   # segment callables built
    families: int = 0            # router plan families registered warm
    batch_plans: int = 0         # per-batch-bucket family variants built
    ensured: int = 0             # families seeded heuristically via ensure=
    skipped: List[str] = dataclasses.field(default_factory=list)
    seconds: float = 0.0

    def describe(self) -> str:
        return (f"warmed {self.warmed}/{self.candidates} plans "
                f"({self.segments_prebuilt} segments, {self.families} "
                f"families, {self.batch_plans} batch variants, "
                f"{self.ensured} ensured, "
                f"{len(self.skipped)} skipped) in {self.seconds:.2f}s")


class PlanWarmer:
    """Warms the plan cache (and the kernel library) from wisdom."""

    def __init__(self, mesh, cache: Optional[TuningCache], *, router=None,
                 backends: Sequence[str] = BACKENDS,
                 timer: Callable[[], float] = time.perf_counter):
        self.mesh = mesh
        self.cache = cache
        self.router = router
        # The search space whose wisdom this warmer replays (the router's).
        self.backends = tuple(router.backends if router is not None
                              else backends)
        self.timer = timer
        # Warmed handles, keyed (grid, kinds, dtype, batch_shape): kept
        # alive so the plan-cache entries they own are not evicted between
        # warm() and the first traffic.
        self.plans = {}

    def _prebuild_family(self, fam, rep: WarmReport,
                         prebuild_segments: bool) -> None:
        """Build the batch-bucket variants the router will serve with, so
        the first *coalesced* request builds nothing."""
        for b in BATCH_BUCKETS:
            if b > self.router.max_batch:
                break
            plan = fam.plan_for(self.mesh, (b,))
            rep.batch_plans += 1
            if prebuild_segments:
                rep.segments_prebuilt += len(plan.segments())

    def warm(self, *, platform: Optional[str] = None,
             ops: Sequence[str] = ("fft",), prebuild_segments: bool = True,
             ensure: Sequence[Tuple] = ()) -> WarmReport:
        """One warming pass; safe to re-run (idempotent on the caches).

        ``ensure`` entries are ``(grid, kinds)`` or ``(grid, kinds,
        dtype_name)`` problems to seed as heuristic router families when no
        wisdom covers them.
        """
        rep = WarmReport()
        t0 = self.timer()
        if self.cache is not None:
            cands = warm_candidates(self.cache, self.mesh,
                                    platform=platform, ops=ops,
                                    backends=self.backends)
            rep.candidates = len(cands)
            for prob in cands:
                try:
                    plan = plan_fft(self.mesh, prob["grid"],
                                    kinds=prob["kinds"],
                                    batch_shape=prob["batch_shape"],
                                    dtype=getattr(torch, prob["dtype"]),
                                    tuned=prob["tuned"])
                    if prebuild_segments:
                        rep.segments_prebuilt += len(plan.segments())
                except (ValueError, TypeError, AttributeError):
                    # Foreign or stale wisdom must never block startup.
                    rep.skipped.append(prob["key"])
                    continue
                self.plans[(prob["grid"], prob["kinds"], prob["dtype"],
                            prob["batch_shape"])] = plan
                rep.warmed += 1
                if self.router is not None and not prob["batch_shape"]:
                    fam = self.router.register_family(
                        prob["grid"], prob["kinds"], prob["dtype"],
                        prob["tuned"], source="wisdom")
                    rep.families += 1
                    self._prebuild_family(fam, rep, prebuild_segments)
        if self.router is not None:
            for item in ensure:
                grid, kinds = tuple(item[0]), tuple(item[1])
                dtype = (str(item[2]) if len(item) > 2 else
                         ("complex64" if all(k == "fft" for k in kinds)
                          else "float32"))
                if self.router.family_key(grid, kinds, dtype) not in \
                        self.router.families:
                    fam, _ = self.router.resolve_family(grid, kinds, dtype)
                    rep.ensured += 1
                    self._prebuild_family(fam, rep, prebuild_segments)
        rep.seconds = self.timer() - t0
        return rep
