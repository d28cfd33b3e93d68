"""Shape-bucketing admission front end for the FFT service.

The port's counterpart of the JAX package's ``serving/router.py``.  A
serving process cannot afford one tuning search and one plan build per
distinct request shape: traffic is long-tailed, and a cold plan costs far
more than a warm execution.  The router imposes structure:

* **Plan families** — one resolved tuning decision per (bucket grid,
  kinds, dtype).  A family holds the :class:`~..core.plan.TunedPlan`
  knobs (decomp, mesh axes, backend, chunk schedule) and lazily builds
  one ``DistributedFFT`` per *batch bucket* with ``tuning="off"`` and the
  family's knobs: batch variants never search again, because the winning
  schedule belongs to the (grid, mesh, kinds) problem, not to the leading
  batch dim.
* **Shape bucketing** — request grids round up per dim to the nearest
  bucket edge the mesh can shard (a multiple of every mesh-axis size).
  Same-bucket requests coalesce into one batched plan execution, the
  batch padded up to the next power-of-two bucket.
* **Padding and the unpad epilogue** — a padded request executes as the
  transform of its zero-padded operand on the bucket grid, and the
  epilogue crops the spectrum back to the request's own extent: an
  *interpolated-spectrum* semantic, flagged per request by
  ``FFTResult.padded``.  Callers that need the exact transform of an odd
  shape submit with ``exact=True`` and pay a family of their own.  Only
  pure-C2C pipelines pad; R2C and R2R kinds always route exact.
* **Miss fallback** — a request outside every known family resolves
  heuristically (the calibrated model's argmin: no measurement, no disk)
  and **enqueues a background re-tune**: ``run_pending_retunes`` runs the
  measured search and persists the winner, after which the family's knobs
  upgrade in place and later processes warm-start from it.

``backends`` restricts every search to those local backends (the service
of ``launch/serve_fft.py`` pins ``("kernel",)``, the hand-written CUDA
kernel); a restricted re-tune is persisted under its own wisdom key
(``tuner.tune``), never under the unrestricted problem's.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.api import DistributedFFT, _forward_plan_dtype, plan_fft
from ..core.plan import TunedPlan, TuningCache
from ..core.tuner import BACKENDS, resolve_tuned_plan, tune

DEFAULT_BUCKET_EDGES = (8, 16, 32, 64, 128, 256, 512)
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32)
_C2C_KINDS = ("fft",)


def dtype_name(dtype: torch.dtype) -> str:
    """The bare name families and wisdom keys use (``"complex64"``)."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass
class FFTRequest:
    """One admitted request: a single (batch-free) spatial operand."""
    id: int
    x: torch.Tensor               # shape == its spatial grid
    kinds: Tuple[str, ...]
    exact: bool = False           # refuse bucketing/padding for this request
    t_submit: float = dataclasses.field(default_factory=time.perf_counter)

    @property
    def grid(self) -> Tuple[int, ...]:
        return tuple(self.x.shape)


@dataclasses.dataclass
class FFTResult:
    id: int
    y: torch.Tensor
    bucket_grid: Tuple[int, ...]
    padded: bool
    plan_hit: bool
    degraded: bool
    latency_s: float


@dataclasses.dataclass
class RoutedBatch:
    """One coalesced executor entry: k member requests stacked (and padded)
    into a ``(batch_bucket, *bucket_grid)`` operand on one family plan."""
    plan: DistributedFFT
    x: torch.Tensor
    members: List[FFTRequest]
    bucket_grid: Tuple[int, ...]
    plan_hit: bool
    tag: str


class PlanFamily:
    """One tuning resolution; one plan per batch bucket, knobs shared."""

    def __init__(self, grid: Tuple[int, ...], kinds: Tuple[str, ...],
                 dtype: str, tuned: TunedPlan, source: str):
        self.grid = grid
        self.kinds = kinds
        self.dtype = dtype
        self.tuned = tuned
        self.source = source           # "wisdom" | "heuristic" | "measured"
        self.plans: Dict[Tuple[int, ...], DistributedFFT] = {}

    def plan_for(self, mesh, batch_shape: Tuple[int, ...]) -> DistributedFFT:
        plan = self.plans.get(batch_shape)
        if plan is None:
            t = self.tuned
            plan = plan_fft(
                mesh, self.grid, kinds=self.kinds, batch_shape=batch_shape,
                dtype=getattr(torch, self.dtype), decomp=t.decomp,
                backend=t.backend,
                n_chunks=(t.chunk_schedule if t.chunk_schedule is not None
                          else t.n_chunks),
                mesh_axes=t.mesh_axes, dim_groups=t.dim_groups,
                tuning="off")
            # The family's tuning evidence on the handle: describe() shows
            # why this schedule was chosen.
            plan.tuned = t
            self.plans[batch_shape] = plan
        return plan

    def retune(self, mesh, cache: Optional[TuningCache],
               backends: Sequence[str] = BACKENDS) -> None:
        """Full measured search for this family; upgrades knobs in place."""
        self.tuned = tune(self.grid, mesh, kinds=self.kinds,
                          dtype=getattr(torch, self.dtype), mode="auto",
                          cache=cache, backends=backends)
        self.source = "measured"
        self.plans.clear()  # rebuilt lazily with the upgraded knobs


class ShapeRouter:
    """Admission control: buckets, batches, plan families, miss fallback."""

    def __init__(self, mesh, *, tune_cache: Optional[TuningCache] = None,
                 bucket_edges: Sequence[int] = DEFAULT_BUCKET_EDGES,
                 max_batch: int = 8, metrics=None,
                 backends: Sequence[str] = BACKENDS):
        self.mesh = mesh
        self.tune_cache = tune_cache
        self.metrics = metrics
        self.backends = tuple(backends)
        self.max_batch = max(int(max_batch), 1)
        sizes = tuple(int(s) for s in mesh.shape)
        self._lcm = math.lcm(*sizes) if sizes else 1
        # Only edges the mesh can shard are usable buckets.
        self.bucket_edges = tuple(sorted(
            e for e in bucket_edges if e % self._lcm == 0))
        self._families: Dict[Tuple, PlanFamily] = {}
        self._retunes: List[Tuple] = []
        self._lock = threading.Lock()

    # -- bucketing ----------------------------------------------------------

    def bucket_dim(self, n: int) -> int:
        """Smallest shardable bucket edge >= n (or the next shardable
        multiple past the largest edge: huge shapes stay servable)."""
        for e in self.bucket_edges:
            if e >= n:
                return e
        return ((n + self._lcm - 1) // self._lcm) * self._lcm

    def bucket_grid(self, grid: Sequence[int], kinds: Sequence[str], *,
                    exact: bool = False) -> Tuple[int, ...]:
        """The grid a request executes on.  Pure-C2C requests round up to
        bucket edges; R2C/R2R and ``exact=True`` requests keep their own
        grid (their spectral geometry does not survive the crop)."""
        grid = tuple(int(n) for n in grid)
        if exact or any(k not in _C2C_KINDS for k in kinds):
            return grid
        return tuple(self.bucket_dim(n) for n in grid)

    def batch_bucket(self, k: int) -> int:
        """Smallest power-of-two batch >= k, capped at ``max_batch``."""
        for b in BATCH_BUCKETS:
            if b >= k:
                return min(b, self.max_batch)
        return self.max_batch

    # -- plan families ------------------------------------------------------

    def family_key(self, grid: Tuple[int, ...], kinds: Tuple[str, ...],
                   dtype: str) -> Tuple:
        return (tuple(grid), tuple(kinds), str(dtype))

    def register_family(self, grid: Tuple[int, ...],
                        kinds: Tuple[str, ...], dtype: str,
                        tuned: TunedPlan, *,
                        source: str = "wisdom") -> PlanFamily:
        """Install a resolved family (warm-start path: no search here)."""
        key = self.family_key(grid, kinds, dtype)
        with self._lock:
            fam = self._families.get(key)
            if fam is None:
                fam = PlanFamily(tuple(grid), tuple(kinds), str(dtype),
                                 tuned, source)
                self._families[key] = fam
        return fam

    def resolve_family(self, grid: Tuple[int, ...],
                       kinds: Tuple[str, ...], dtype: str
                       ) -> Tuple[PlanFamily, bool]:
        """(family, was_hit).  A miss resolves heuristically (the
        calibrated model's argmin, no measurement) and enqueues a
        background re-tune, so the measured winner lands in the wisdom
        file off the request path."""
        key = self.family_key(grid, kinds, dtype)
        with self._lock:
            fam = self._families.get(key)
        if fam is not None:
            return fam, True
        tuned = resolve_tuned_plan(grid, self.mesh, kinds=kinds,
                                   dtype=getattr(torch, dtype),
                                   mode="heuristic", cache=self.tune_cache,
                                   backends=self.backends)
        fam = self.register_family(grid, kinds, dtype, tuned,
                                   source="heuristic")
        with self._lock:
            if key not in self._retunes:
                self._retunes.append(key)
        if self.metrics is not None:
            self.metrics.record_retune()
        return fam, False

    @property
    def families(self) -> Dict[Tuple, PlanFamily]:
        with self._lock:
            return dict(self._families)

    @property
    def known_grids(self) -> Tuple[Tuple[int, ...], ...]:
        """Every family grid (degraded re-planning's divisibility input)."""
        with self._lock:
            return tuple(fam.grid for fam in self._families.values())

    def run_pending_retunes(self, max_n: Optional[int] = None) -> int:
        """Run queued background re-tunes (measured searches, persisted to
        the wisdom file); returns how many ran.  The service calls this
        between drains, off the request path."""
        ran = 0
        while max_n is None or ran < max_n:
            with self._lock:
                if not self._retunes:
                    break
                key = self._retunes.pop(0)
                fam = self._families.get(key)
            if fam is None:
                continue
            fam.retune(self.mesh, self.tune_cache, self.backends)
            ran += 1
            if self.metrics is not None:
                self.metrics.record_retune(completed=True)
        return ran

    # -- routing ------------------------------------------------------------

    def route(self, requests: Sequence[FFTRequest]) -> List[RoutedBatch]:
        """Coalesce requests into executor-ready batched entries.

        Groups by (bucket grid, kinds, dtype), stacks each group on the
        mesh's device — zero-padding odd members up to the bucket and the
        batch up to its power-of-two bucket — and attaches the family plan
        for that batch shape.  Groups larger than ``max_batch`` split.
        """
        groups: Dict[Tuple, List[FFTRequest]] = {}
        for req in requests:
            dtype = dtype_name(_forward_plan_dtype(req.x.dtype, req.kinds))
            bucket = self.bucket_grid(req.grid, req.kinds, exact=req.exact)
            groups.setdefault((bucket, tuple(req.kinds), dtype),
                              []).append(req)

        out: List[RoutedBatch] = []
        for (bucket, kinds, dtype), members in groups.items():
            fam, hit = self.resolve_family(bucket, kinds, dtype)
            if self.metrics is not None:
                (self.metrics.record_plan_hit if hit
                 else self.metrics.record_plan_miss)(len(members))
            for lo in range(0, len(members), self.max_batch):
                chunk = members[lo:lo + self.max_batch]
                b = self.batch_bucket(len(chunk))
                x = torch.zeros((b,) + bucket, dtype=getattr(torch, dtype),
                                device=self.mesh.device)
                n_padded = 0
                for i, req in enumerate(chunk):
                    if tuple(req.x.shape) != bucket:
                        n_padded += 1
                    x[(i,) + tuple(slice(0, n) for n in req.x.shape)] = req.x
                if self.metrics is not None and n_padded:
                    self.metrics.record_padded(n_padded)
                plan = fam.plan_for(self.mesh, (b,))
                tag = (f"bucket{'x'.join(map(str, bucket))}"
                       f"/b{b}/req{chunk[0].id}")
                out.append(RoutedBatch(plan=plan, x=x, members=list(chunk),
                                       bucket_grid=bucket, plan_hit=hit,
                                       tag=tag))
        return out

    @staticmethod
    def unpad(y: torch.Tensor, member: FFTRequest,
              bucket_grid: Tuple[int, ...]) -> torch.Tensor:
        """The unpad epilogue: crop one member's spectrum back to its own
        extent (identity for exact-fit members)."""
        if tuple(member.x.shape) == tuple(bucket_grid):
            return y
        return y[tuple(slice(0, n) for n in member.x.shape)]
