"""Plan caching and the plan record (the port's ``core/plan.py``).

``PlanCache`` is the JAX package's get-or-create LRU cache of built plans,
keyed by everything that changes the artifact (:func:`plan_key`).  There is
no compile step in PyTorch: an entry holds a pipeline's per-rank callable.

:class:`TunedPlan` is the record of one plan's schedule — the FFTW-wisdom
analogue, and the only state an FFT plan carries across processes.
``TunedPlan.from_json`` reads a record written by the JAX package's
``TunedPlan.to_json`` and maps its backend names (``xla`` -> ``cufft``,
``pallas`` -> ``kernel``), so both packages can plan from one record.  The
persistent wisdom file (``TuningCache``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, Optional, Tuple

from .transforms import FROM_REFERENCE_BACKEND


def env_capacity(var: str, default: int) -> int:
    """LRU capacity from an env var, clamped sane (shared by the PlanCache
    here and the wrapper plan memo in api.py)."""
    try:
        cap = int(os.environ.get(var, str(default)))
    except ValueError:
        cap = default
    return max(cap, 1)


@dataclasses.dataclass
class PlanEntry:
    executable: Any          # the per-rank pipeline callable
    build_time_s: float      # wall time spent building it
    hits: int = 0


class PlanCache:
    """Thread-safe get-or-create LRU cache of built FFT plans.

    Bounded (``$REPRO_TORCH_PLAN_CACHE_SIZE``, default 128).  Eviction drops
    this cache's reference only — a ``DistributedFFT`` that holds its
    callable keeps working; an evicted key is rebuilt on its next miss.
    """

    def __init__(self, capacity: Optional[int] = None,
                 timer: Callable[[], float] = time.perf_counter):
        self._lock = threading.Lock()
        self._plans: "OrderedDict[Hashable, PlanEntry]" = OrderedDict()
        self._capacity = capacity
        self._timer = timer
        self.misses = 0
        self.hits = 0
        self.evictions = 0

    @property
    def capacity(self) -> int:
        if self._capacity is not None:
            return max(self._capacity, 1)
        return env_capacity("REPRO_TORCH_PLAN_CACHE_SIZE", 128)

    def get_or_create(self, key: Hashable,
                      builder: Callable[[], Any]) -> PlanEntry:
        with self._lock:
            entry = self._plans.get(key)
            if entry is not None:
                entry.hits += 1
                self.hits += 1
                self._plans.move_to_end(key)
                return entry
        # Build outside the lock: a build must not serialize unrelated
        # plan lookups.
        t0 = self._timer()
        executable = builder()
        dt = self._timer() - t0
        with self._lock:
            # Another thread may have raced us; first build wins.
            entry = self._plans.get(key)
            if entry is None:
                entry = PlanEntry(executable=executable, build_time_s=dt)
                self._plans[key] = entry
                self.misses += 1
                while len(self._plans) > self.capacity:
                    self._plans.popitem(last=False)
                    self.evictions += 1
            else:
                entry.hits += 1
                self.hits += 1
            self._plans.move_to_end(key)
        return entry

    def keys(self) -> list:
        with self._lock:
            return list(self._plans)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "plans": len(self._plans),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "total_build_time_s": sum(
                    e.build_time_s for e in self._plans.values()),
            }

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
            self.hits = 0
            self.misses = 0
            self.evictions = 0


# Process-global default cache (mirrors the paper's per-process plan store).
GLOBAL_PLAN_CACHE = PlanCache()


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """The schedule of one plan (JSON-serializable)."""

    decomp: str                  # "pencil" | "slab" | "hybrid"
    mesh_axes: Tuple[str, ...]   # mesh axes the decomposition runs over
    backend: str                 # "cufft" | "matmul" | "kernel"
    n_chunks: int
    predicted_s: float           # perf-model estimate (0.0 if none)
    measured_s: float            # measured time (0.0 if none)
    source: str                  # "measured" | "heuristic" | "default"
    baseline_s: float = 0.0      # static default's time in the same run
    ts: float = 0.0              # epoch seconds when measured
    dim_groups: Optional[Tuple[Tuple[int, ...], ...]] = None
    chunk_schedule: Optional[Tuple[int, ...]] = None
    objective: str = "forward"

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["mesh_axes"] = list(self.mesh_axes)
        if self.dim_groups is None:
            d.pop("dim_groups")
        else:
            d["dim_groups"] = [list(g) for g in self.dim_groups]
        if self.chunk_schedule is None:
            d.pop("chunk_schedule")
        else:
            d["chunk_schedule"] = [int(c) for c in self.chunk_schedule]
        if self.objective == "forward":
            d.pop("objective")
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "TunedPlan":
        """Read a record of either package; reference backend names map to
        the port's (``xla`` -> ``cufft``, ``pallas`` -> ``kernel``)."""
        groups = d.get("dim_groups")
        sched = d.get("chunk_schedule")
        backend = FROM_REFERENCE_BACKEND.get(d["backend"], d["backend"])
        return cls(decomp=d["decomp"], mesh_axes=tuple(d["mesh_axes"]),
                   backend=backend, n_chunks=int(d["n_chunks"]),
                   predicted_s=float(d.get("predicted_s", 0.0)),
                   measured_s=float(d.get("measured_s", 0.0)),
                   source=d.get("source", "measured"),
                   baseline_s=float(d.get("baseline_s", 0.0)),
                   ts=float(d.get("ts", 0.0)),
                   dim_groups=(tuple(tuple(int(x) for x in g) for g in groups)
                               if groups is not None else None),
                   chunk_schedule=(tuple(int(c) for c in sched)
                                   if sched is not None else None),
                   objective=str(d.get("objective", "forward")))

    def describe(self) -> str:
        """One-line account of this schedule and where it came from."""
        from .decomp import describe_decomp  # deferred: keep plan.py light
        decomp = describe_decomp(self.decomp, self.dim_groups)
        chunks = (",".join(map(str, self.chunk_schedule))
                  if self.chunk_schedule is not None else str(self.n_chunks))
        head = (f"{decomp}({','.join(self.mesh_axes)})/{self.backend}"
                f"/chunks={chunks}")
        if self.objective != "forward":
            head += f" [{self.objective}]"
        if self.source == "measured":
            return (f"{head} [measured {self.measured_s * 1e3:.3f} ms, "
                    f"predicted {self.predicted_s * 1e3:.3f} ms, "
                    f"default baseline {self.baseline_s * 1e3:.3f} ms]")
        if self.source == "heuristic":
            return f"{head} [predicted {self.predicted_s * 1e3:.3f} ms]"
        return f"{head} [static default, untuned]"


def plan_key(*, kind: Tuple[str, ...], grid: Tuple[int, ...], dtype: str,
             decomp: Hashable, mesh_shape: Tuple[int, ...],
             mesh_axes: Tuple[str, ...], backend: str, n_chunks: Hashable,
             inverse: bool, extra: Optional[Hashable] = None) -> Hashable:
    """``n_chunks`` may be an int or a full per-hop chunk-schedule tuple —
    either way it is part of the plan's identity."""
    return (kind, grid, dtype, decomp, mesh_shape, mesh_axes, backend,
            n_chunks, inverse, extra)
