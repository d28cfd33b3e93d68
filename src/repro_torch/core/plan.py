"""Plan caching and the plan record (the port's ``core/plan.py``).

``PlanCache`` is the JAX package's get-or-create LRU cache of built plans,
keyed by everything that changes the artifact (:func:`plan_key`).  There is
no compile step in PyTorch: an entry holds a pipeline's per-rank callable.

:class:`TunedPlan` is the record of one plan's schedule — the FFTW-wisdom
analogue, and the only state an FFT plan carries across processes.
``TunedPlan.from_json`` reads a record written by the JAX package's
``TunedPlan.to_json`` and maps its backend names (``xla`` -> ``cufft``,
``pallas`` -> ``kernel``), so both packages can plan from one record.

``TuningCache`` is the persistent layer: the tuner's decisions (which
decomposition / backend / chunk schedule won for a problem key,
:func:`tuning_key`) as JSON on disk, the FFTW-wisdom analogue, plus a
``"machine"`` section with the calibrated profile per platform.  The port
keeps its own file, ``~/.cache/repro-fft-torch/tuning.json`` (or
``$REPRO_TORCH_TUNING_CACHE``), never the JAX package's;
:meth:`TuningCache.import_reference` merges a wisdom file the JAX package
wrote, with its backend names mapped.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, Optional, Sequence, Tuple

from .transforms import FROM_REFERENCE_BACKEND

try:  # POSIX advisory file locking for cross-process cache merging
    import fcntl
except ImportError:  # non-POSIX: single-writer semantics, merge still runs
    fcntl = None


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


def tuning_key(*, grid: Sequence[int], mesh_shape: Sequence[int],
               mesh_axes: Sequence[str], kinds: Sequence[str], dtype: str,
               inverse: bool, batch_shape: Sequence[int] = (),
               platform: str = "", op: str = "fft",
               backends: Sequence[str] = ()) -> str:
    """Stable string key for one tuning problem (usable as a JSON key).

    The same format as the JAX package's, so a key names one problem in
    both packages' files: ``dtype`` is the bare name (``"complex64"``),
    ``platform`` the device's name (the card's, or ``"cpu"``), and ``op``
    the measured operation — the default ``"fft"`` is omitted, the
    PoissonSolver's joint ``"fwd+scale+inv"`` gets its own key space.
    ``backends`` names a search restricted to those local backends (a
    ``be=`` part, the port's own): its winner lives under a key of its
    own and never answers an unrestricted lookup.  Empty (the default,
    omitted from the key) means the search covered every backend.
    """
    parts = [
        "grid=" + ",".join(map(str, grid)),
        "mesh=" + ",".join(map(str, mesh_shape)),
        "axes=" + ",".join(mesh_axes),
        "kinds=" + ",".join(kinds),
        "dtype=" + dtype,
        "inv=" + str(int(inverse)),
        "batch=" + ",".join(map(str, batch_shape)),
        "plat=" + platform,
    ]
    if op != "fft":
        parts.append("op=" + op)
    if backends:
        parts.append("be=" + ",".join(backends))
    return ";".join(parts)


def parse_tuning_key(key: str) -> Optional[Dict[str, Any]]:
    """Invert :func:`tuning_key`; ``None`` for a key this version cannot
    read (unknown format, missing parts) rather than raising.  A
    restricted key's dict also has ``"backends"``."""
    fields: Dict[str, str] = {}
    for part in key.split(";"):
        name, sep, val = part.partition("=")
        if not sep:
            return None
        fields[name] = val

    def ints(raw: str) -> Tuple[int, ...]:
        return tuple(int(v) for v in raw.split(",")) if raw else ()

    def strs(raw: str) -> Tuple[str, ...]:
        return tuple(raw.split(",")) if raw else ()

    try:
        prob = {
            "grid": ints(fields["grid"]),
            "mesh_shape": ints(fields["mesh"]),
            "mesh_axes": strs(fields["axes"]),
            "kinds": strs(fields["kinds"]),
            "dtype": fields["dtype"],
            "inverse": bool(int(fields["inv"])),
            "batch_shape": ints(fields["batch"]),
            "platform": fields["plat"],
            "op": fields.get("op", "fft"),
        }
    except (KeyError, ValueError):
        return None
    if "be" in fields:
        prob["backends"] = strs(fields["be"])
    return prob


def default_tuning_path() -> str:
    """``$REPRO_TORCH_TUNING_CACHE``, else
    ``$XDG_CACHE_HOME/repro-fft-torch/tuning.json`` (``~/.cache`` when
    unset)."""
    env = os.environ.get("REPRO_TORCH_TUNING_CACHE")
    if env:
        return env
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "repro-fft-torch", "tuning.json")


class TuningCache:
    """Persistent key -> :class:`TunedPlan` store (FFTW-wisdom analogue).

    ``path=None`` keeps the cache in memory only.  Writes go through an
    atomic rename, and every save re-reads and merges the file under an
    ``fcntl`` advisory lock first: two processes tuning different problems
    against one wisdom file both keep their plans (per key, the newest
    ``ts`` wins).  The ``"machine"`` section holds the calibrated
    ``MachineProfile`` JSON per platform (``get_machine``/``put_machine``).
    On a multi-rank mesh only rank 0 saves; the tuner has the other ranks
    :meth:`reload` after a barrier.
    """

    _VERSION = 1

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()
        self._plans: Dict[str, TunedPlan] = {}
        self._machines: Dict[str, Dict[str, Any]] = {}
        self.hits = 0
        self.misses = 0
        if path is not None:
            self._merge_from(self._read_file(path))

    def _read_file(self, path: str) -> Optional[Dict[str, Any]]:
        try:
            with open(path) as f:
                raw = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None
        if not isinstance(raw, dict) or raw.get("version") != self._VERSION:
            return None  # stale schema: retune rather than misread
        return raw

    def _merge_from(self, raw: Optional[Dict[str, Any]]) -> None:
        """Fold a file's contents into memory (per key, newest ts wins)."""
        if raw is None:
            return
        for k, v in raw.get("plans", {}).items():
            try:
                other = TunedPlan.from_json(v)
            except (KeyError, TypeError, ValueError):
                continue
            mine = self._plans.get(k)
            if mine is None or other.ts > mine.ts:
                self._plans[k] = other
        for plat, prof in raw.get("machine", {}).items():
            if not isinstance(prof, dict):
                continue
            mine = self._machines.get(plat)
            # Newest save wins, as for plans: a process holding a stale
            # profile must not clobber a fresher calibration.
            if mine is None or (prof.get("_saved_ts", 0.0)
                                > mine.get("_saved_ts", 0.0)):
                self._machines[plat] = prof

    def _save(self, merge: bool = True) -> None:
        # Caller holds self._lock.  merge=False wipes the file (clear()).
        if self.path is None:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        lock_file = None
        try:
            if fcntl is not None:
                try:
                    lock_file = open(self.path + ".lock", "w")
                    fcntl.flock(lock_file, fcntl.LOCK_EX)
                except OSError:
                    # No advisory locks on this filesystem: best-effort
                    # lockless merge + atomic rename.
                    if lock_file is not None:
                        lock_file.close()
                    lock_file = None
            if merge:
                self._merge_from(self._read_file(self.path))
            payload = {
                "version": self._VERSION,
                "plans": {k: p.to_json() for k, p in self._plans.items()},
                "machine": self._machines,
            }
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        finally:
            if lock_file is not None:
                fcntl.flock(lock_file, fcntl.LOCK_UN)
                lock_file.close()

    def reload(self) -> None:
        """Merge what the file holds now (another process's saves)."""
        if self.path is None:
            return
        with self._lock:
            self._merge_from(self._read_file(self.path))

    def import_reference(self, path: str) -> int:
        """Merge a wisdom file the JAX package wrote and save; returns the
        number of plans read.  Plans map their backend names as
        ``TunedPlan.from_json`` does, machine profiles as
        ``MachineProfile.from_json`` does when read; keys are kept as they
        are (both packages write one format)."""
        raw = self._read_file(path)
        with self._lock:
            self._merge_from(raw)
            self._save()
        return len(raw.get("plans", {})) if raw is not None else 0

    def get(self, key: str) -> Optional[TunedPlan]:
        with self._lock:
            plan = self._plans.get(key)
            if plan is None:
                self.misses += 1
            else:
                self.hits += 1
            return plan

    def keys(self) -> list:
        with self._lock:
            return list(self._plans)

    def put(self, key: str, plan: TunedPlan, *, save: bool = True) -> None:
        """Record ``plan``; ``save=False`` keeps it in memory only."""
        with self._lock:
            if plan.ts == 0.0:
                # An unstamped plan would lose every recency merge against
                # an on-disk entry; writing it now means it is current now.
                plan = dataclasses.replace(plan, ts=time.time())
            self._plans[key] = plan
            if save:
                self._save()

    def get_machine(self, platform: str) -> Optional[Dict[str, Any]]:
        """Raw calibrated-profile JSON for ``platform`` (or None); decoding
        is ``perfmodel.MachineProfile.from_json``'s job."""
        with self._lock:
            prof = self._machines.get(platform)
            return dict(prof) if prof is not None else None

    def put_machine(self, platform: str, profile: Dict[str, Any], *,
                    save: bool = True) -> None:
        """Persist one platform's profile JSON, stamped with ``_saved_ts``
        so concurrent processes merge on recency."""
        with self._lock:
            rec = dict(profile)
            rec.setdefault("_saved_ts", time.time())
            self._machines[platform] = rec
            if save:
                self._save()

    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)

    def items(self) -> Tuple[Tuple[str, TunedPlan], ...]:
        with self._lock:
            return tuple(self._plans.items())

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"plans": len(self._plans), "hits": self.hits,
                    "misses": self.misses, "path": self.path,
                    "machines": len(self._machines)}

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
            self._machines.clear()
            self.hits = 0
            self.misses = 0
            self._save(merge=False)


# Lazily created process-global tuning cache, at default_tuning_path().
_GLOBAL_TUNING_CACHE: Optional[TuningCache] = None
_GLOBAL_TUNING_LOCK = threading.Lock()


def global_tuning_cache() -> TuningCache:
    global _GLOBAL_TUNING_CACHE
    with _GLOBAL_TUNING_LOCK:
        if _GLOBAL_TUNING_CACHE is None:
            _GLOBAL_TUNING_CACHE = TuningCache(default_tuning_path())
        return _GLOBAL_TUNING_CACHE


def plan_key(*, kind: Tuple[str, ...], grid: Tuple[int, ...], dtype: str,
             decomp: Hashable, mesh_shape: Tuple[int, ...],
             mesh_axes: Tuple[str, ...], backend: str, n_chunks: Hashable,
             inverse: bool, extra: Optional[Hashable] = None) -> Hashable:
    """``n_chunks`` may be an int or a full per-hop chunk-schedule tuple —
    either way it is part of the plan's identity."""
    return (kind, grid, dtype, decomp, mesh_shape, mesh_axes, backend,
            n_chunks, inverse, extra)
