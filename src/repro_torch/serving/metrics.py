"""Serving metrics spine: everything the service layer measures, in one
JSON-dumpable object (the port's copy of the JAX package's
``serving/metrics.py``, with the same JSON keys).

Four families of numbers:

* **plan-cache health** — how often a request is admitted to an
  already-resolved plan family (``plan_hits``/``plan_misses`` at the
  router, plus the two in-process plan-cache layers of the port's
  ``core.api.plan_cache_stats()``);
* **latency** — per-request submit-to-done wall seconds, reported as
  p50/p95/p99 (and split normal vs degraded);
* **degraded-mode throughput** — requests/s completed while serving on a
  survivors-only mesh after a device loss;
* **stragglers** — watchdog-flagged segment count (per-hop attribution
  lives on the executor; the count is the serving-level signal).

Thread-safe; ``timer`` is injectable so tests drive a fake clock.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple


def percentile(samples: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 on no samples."""
    if not samples:
        return 0.0
    xs = sorted(samples)
    rank = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[rank]


class ServingMetrics:
    def __init__(self, timer: Callable[[], float] = time.perf_counter):
        self._timer = timer
        self._lock = threading.Lock()
        # Router / admission counters.
        self.requests_submitted = 0
        self.requests_completed = 0
        self.plan_hits = 0
        self.plan_misses = 0
        self.padded_requests = 0
        self.batches_dispatched = 0
        # Routed batches by bucket grid, keyed "1024x2048".
        self.batches_by_grid: Dict[str, int] = {}
        self.retunes_enqueued = 0
        self.retunes_completed = 0
        # Fault / degradation counters.
        self.device_loss_events = 0
        self.straggler_count = 0
        # Static-verifier and sanitizer findings per rule code (ALIAS002,
        # SCHED004, ...), fed by the executor's verify_sink when the
        # service runs with verify="warn" or "strict".
        self.verify_findings: Dict[str, int] = {}
        # Samples.
        self._latencies: List[Tuple[float, bool]] = []  # (seconds, degraded)
        self._queue_depths: List[int] = []
        # Degraded-mode window: set by mark_degraded(); completions while
        # degraded feed the degraded throughput rate.
        self._degraded_since: Optional[float] = None
        self._degraded_completed = 0
        self._degraded_last_done: Optional[float] = None

    # -- admission ----------------------------------------------------------

    def record_submit(self, n: int = 1) -> None:
        with self._lock:
            self.requests_submitted += n

    def record_plan_hit(self, n: int = 1) -> None:
        with self._lock:
            self.plan_hits += n

    def record_plan_miss(self, n: int = 1) -> None:
        with self._lock:
            self.plan_misses += n

    def record_padded(self, n: int = 1) -> None:
        with self._lock:
            self.padded_requests += n

    def record_batch(self, n: int = 1, grids=()) -> None:
        """``n`` routed batches; ``grids`` their bucket grids, where
        known."""
        with self._lock:
            self.batches_dispatched += n
            for g in grids:
                key = "x".join(map(str, g))
                self.batches_by_grid[key] = \
                    self.batches_by_grid.get(key, 0) + 1

    def record_retune(self, *, completed: bool = False) -> None:
        with self._lock:
            if completed:
                self.retunes_completed += 1
            else:
                self.retunes_enqueued += 1

    def record_queue_depth(self, depth: int) -> None:
        with self._lock:
            self._queue_depths.append(int(depth))

    # -- completion ---------------------------------------------------------

    def record_done(self, latency_s: float) -> None:
        with self._lock:
            degraded = self._degraded_since is not None
            self.requests_completed += 1
            self._latencies.append((float(latency_s), degraded))
            if degraded:
                self._degraded_completed += 1
                self._degraded_last_done = self._timer()

    # -- fault events -------------------------------------------------------

    def mark_degraded(self) -> None:
        """A device-loss event put the service into degraded mode."""
        with self._lock:
            self.device_loss_events += 1
            if self._degraded_since is None:
                self._degraded_since = self._timer()

    def record_stragglers(self, total_flagged: int) -> None:
        """Absolute flagged count from the watchdog (monotonic)."""
        with self._lock:
            self.straggler_count = max(self.straggler_count,
                                       int(total_flagged))

    def record_verify_findings(self, report) -> None:
        """Count one verify/sanitize report's findings per rule code.

        ``report`` is a :class:`~repro_torch.analysis.DiagnosticReport`
        (or any iterable of objects with a ``code``); wired as the
        executor's ``verify_sink`` so ``verify="warn"`` drains land here
        instead of in ``warnings.warn``.
        """
        with self._lock:
            for d in report:
                code = getattr(d, "code", str(d))
                self.verify_findings[code] = \
                    self.verify_findings.get(code, 0) + 1

    # -- report -------------------------------------------------------------

    @property
    def plan_hit_rate(self) -> float:
        with self._lock:
            total = self.plan_hits + self.plan_misses
            return self.plan_hits / total if total else 0.0

    def latency_percentiles(self, *, degraded: Optional[bool] = None
                            ) -> Dict[str, float]:
        with self._lock:
            xs = [s for s, d in self._latencies
                  if degraded is None or d == degraded]
        return {"p50_s": percentile(xs, 50), "p95_s": percentile(xs, 95),
                "p99_s": percentile(xs, 99), "n": len(xs)}

    def degraded_throughput_rps(self) -> float:
        """Requests/s completed while degraded (0.0 before any loss)."""
        with self._lock:
            if self._degraded_since is None or not self._degraded_completed:
                return 0.0
            end = (self._degraded_last_done
                   if self._degraded_last_done is not None
                   else self._timer())
            span = max(end - self._degraded_since, 1e-9)
            return self._degraded_completed / span

    def to_json(self) -> Dict[str, Any]:
        """One JSON-serializable snapshot of every serving signal.

        Includes the port's in-process plan-cache counters
        (``core.api.plan_cache_stats``: the built-pipeline LRU under
        ``"compiled"`` and the wrappers' plan memo under ``"memo"``).
        """
        from ..core.api import plan_cache_stats
        with self._lock:
            depths = list(self._queue_depths)
            snap = {
                "requests": {
                    "submitted": self.requests_submitted,
                    "completed": self.requests_completed,
                },
                "plan_cache": {
                    "hits": self.plan_hits,
                    "misses": self.plan_misses,
                    "padded_requests": self.padded_requests,
                    "batches_dispatched": self.batches_dispatched,
                    "retunes_enqueued": self.retunes_enqueued,
                    "retunes_completed": self.retunes_completed,
                },
                "faults": {
                    "device_loss_events": self.device_loss_events,
                    "stragglers_flagged": self.straggler_count,
                    "degraded": self._degraded_since is not None,
                },
                "verify_warnings": dict(self.verify_findings),
            }
        snap["plan_cache"]["hit_rate"] = self.plan_hit_rate
        snap["queue_depth"] = {
            "max": max(depths) if depths else 0,
            "mean": (sum(depths) / len(depths)) if depths else 0.0,
        }
        snap["latency"] = self.latency_percentiles()
        snap["latency_normal"] = self.latency_percentiles(degraded=False)
        snap["latency_degraded"] = self.latency_percentiles(degraded=True)
        snap["degraded_throughput_rps"] = self.degraded_throughput_rps()
        snap["process_plan_caches"] = plan_cache_stats()
        return snap

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")
