"""Straggler detection and elastic-mesh utilities (the port's own copy of
the JAX package's ``distributed/fault.py``: pure Python).

``StepWatchdog`` — flags steps (and, in multi-process deployments, ranks)
whose duration exceeds ``tolerance`` x the rolling median; the training loop
uses it to log stragglers and to trigger an early checkpoint when
persistent slowdown suggests imminent preemption.  Flagged samples are
**excluded** from the rolling window: if they fed the median, a sustained
slowdown would re-normalize it and stop being flagged after ~window/2
steps — exactly the failure mode a watchdog exists to keep visible.
``reset_window()`` is the intentional escape hatch for a *legitimate*
baseline change (e.g. re-planning onto a degraded mesh, where every step
is expected to slow down).

``choose_mesh_shape`` — elastic scaling: given however many devices survive
a failure, pick the largest (data, model) grid that (a) keeps the model
axis at its required size and (b) wastes at most the remainder ranks.

``choose_fft_mesh_shape`` — the FFT-serving variant: an FFT mesh has no
architecture-fixed axis, but every mesh-axis size must divide the grid
dims it will shard, so degraded re-planning maximizes surviving devices
*subject to divisibility* and prefers the most balanced factorization
(fewest elements moved per transpose hop).
"""
from __future__ import annotations

import collections
import statistics
import time
from typing import Callable, List, Optional, Sequence, Tuple


class StepWatchdog:
    """Rolling-median straggler detector.

    ``timer`` is injectable (tests pass a fake monotone clock, the same
    hermetic-timing philosophy as ``perfmodel.calibrate``).
    """

    def __init__(self, tolerance: float = 2.0, window: int = 32,
                 timer: Callable[[], float] = time.perf_counter):
        self.tolerance = tolerance
        self.timer = timer
        self.durations: collections.deque = collections.deque(maxlen=window)
        self.flagged: List[Tuple[int, float]] = []
        self._t0: Optional[float] = None
        self._step = 0

    def start(self, step: int) -> None:
        self._step = step
        self._t0 = self.timer()

    def stop(self) -> Optional[float]:
        """Returns the step duration; records a straggler flag if slow.

        Flagged durations never enter the rolling window: the median must
        keep describing *normal* steps, so a persistent 5x slowdown stays
        flagged on every step instead of becoming the new normal once
        half the window is poisoned.
        """
        if self._t0 is None:
            return None
        dt = self.timer() - self._t0
        self._t0 = None
        if len(self.durations) >= 8:
            med = statistics.median(self.durations)
            if dt > self.tolerance * med:
                self.flagged.append((self._step, dt))
                return dt
        self.durations.append(dt)
        return dt

    def reset_window(self) -> None:
        """Drop the rolling window (keeps the flag history).

        For deliberate baseline shifts — e.g. serving re-planned onto a
        degraded mesh, where every subsequent step is legitimately slower
        and should seed a fresh median rather than all be flagged.
        """
        self.durations.clear()

    @property
    def median_s(self) -> Optional[float]:
        return statistics.median(self.durations) if self.durations else None


def choose_mesh_shape(n_devices: int, model_parallel: int,
                      pod_size: Optional[int] = None) -> Tuple[int, ...]:
    """Largest usable (pods?, data, model) grid for ``n_devices``.

    model_parallel is fixed by the arch (TP degree); data absorbs the rest.
    With ``pod_size`` given, devices group into full pods first.
    """
    if n_devices < model_parallel:
        raise ValueError("not enough devices for the model-parallel degree")
    if pod_size:
        pods = n_devices // pod_size
        if pods >= 2:
            data = pod_size // model_parallel
            return (pods, data, model_parallel)
        n_devices = min(n_devices, pod_size)
    data = n_devices // model_parallel
    return (data, model_parallel)


def choose_fft_mesh_shape(n_devices: int,
                          grid: Optional[Sequence[int]] = None
                          ) -> Tuple[int, int]:
    """Largest feasible 2-axis (data, model) mesh shape for FFT serving.

    Unlike :func:`choose_mesh_shape`, no axis size is fixed by the model
    architecture — the constraint is the *grid*: a pencil/hybrid FFT
    decomposition needs every mesh-axis size to divide the grid dims it
    shards, and a serving mesh is shared by many grids, so the conservative
    contract here is that both axis sizes divide **every** grid dim.
    Picks the largest usable device count ``d * m <= n_devices`` under
    that constraint, then the most balanced ``(d, m)`` factorization
    (minimum per-hop transpose fan-out), tie-broken toward
    ``data >= model``.  ``grid=None`` drops the divisibility constraint
    (any factorization is usable).  Degraded re-planning calls this with
    the survivors and the union of served grids.
    """
    if n_devices < 1:
        raise ValueError("choose_fft_mesh_shape needs >= 1 device")
    dims = tuple(int(n) for n in grid) if grid is not None else ()

    def feasible(k: int) -> bool:
        return all(n % k == 0 for n in dims)

    best: Optional[Tuple[int, int]] = None
    best_rank = (-1, -1)  # (devices used, balance)
    for n in range(n_devices, 0, -1):
        for m in range(1, int(n ** 0.5) + 1):
            if n % m:
                continue
            d = n // m
            if not (feasible(d) and feasible(m)):
                continue
            rank = (n, m)  # m = min(d, m): larger is more balanced
            if rank > best_rank:
                best_rank, best = rank, (d, m)
        if best is not None and best_rank[0] == n:
            return best
    return (1, 1)  # a single device always works (axis size 1 divides all)
