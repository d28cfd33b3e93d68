"""Dynamic task scheduler and chunk-schedule policy engine (paper §III-C).

The port's own copy of the JAX package's ``core/scheduler.py`` (pure
Python, no framework imports), with the same four pieces:

* ``place_tasks``        — Alg. 3: affinity-argmax placement, then a
  variance-triggered rebalancing pass that migrates queued tasks from
  overloaded to underutilized workers (scanning past an unmovable tail task
  and across source workers before giving up).
* ``WorkStealingPool``   — a thread pool with per-worker deques.  Owners
  pop from the head, thieves steal from the tail, and a steal only happens
  when the predicted idle time exceeds the LogP steal cost
  (Eq. 5–6: steal iff I_q > tau_s = L + V/B + sigma).  Victim selection is
  O(workers): per-deque running cost totals are maintained on every
  push/pop.
* ``ScheduleSimulator``  — a deterministic discrete-event model of the same
  policy (per-thread times, imbalance %, overhead fractions).
* ``choose_chunk_schedule`` / ``hop_phase_time`` — the **chunk-schedule
  policy engine** of the pipeline.  Each rank runs one static program, so
  the paper's dynamic-scheduling thesis becomes plan-time policy: for
  every redistribution hop the engine evaluates Eq. 7,

      T_phase(k) ~= max(T_comp, T_comm(k)) + (1-rho) * k * tau_s,

  over the hop's feasible chunk counts ``k`` — ``T_comm(k)`` from
  ``perfmodel``'s per-mesh-axis all_to_all alpha/beta terms, ``T_comp``
  from the downstream stage's kind-aware FFT cost, ``tau_s`` from the LogP
  :class:`CostModel` (Eq. 5) — and picks each hop's argmin independently,
  which yields a per-hop ``PipelineSpec.chunk_schedule``.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import statistics
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Task + cost model (LogP, Eq. 3-5)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TaskSpec:
    """One chunk-level FFT task."""
    fn: Optional[Callable] = None          # live execution (pool)
    args: tuple = ()
    home: int = 0                          # worker holding the input chunk
    cost: float = 1.0                      # estimated compute seconds
    data_bytes: int = 0                    # chunk size (steal transfer volume)
    tag: str = ""


@dataclasses.dataclass(frozen=True)
class CostModel:
    """LogP-style parameters (Eq. 4-5)."""
    latency_s: float = 5e-6                # L: one-way latency
    bandwidth_Bps: float = 12e9            # B: effective steal bandwidth
    steal_overhead_s: float = 2e-6         # sigma: queue mgmt + serialization

    def steal_cost(self, task: TaskSpec) -> float:
        return (self.latency_s + task.data_bytes / self.bandwidth_Bps
                + self.steal_overhead_s)

    def placement_cost(self, task: TaskSpec, worker: int) -> float:
        """Eq. 3: w_ij = C_comp + C_comm (comm is zero at the home worker)."""
        comm = 0.0 if worker == task.home else (
            self.latency_s + task.data_bytes / self.bandwidth_Bps)
        return task.cost + comm


# ---------------------------------------------------------------------------
# Alg. 3 — placement + variance-triggered rebalance
# ---------------------------------------------------------------------------

def place_tasks(tasks: Sequence[TaskSpec], n_workers: int,
                cost_model: CostModel = CostModel(),
                variance_threshold: float = 0.25,
                affinity: Optional[Callable[[TaskSpec, int], float]] = None,
                ) -> List[int]:
    """Assign each task to a worker.  Returns sigma: task index -> worker.

    Placement phase: argmax affinity (default: 1 at the home worker, 0
    elsewhere — chunk data lives where the decomposition put it).
    Correction phase: if the coefficient of variation of worker loads exceeds
    ``variance_threshold``, migrate tail tasks from the most- to the
    least-loaded worker until balanced.
    """
    if affinity is None:
        affinity = lambda t, w: 1.0 if w == t.home else 0.0

    load = [0.0] * n_workers
    queues: List[List[int]] = [[] for _ in range(n_workers)]
    sigma = [0] * len(tasks)
    for i, t in enumerate(tasks):
        # argmax affinity; ties -> least loaded (the "least-loaded unit"
        # secondary rule from Alg. 3)
        best = max(range(n_workers),
                   key=lambda w: (affinity(t, w), -load[w]))
        sigma[i] = best
        queues[best].append(i)
        load[best] += cost_model.placement_cost(t, best)

    def cv() -> float:
        m = statistics.mean(load)
        if m <= 0:
            return 0.0
        return statistics.pstdev(load) / m

    # Rebalance(sigma, W, L): greedy migration of queued tasks.  The tail
    # of the most-loaded queue is preferred (coldest data), but a tail task
    # too large to help must not end the pass: cheaper tasks earlier in
    # that queue — and queues of the next-most-loaded workers — are scanned
    # before terminating, so one oversized task cannot pin the whole
    # placement above the variance threshold.
    guard = 0
    while cv() > variance_threshold and guard < 16 * len(tasks) + 16:
        guard += 1
        dst = min(range(n_workers), key=lambda w: load[w])
        moved = False
        for src in sorted(range(n_workers), key=lambda w: -load[w]):
            if src == dst or not queues[src]:
                continue
            for pos in range(len(queues[src]) - 1, -1, -1):
                i = queues[src][pos]
                new_cost = cost_model.placement_cost(tasks[i], dst)
                if load[dst] + new_cost >= load[src]:
                    continue  # would not reduce the peak; try an earlier one
                queues[src].pop(pos)
                load[src] -= cost_model.placement_cost(tasks[i], src)
                load[dst] += new_cost
                sigma[i] = dst
                queues[dst].append(i)
                moved = True
                break
            if moved:
                break
        if not moved:
            break  # no queued task anywhere can reduce the peak load
    return sigma


# ---------------------------------------------------------------------------
# Live thread pool with work stealing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WorkerStats:
    busy_s: float = 0.0
    tasks: int = 0
    steals: int = 0
    finished_at: float = 0.0


class WorkStealingPool:
    """Per-worker deques + owner-head/thief-tail stealing (Eq. 6 gated)."""

    def __init__(self, n_workers: int, *, steal: bool = True,
                 cost_model: CostModel = CostModel(),
                 timer: Callable[[], float] = time.perf_counter):
        self.n = n_workers
        self.steal = steal
        self.cm = cost_model
        self.timer = timer
        self.deques = [collections.deque() for _ in range(n_workers)]
        # Running per-deque cost totals, updated on every push/pop: victim
        # selection is O(workers) instead of O(workers x queue) — idle
        # workers poll _try_get at ~10 us intervals under the single global
        # lock, so re-summing every victim's queue per poll serialized the
        # whole pool on the scan.
        self._costs = [0.0] * n_workers
        self.lock = threading.Lock()
        self.stats = [WorkerStats() for _ in range(n_workers)]
        self._pending = 0

    def submit(self, task: TaskSpec, worker: Optional[int] = None) -> None:
        w = task.home if worker is None else worker
        with self.lock:
            self.deques[w % self.n].append(task)
            self._costs[w % self.n] += task.cost
            self._pending += 1

    def queue_costs(self) -> List[float]:
        """Snapshot of the per-worker queued-cost totals (tests/telemetry)."""
        with self.lock:
            return list(self._costs)

    def _try_get(self, w: int) -> Optional[Tuple[TaskSpec, bool]]:
        with self.lock:
            if self.deques[w]:
                self._pending -= 1
                task = self.deques[w].popleft()
                self._costs[w] -= task.cost
                return task, False
            if not self.steal:
                return None
            # victim = max remaining load (the maintained queue cost sum)
            victim, best_load = -1, 0.0
            for v in range(self.n):
                if v == w or not self.deques[v]:
                    continue
                if self._costs[v] > best_load:
                    victim, best_load = v, self._costs[v]
            if victim < 0:
                return None
            t = self.deques[victim][-1]
            # Eq. 6: predicted idle (share of victim's backlog we would
            # otherwise wait out) must exceed the steal cost.
            idle_pred = best_load / 2.0
            if idle_pred <= self.cm.steal_cost(t):
                return None
            self.deques[victim].pop()
            self._costs[victim] -= t.cost
            self._pending -= 1
            return t, True

    def run(self) -> Dict[str, float]:
        """Execute all submitted tasks; returns aggregate timing stats."""
        t_start = self.timer()

        def worker_loop(w: int):
            st = self.stats[w]
            while True:
                got = self._try_get(w)
                if got is None:
                    with self.lock:
                        empty = self._pending == 0
                    if empty:
                        break
                    time.sleep(1e-5)
                    continue
                task, stolen = got
                t0 = self.timer()
                if task.fn is not None:
                    task.fn(*task.args)
                st.busy_s += self.timer() - t0
                st.tasks += 1
                st.steals += int(stolen)
            st.finished_at = self.timer() - t_start

        threads = [threading.Thread(target=worker_loop, args=(w,))
                   for w in range(self.n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = self.timer() - t_start
        busys = [s.busy_s for s in self.stats]
        return {
            "wall_s": wall,
            "imbalance_pct": (100.0 * statistics.pstdev(busys)
                              / max(statistics.mean(busys), 1e-12)),
            "max_thread_s": max(busys),
            "min_thread_s": min(busys),
            "steals": sum(s.steals for s in self.stats),
            "tasks": sum(s.tasks for s in self.stats),
        }


# ---------------------------------------------------------------------------
# Deterministic discrete-event simulator of the same policy
# ---------------------------------------------------------------------------

class ScheduleSimulator:
    """Event-driven model: per-worker queues, optional tail stealing.

    Virtual time, fully deterministic; reproduces the Table II experiment
    (imbalance with/without stealing) and drives Eq. 7 studies without
    needing real cores.  ``speeds[w]`` scales worker w's compute rate
    (heterogeneity knob).
    """

    def __init__(self, n_workers: int, *, steal: bool = True,
                 cost_model: CostModel = CostModel(),
                 speeds: Optional[Sequence[float]] = None):
        self.n = n_workers
        self.steal = steal
        self.cm = cost_model
        self.speeds = list(speeds) if speeds else [1.0] * n_workers

    def run(self, tasks: Sequence[TaskSpec],
            sigma: Optional[Sequence[int]] = None, *,
            trace: bool = False) -> Dict[str, float]:
        """Simulate the policy over ``tasks``.  With ``trace=True`` the
        result carries an ``events`` list of ``(start_s, worker, tag,
        stolen)`` in execution order."""
        queues: List[collections.deque] = [collections.deque()
                                           for _ in range(self.n)]
        placement = sigma if sigma is not None else [t.home for t in tasks]
        for i, t in enumerate(tasks):
            queues[placement[i] % self.n].append(t)
        events: List[Tuple[float, int, str, bool]] = []

        busy = [0.0] * self.n
        finish = [0.0] * self.n
        steals = 0
        done_tasks = [0] * self.n
        # (available_time, worker) min-heap
        heap = [(0.0, w) for w in range(self.n)]
        heapq.heapify(heap)
        remaining = len(tasks)

        def queue_load(w: int) -> float:
            return sum(t.cost / self.speeds[w] for t in queues[w])

        while remaining > 0:
            now, w = heapq.heappop(heap)
            task, stolen = None, False
            if queues[w]:
                task = queues[w].popleft()
            elif self.steal:
                victim = max((v for v in range(self.n) if queues[v]),
                             key=queue_load, default=-1)
                if victim >= 0:
                    cand = queues[victim][-1]
                    idle_pred = queue_load(victim) / 2.0
                    if idle_pred > self.cm.steal_cost(cand):
                        task = queues[victim].pop()
                        stolen = True
            if task is None:
                # Retire this worker: queue loads are monotonically
                # decreasing, so a steal that is unprofitable now (Eq. 6)
                # stays unprofitable — no need to poll again.  Owners never
                # retire with a non-empty queue, so progress is guaranteed.
                finish[w] = max(finish[w], now)
                continue
            dur = task.cost / self.speeds[w]
            if stolen:
                dur += self.cm.steal_cost(task)
                steals += 1
            if trace:
                events.append((now, w, task.tag, stolen))
            busy[w] += dur
            finish[w] = now + dur
            done_tasks[w] += 1
            remaining -= 1
            heapq.heappush(heap, (now + dur, w))

        wall = max(finish)
        mean_busy = statistics.mean(busy)
        stats = {
            "wall_s": wall,
            "imbalance_pct": (100.0 * statistics.pstdev(busy)
                              / max(mean_busy, 1e-12)),
            "max_thread_s": max(busy),
            "min_thread_s": min(busy),
            "steals": steals,
            "tasks": len(tasks),
            "avg_tasks_per_worker": len(tasks) / self.n,
            "per_worker_busy_s": busy,
        }
        if trace:
            stats["events"] = events
        return stats


def phase_time(t_comp: float, t_comm: float, k: float, tau_s: float,
               rho: float) -> float:
    """Eq. 7: T_phase ~= max(T_comp, T_comm) + (1-rho) * k * tau_s."""
    return max(t_comp, t_comm) + (1.0 - rho) * k * tau_s


# ---------------------------------------------------------------------------
# Chunk-schedule policy engine (Eq. 7 applied per redistribution hop)
# ---------------------------------------------------------------------------

def hop_phase_time(t_comp: float, t_comm_beta: float, alpha_round_s: float,
                   n_chunks: int, *, tau_s: float = 0.0,
                   overlap_floor: float = 0.0) -> float:
    """Predicted wall time of one pipelined phase (hop + next stage) at
    chunk count ``k`` — Eq. 7 on the chunked-overlap pipeline.

    ``t_comp`` is the downstream stage's local FFT time (the work a chunked
    hop can hide), ``t_comm_beta`` the hop's bandwidth term, and
    ``alpha_round_s`` the per-chunk-round latency (``alpha * (peers - 1)``
    summed over the hop's moves), so ``T_comm(k) = beta + alpha_round * k``.
    Chunking exposes ``rho = (k-1)/k`` overlap (chunk k+1's collective runs
    under chunk k's FFT), floored by the machine's intrinsic overlap; the
    unhidden ``(1-rho)`` share of the shorter side remains, and every chunk
    round pays the Eq. 5 scheduling cost ``tau_s``.
    """
    k = max(int(n_chunks), 1)
    t_comm = t_comm_beta + alpha_round_s * k
    rho = max(overlap_floor, (k - 1.0) / k if k > 1 else 0.0)
    return (phase_time(t_comp, t_comm, k, tau_s, rho)
            + (1.0 - rho) * min(t_comp, t_comm))


def choose_chunk_schedule(hop_terms: Sequence[Sequence[float]],
                          hop_candidates: Sequence[Sequence[int]], *,
                          cost_model: CostModel = CostModel(),
                          overlap_floor: float = 0.0) -> Tuple[int, ...]:
    """Per-hop argmin of :func:`hop_phase_time` — the chunk-schedule policy.

    ``hop_terms[i]`` is ``(t_comp_next_stage_s, t_comm_beta_s,
    alpha_round_s)`` for hop ``i`` (``perfmodel.hop_cost_terms`` computes
    them from the calibrated machine profile); ``hop_candidates[i]`` are
    the chunk counts feasible at that hop (``tuner.feasible_hop_chunk_
    counts``, built on ``pipeline.chunk_sites``).  Each hop chooses
    independently — that is what makes heterogeneous schedules fall out of
    asymmetric pipelines — with ties broken toward the smaller count.
    ``tau_s`` comes from the LogP :class:`CostModel` (Eq. 5 with zero
    transfer volume: the chunk's bytes are already priced in the beta
    term).
    """
    tau_s = cost_model.steal_cost(TaskSpec(data_bytes=0))
    schedule = []
    for term, counts in zip(hop_terms, hop_candidates):
        t_comp, beta, alpha = term[0], term[1], term[2]
        best_k, best_t = 1, float("inf")
        for k in sorted({max(int(c), 1) for c in counts} | {1}):
            t = hop_phase_time(t_comp, beta, alpha, k, tau_s=tau_s,
                               overlap_floor=overlap_floor)
            if t < best_t:
                best_k, best_t = k, t
        schedule.append(best_k)
    return tuple(schedule)
