"""The port's scheduler (``repro_torch.core.scheduler``) against the JAX
package's on the same seeded task sets: placement, the discrete-event
simulator, Eq. 7 and the chunk-schedule policy engine must agree exactly;
the live work-stealing pool must run every task exactly once."""
import threading

import numpy as np
import pytest

from repro.core import scheduler as js
from repro_torch.core import scheduler as ts


def task_set(mod, seed: int, n_tasks: int, n_workers: int):
    """Seeded tasks of one package: skewed homes and costs, chunk bytes."""
    r = np.random.default_rng(seed)
    homes = r.choice(n_workers, size=n_tasks,
                     p=np.linspace(2.0, 0.5, n_workers)
                     / np.linspace(2.0, 0.5, n_workers).sum())
    costs = r.lognormal(0.0, 0.8, size=n_tasks)
    nbytes = r.integers(1 << 10, 64 << 20, size=n_tasks)
    return [mod.TaskSpec(home=int(h), cost=float(c), data_bytes=int(b),
                         tag=f"t{i}")
            for i, (h, c, b) in enumerate(zip(homes, costs, nbytes))]


CASES = [(0, 24, 6), (1, 40, 4), (2, 9, 3), (3, 64, 8)]
COST_MODELS = [{}, {"latency_s": 1e-3, "bandwidth_Bps": 1e8},
               {"steal_overhead_s": 1e9}]


@pytest.mark.parametrize("seed,n_tasks,n_workers", CASES)
@pytest.mark.parametrize("cm_kw", COST_MODELS)
@pytest.mark.parametrize("threshold", [0.0, 0.25])
def test_place_tasks_matches_reference(seed, n_tasks, n_workers, cm_kw,
                                       threshold):
    got = ts.place_tasks(task_set(ts, seed, n_tasks, n_workers), n_workers,
                         ts.CostModel(**cm_kw), variance_threshold=threshold)
    want = js.place_tasks(task_set(js, seed, n_tasks, n_workers), n_workers,
                          js.CostModel(**cm_kw), variance_threshold=threshold)
    assert got == want


@pytest.mark.parametrize("seed,n_tasks,n_workers", CASES)
@pytest.mark.parametrize("steal", [True, False])
@pytest.mark.parametrize("cm_kw", COST_MODELS)
def test_simulator_matches_reference(seed, n_tasks, n_workers, steal, cm_kw):
    speeds = list(np.random.default_rng(seed + 7).uniform(0.5, 2.0,
                                                          n_workers))
    tt = task_set(ts, seed, n_tasks, n_workers)
    jt = task_set(js, seed, n_tasks, n_workers)
    sigma = ts.place_tasks(tt, n_workers, ts.CostModel(**cm_kw))
    got = ts.ScheduleSimulator(n_workers, steal=steal,
                               cost_model=ts.CostModel(**cm_kw),
                               speeds=speeds).run(tt, sigma, trace=True)
    want = js.ScheduleSimulator(n_workers, steal=steal,
                                cost_model=js.CostModel(**cm_kw),
                                speeds=speeds).run(jt, sigma, trace=True)
    assert got == want
    assert got["per_worker_busy_s"] == want["per_worker_busy_s"]
    assert got["imbalance_pct"] == want["imbalance_pct"]


@pytest.mark.parametrize("seed", range(4))
def test_phase_times_match_reference(seed):
    r = np.random.default_rng(seed)
    for _ in range(50):
        comp, beta, alpha, tau = r.lognormal(-7, 2, size=4)
        rho, floor = r.uniform(0, 1, size=2)
        k = int(r.integers(1, 64))
        assert ts.phase_time(comp, beta, k, tau, rho) == \
            js.phase_time(comp, beta, k, tau, rho)
        assert ts.hop_phase_time(comp, beta, alpha, k, tau_s=tau,
                                 overlap_floor=floor) == \
            js.hop_phase_time(comp, beta, alpha, k, tau_s=tau,
                              overlap_floor=floor)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("cm_kw", COST_MODELS[:2])
def test_choose_chunk_schedule_matches_reference(seed, cm_kw):
    r = np.random.default_rng(seed)
    n_hops = int(r.integers(1, 5))
    terms = [tuple(r.lognormal(-7, 2, size=3)) for _ in range(n_hops)]
    cands = [sorted({int(2 ** e) for e in r.integers(0, 8, size=4)})
             for _ in range(n_hops)]
    floor = float(r.uniform(0, 0.5))
    got = ts.choose_chunk_schedule(terms, cands,
                                   cost_model=ts.CostModel(**cm_kw),
                                   overlap_floor=floor)
    want = js.choose_chunk_schedule(terms, cands,
                                    cost_model=js.CostModel(**cm_kw),
                                    overlap_floor=floor)
    assert got == want and len(got) == n_hops
    assert all(k in set(c) | {1} for k, c in zip(got, cands))


@pytest.mark.parametrize("steal", [True, False])
@pytest.mark.parametrize("seed,n_tasks,n_workers", CASES[:3])
def test_pool_runs_each_task_exactly_once(steal, seed, n_tasks, n_workers):
    runs = {}
    lock = threading.Lock()

    def work(i):
        with lock:
            runs[i] = runs.get(i, 0) + 1

    pool = ts.WorkStealingPool(n_workers, steal=steal)
    for i, t in enumerate(task_set(ts, seed, n_tasks, n_workers)):
        t.fn, t.args, t.cost = work, (i,), t.cost * 1e-4
        pool.submit(t)
    stats = pool.run()
    assert runs == {i: 1 for i in range(n_tasks)}
    assert stats["tasks"] == n_tasks
    assert sum(s.tasks for s in pool.stats) == n_tasks
    assert pool.queue_costs() == pytest.approx([0.0] * n_workers, abs=1e-9)
    if not steal:
        assert stats["steals"] == 0
