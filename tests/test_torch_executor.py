"""The plan-stream executor of the port (``core/executor.py``) against the
JAX package's.

* Pricing and placement: for the same mixed queue on a 2x2 mesh and one
  machine model, every segment's kind, cost, boundary bytes and lane, and
  the dispatch order (``last_schedule`` tags), equal the JAX executor's on
  4 fake XLA devices.
* 4 gloo ranks: a mixed queue (two batched 2-D entries, a chunked 3-D
  forward on the kernel backend and its inverse) returns every entry
  bitwise equal to its solo run in the async, pool and timed modes (the
  pool mode's turns keep the collective order the same on every rank);
  donation empties the donated operand only.
* In-process (one CPU rank): argument checks, the analysis hooks on an
  idle executor (``tests/test_torch_analysis.py`` tests them in full),
  simulator validation, profile and watchdog timing
  with a fake clock, ``execute_many`` and the plan-level methods, and the
  launch counters under concurrent updates.
"""
import json
import os
import sys
import threading

import pytest
import torch

from repro_torch.compat import Mesh, make_mesh
from repro_torch.core.api import plan_fft
from repro_torch.core.executor import PlanStreamExecutor, execute_many
from repro_torch.core.perfmodel import CPU_CORE
from repro_torch.core.pipeline import n_segments
from repro_torch.distributed.fault import StepWatchdog
from repro_torch.kernels import ops
from torch_harness import cplx, run_ranks, run_reference

NAMES = ("data", "model")


def _cpu_mesh():
    return make_mesh((1, 1), NAMES, device="cpu")


def _mini_queue(mesh):
    """One batched 2-D plan twice and one 3-D plan."""
    p2d = plan_fft(mesh, (8, 8), batch_shape=(3,))
    p3d = plan_fft(mesh, (4, 4, 8), backend="kernel")
    return [(p2d, torch.from_numpy(cplx((3, 8, 8), 1))),
            (p2d, torch.from_numpy(cplx((3, 8, 8), 2))),
            (p3d, torch.from_numpy(cplx((4, 4, 8), 3)))]


class FakeClock:
    def __init__(self, steps):
        self.t, self.steps, self.i = 0.0, list(steps), 0

    def __call__(self):
        self.t += self.steps[self.i % len(self.steps)]
        self.i += 1
        return self.t


# ---------------------------------------------------------------------------
# Pricing and dispatch order against the JAX executor (2x2 mesh)
# ---------------------------------------------------------------------------

PRICING = """
import json, warnings
import numpy as np, jax.numpy as jnp
from repro.compat import AxisType, make_mesh
from repro.core.api import plan_fft
from repro.core.executor import PlanStreamExecutor
from repro.core.perfmodel import CPU_CORE
warnings.simplefilter("ignore")
mesh = make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
p2d = plan_fft(mesh, (8, 8), batch_shape=(4,), precompiled=False)
p3d = plan_fft(mesh, (8, 8, 16), n_chunks=(4, 2), precompiled=False)
pmm = plan_fft(mesh, (16, 8, 8), backend="matmul", decomp="slab",
               precompiled=False)
ex = PlanStreamExecutor(n_streams={n!r}, machine=CPU_CORE)
z = lambda s: jnp.zeros(s, jnp.complex64)
ex.submit(p2d, z((4, 8, 8)))
ex.submit(p2d, z((4, 8, 8)))
ex.submit(p3d, z((8, 8, 16)))
ex.submit(p3d, z((8, 8, 16)), inverse=True)
ex.submit(pmm, z((16, 8, 8)))
order = ex._plan_schedule()
print("JSON" + json.dumps([[s.tag, s.kind, s.cost_s, s.bytes_out, s.stream]
                           for s in order]))
"""


@pytest.mark.parametrize("n_streams", [2, 3])
def test_pricing_and_order_match_reference(n_streams):
    out = run_reference(PRICING.format(n=n_streams), devices=4)
    want = json.loads(next(ln for ln in out.splitlines()
                           if ln.startswith("JSON"))[4:])
    mesh = Mesh(NAMES, (2, 2), (0, 0), torch.device("cpu"),
                {n: None for n in NAMES})
    p2d = plan_fft(mesh, (8, 8), batch_shape=(4,))
    p3d = plan_fft(mesh, (8, 8, 16), n_chunks=(4, 2))
    pmm = plan_fft(mesh, (16, 8, 8), backend="matmul", decomp="slab")
    ex = PlanStreamExecutor(n_streams=n_streams, machine=CPU_CORE)
    z = torch.zeros
    ex.submit(p2d, z((4, 8, 8), dtype=torch.complex64))
    ex.submit(p2d, z((4, 8, 8), dtype=torch.complex64))
    ex.submit(p3d, z((8, 8, 16), dtype=torch.complex64))
    ex.submit(p3d, z((8, 8, 16), dtype=torch.complex64), inverse=True)
    ex.submit(pmm, z((16, 8, 8), dtype=torch.complex64))
    got = [[s.tag, s.kind, s.cost_s, s.bytes_out, s.stream]
           for s in ex._plan_schedule()]
    assert [g[0] for g in got] == [w[0] for w in want]      # dispatch order
    for g, w in zip(got, want):
        assert g[1] == w[1] and g[3:] == w[3:], (g, w)
        assert g[2] == pytest.approx(w[2], rel=1e-12), (g, w)
    assert {g[1] for g in got} == {"comp", "comm"}


# ---------------------------------------------------------------------------
# 4 gloo ranks: the mixed queue in every mode, donation across entries
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("executor"))
    out = run_ranks("executor_body", 4, root, "cpu")
    recs = []
    for rank in range(4):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            recs.append(json.load(f))
    return recs


@pytest.mark.parametrize("mode", ["async", "pool", "timed"])
def test_mixed_queue_bitwise_equal_to_solo_on_four_ranks(gloo, mode):
    for rec in gloo:
        assert rec[mode] == [True] * 4


def test_donation_across_entries_on_four_ranks(gloo):
    for rec in gloo:
        assert rec["donation"] == {"donated_emptied": True,
                                   "neighbours_intact": True,
                                   "outputs_bitwise": True}


# ---------------------------------------------------------------------------
# In-process: one CPU rank
# ---------------------------------------------------------------------------

def test_executor_rejects_bad_mode_and_deferred_hooks():
    """Bad knobs raise; the analysis hooks take their arguments, and on
    an idle executor report nothing."""
    with pytest.raises(ValueError, match="mode must be one of"):
        PlanStreamExecutor(mode="eager")
    with pytest.raises(ValueError, match="verify must be one of"):
        PlanStreamExecutor(verify="loud")
    for kw in ({"verify": "warn"}, {"verify": "strict"}, {"sanitize": True},
               {"serialize_dispatch": False},
               {"verify_sink": lambda r: None}):
        ex = PlanStreamExecutor(**kw)
        assert len(ex.verify_schedule()) == 0
        assert ex.run() == []
    ex = PlanStreamExecutor()
    assert ex.last_verify_report() is None
    assert ex.last_sanitize_report() is None and ex.last_trace() is None
    assert ex.sanitize_json() == {"trace": None, "diff": {
        "count": 0, "san001": 0, "diagnostics": []}}


def test_submit_validates_operand_shape_and_donation():
    ex = PlanStreamExecutor()
    plan = plan_fft(_cpu_mesh(), (8, 8))
    with pytest.raises(ValueError, match="operand shape"):
        ex.submit(plan, torch.zeros((4, 4), dtype=torch.complex64))
    plan.shared = True
    with pytest.raises(ValueError, match="shared"):
        ex.submit(plan, torch.zeros((8, 8), dtype=torch.complex64),
                  donate=True)
    assert len(ex) == 0  # nothing enqueued by the failed submits


def test_segment_pricing_and_dispatch_order():
    """Every entry decomposes into n_stages priced segments; the merge
    keeps each entry's segment order, dispatches every segment once and
    opens with a compute segment."""
    entries = _mini_queue(_cpu_mesh())
    ex = PlanStreamExecutor(n_streams=2)
    for plan, x in entries:
        ex.submit(plan, x)
    order = ex._plan_schedule()
    expect = {i: n_segments(plan.pipeline_spec())
              for i, (plan, _) in enumerate(entries)}
    seen = [(s.entry, s.index) for s in order]
    assert sorted(seen) == [(i, j) for i in expect for j in range(expect[i])]
    assert order[0].kind == "comp"
    heads = {}
    for s in order:
        assert s.index == heads.get(s.entry, 0)
        heads[s.entry] = s.index + 1
        assert s.cost_s > 0.0 and s.bytes_out > 0
    assert {s.stream for s in order} <= {0, 1}


def test_run_reports_simulator_validation_and_reuses_the_executor():
    entries = _mini_queue(_cpu_mesh())
    ex = PlanStreamExecutor(n_streams=2)
    for plan, x in entries:
        ex.submit(plan, x)
    outs = ex.run()
    pred = ex.report()["predicted"]
    assert pred["wall_s"] > 0.0
    assert pred["wall_s"] <= pred["serial_s"] * (1 + 1e-9)
    assert 0.0 < pred["overlap_efficiency"] <= 1.0 + 1e-9
    assert len(pred["events"]) == len(ex.last_schedule)
    assert len(ex) == 0
    for plan, x in entries:
        ex.submit(plan, x)
    again = ex.run()
    assert all(torch.equal(a, b) for a, b in zip(outs, again))


def test_profile_mode_records_segment_times_with_a_fake_clock():
    entries = _mini_queue(_cpu_mesh())
    ex = PlanStreamExecutor(profile=True, timer=FakeClock([0.001]))
    for plan, x in entries:
        ex.submit(plan, x)
    ex.run()
    rep = ex.report()
    times = rep["segment_times"]
    assert set(times) == {s.tag for s in ex.last_schedule}
    assert all(t == pytest.approx(0.001) for t in times.values())
    assert rep["measured"]["wall_s"] > 0.0
    per_entry = ex.entry_times()
    assert per_entry["entry2"] == pytest.approx(
        0.001 * n_segments(entries[2][0].pipeline_spec()))


def test_watchdog_steps_and_stragglers_with_a_fake_clock():
    """Every segment is one watchdog step; a segment 10x slower than the
    rolling median is flagged and named by its tag."""
    mesh = _cpu_mesh()
    plan = plan_fft(mesh, (8, 8), batch_shape=(2,))
    x = torch.from_numpy(cplx((2, 8, 8), 4))
    # executor reads the clock around each segment, the watchdog at its
    # start/stop: 4 reads per segment; segment 9 takes 10x longer
    steps = []
    for seg in range(10):
        dt = 0.010 if seg == 9 else 0.001
        steps += [0.0, 0.0, dt, 0.0]
    clock = FakeClock(steps)
    wd = StepWatchdog(tolerance=2.0, timer=clock)
    ex = PlanStreamExecutor(watchdog=wd, timer=clock)
    for _ in range(5):
        ex.submit(plan, x)
    ex.run()
    assert len(ex.last_schedule) == 10
    assert len(wd.durations) == 9 and len(wd.flagged) == 1
    tag, dt = ex.stragglers[0]
    assert tag == ex.last_schedule[9].tag
    assert dt == pytest.approx(0.010)
    assert PlanStreamExecutor().stragglers == []


def test_predict_entry_time_positive():
    plan = plan_fft(_cpu_mesh(), (4, 4, 8))
    ex = PlanStreamExecutor()
    assert ex.predict_entry_time(plan) > 0.0
    assert ex.predict_entry_time(plan, inverse=True) > 0.0


@pytest.mark.parametrize("mode", ["async", "pool", "timed"])
def test_execute_many_single_rank_parity(mode):
    entries = _mini_queue(_cpu_mesh())
    solo = [plan.forward(x) for plan, x in entries]
    outs = execute_many(entries, mode=mode)
    for got, want in zip(outs, solo):
        assert torch.equal(got, want)


def test_plan_submit_and_execute_many_methods():
    (p2d, xa), (_, xb), (p3d, y3) = _mini_queue(_cpu_mesh())
    ex = PlanStreamExecutor()
    assert p2d.submit(xa, executor=ex) == 0
    assert p2d.submit(xb, executor=ex) == 1
    assert p3d.submit(y3, executor=ex) == 2
    outs = ex.run()
    for plan, x, got in [(p2d, xa, outs[0]), (p2d, xb, outs[1]),
                         (p3d, y3, outs[2])]:
        assert torch.equal(got, plan.forward(x))
    many = p2d.execute_many([xa, xb])
    assert torch.equal(many[0], outs[0]) and torch.equal(many[1], outs[1])


def test_donated_operand_is_emptied_and_neighbours_stay():
    plan = plan_fft(_cpu_mesh(), (8, 16))
    xs = [torch.from_numpy(cplx((8, 16), 10 + i)) for i in range(3)]
    keep = [x.clone() for x in xs]
    solo = [plan.forward(x) for x in keep]
    outs = plan.execute_many(xs[:1]) + \
        execute_many([(plan, xs[1], {"donate": True}), (plan, xs[2])])
    assert xs[1].numel() == 0
    assert torch.equal(xs[0], keep[0]) and torch.equal(xs[2], keep[2])
    assert all(torch.equal(g, w) for g, w in zip(outs, solo))
    # a view's storage belongs to its base: the base stays intact
    base = torch.from_numpy(cplx((2, 8, 16), 20))
    snap = base.clone()
    out = execute_many([(plan, base[1], {"donate": True})])[0]
    assert torch.equal(base, snap)
    assert torch.equal(out, plan.forward(snap[1]))


def test_pool_mode_failure_is_raised_not_hung():
    plan = plan_fft(_cpu_mesh(), (8, 8))
    bad = plan_fft(_cpu_mesh(), (8, 16))
    ex = PlanStreamExecutor(mode="pool")
    ex.submit(plan, torch.from_numpy(cplx((8, 8), 5)))
    ex.submit(bad, torch.from_numpy(cplx((8, 16), 6)))
    boom = RuntimeError("segment failed")

    def failing(x):
        raise boom

    segs = bad.segments()
    keep = segs[0]
    segs[0] = failing
    try:
        with pytest.raises(RuntimeError, match="segment failed"):
            ex.run()
    finally:
        segs[0] = keep
    assert torch.equal(
        execute_many([(bad, torch.from_numpy(cplx((8, 16), 6)))])[0],
        bad.forward(torch.from_numpy(cplx((8, 16), 6))))


def test_line_copy_counter_is_exact_under_threads():
    """``ops.copies`` is updated from the executor's pool threads: many
    threads copying lines at once lose no update."""
    x = torch.from_numpy(cplx((6, 20, 12), 7))[:, ::2]   # not dense
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    n_threads, per_thread = 16, 40
    start = ops.copies["lines"]
    try:
        threads = [threading.Thread(
            target=lambda: [ops.fft1d(x, 2) for _ in range(per_thread)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert ops.copies["lines"] - start == n_threads * per_thread


def test_executor_needs_the_gpu_for_a_default_mesh():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh((1, 1), NAMES)
