"""The port's serving layer (``serving/`` and ``launch/serve_fft.py``)
against the JAX package's.

* Metrics: percentiles, hit rate, degraded throughput on a fake clock and
  the JSON keys equal the reference's.
* Router: bucketing rules, mesh-feasible edges, and coalescing with
  padding (the same groups, members and stacked operands as the JAX
  router's), the padded-transform-then-crop semantic, background re-tunes.
* Warm start: ``warm_candidates`` keeps what the reference keeps; the
  warmer registers families whose first request is a hit and whose first
  drain builds no plan.
* The service on one CPU rank end to end, the watchdog's step ids across
  drains, and the ``serve_fft`` driver.
* 4 gloo ranks: ``serve_fft`` loses one rank mid-stream; the degraded
  mesh shape equals the JAX package's ``choose_fft_mesh_shape`` for the
  same survivors and grids, the post-loss stream matches a fresh
  survivors-only service bitwise, and a rank left outside the degraded
  mesh refuses work.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.distributed.fault import choose_fft_mesh_shape as ref_choose
from repro_torch.compat import make_mesh
from repro_torch.core.plan import GLOBAL_PLAN_CACHE, TunedPlan, TuningCache
from repro_torch.core.tuner import tune, warm_candidates
from repro_torch.kernels import build
from repro_torch.serving import (FFTRequest, FFTService, ServingMetrics,
                                 ShapeRouter)
from torch_harness import cplx, run_ranks

jnp = pytest.importorskip("jax.numpy")

NAMES = ("data", "model")


@pytest.fixture(autouse=True)
def _no_calibration(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_CALIBRATE", "off")
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(tmp_path / "w.json"))


def _mesh():
    return make_mesh((1, 1), NAMES, device="cpu")


def _padded_ref(x: np.ndarray, bucket) -> np.ndarray:
    xp = np.zeros(bucket, np.complex64)
    crop = tuple(slice(0, n) for n in x.shape)
    xp[crop] = x
    return np.fft.fftn(xp)[crop]


# ---------------------------------------------------------------- metrics

def test_metrics_match_reference():
    from repro.serving.metrics import ServingMetrics as RefMetrics
    from repro.serving.metrics import percentile as ref_percentile
    from repro_torch.serving.metrics import percentile
    for xs in ([1.0, 2.0, 3.0, 4.0, 5.0], [], [0.3], [5.0, 1.0, 2.5, 9.0]):
        for q in (0, 25, 50, 95, 99, 100):
            assert percentile(xs, q) == ref_percentile(xs, q)
    clocks = [{"t": 0.0}, {"t": 0.0}]
    ms = [cls(timer=lambda c=c: c["t"])
          for cls, c in zip((ServingMetrics, RefMetrics), clocks)]
    for m, clock in zip(ms, clocks):
        m.record_plan_hit(8)
        m.record_plan_miss(2)
        m.record_padded(3)
        m.record_batch(2)
        m.record_queue_depth(4)
        m.record_done(0.1)
        m.mark_degraded()
        for _ in range(10):
            clock["t"] += 0.5
            m.record_submit()
            m.record_done(0.5)
        m.record_stragglers(3)
    port, ref = (m.to_json() for m in ms)

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None
                for k, v in d.items()}

    ref_keys = keys(ref)
    port_keys = keys(port)
    assert port_keys == ref_keys
    for section in ("requests", "plan_cache", "faults", "queue_depth",
                    "latency", "latency_normal", "latency_degraded"):
        assert port[section] == ref[section]
    assert port["degraded_throughput_rps"] == pytest.approx(2.0)
    assert port["degraded_throughput_rps"] == ref["degraded_throughput_rps"]
    assert json.dumps(port)


# ----------------------------------------------------------------- router

def test_router_bucketing_matches_reference(cpu_mesh):
    from repro.serving import ShapeRouter as RefRouter
    port, ref = ShapeRouter(_mesh()), RefRouter(cpu_mesh)
    assert port.bucket_edges == ref.bucket_edges
    for n in list(range(1, 70)) + [127, 128, 129, 511, 512, 513, 600, 1000]:
        assert port.bucket_dim(n) == ref.bucket_dim(n)
    for grid, kinds, exact in [((14, 15), ("fft", "fft"), False),
                               ((14, 15), ("rfft", "fft"), False),
                               ((14, 15), ("fft", "fft"), True),
                               ((600, 3, 9), ("fft",) * 3, False),
                               ((14, 15), ("dct2", "fft"), False)]:
        assert port.bucket_grid(grid, kinds, exact=exact) == \
            ref.bucket_grid(grid, kinds, exact=exact)
    for k in range(1, 40):
        assert port.batch_bucket(k) == ref.batch_bucket(k)


def test_router_mesh_feasible_edges_match_reference():
    from repro.serving import ShapeRouter as RefRouter

    class PortMesh:
        shape = (3, 2)

    class RefMesh:
        class devices:
            shape = (3, 2)

    port = ShapeRouter(PortMesh, bucket_edges=(8, 12, 16, 24))
    ref = RefRouter(RefMesh, bucket_edges=(8, 12, 16, 24))
    assert port.bucket_edges == ref.bucket_edges == (12, 24)
    for n in (5, 13, 24, 25, 31, 100):
        assert port.bucket_dim(n) == ref.bucket_dim(n)


def test_router_coalesces_and_pads_like_reference(cpu_mesh):
    from repro.serving import FFTRequest as RefRequest
    from repro.serving import ServingMetrics as RefMetrics
    from repro.serving import ShapeRouter as RefRouter
    rng = np.random.default_rng(1)
    grids = [(16, 16), (16, 16), (14, 15), (16, 32), (13, 16), (16, 16),
             (16, 16), (15, 10), (16, 32)]
    xs = [cplx(g, 100 + i) for i, g in enumerate(grids)]
    rng.shuffle(xs)
    pm, rm = ServingMetrics(), RefMetrics()
    port = ShapeRouter(_mesh(), max_batch=4, metrics=pm)
    ref = RefRouter(cpu_mesh, max_batch=4, metrics=rm)
    got = port.route([FFTRequest(id=i, x=torch.from_numpy(x),
                                 kinds=("fft", "fft"))
                      for i, x in enumerate(xs)])
    want = ref.route([RefRequest(id=i, x=jnp.asarray(x),
                                 kinds=("fft", "fft"))
                      for i, x in enumerate(xs)])
    assert [(b.bucket_grid, [m.id for m in b.members], b.plan_hit, b.tag)
            for b in got] == \
        [(b.bucket_grid, [m.id for m in b.members], b.plan_hit, b.tag)
         for b in want]
    for g, w in zip(got, want):
        assert np.array_equal(g.x.numpy(), np.asarray(w.x))
        assert g.plan.batch_shape == w.plan.batch_shape
        y = g.plan.forward(g.x)
        for i, req in enumerate(g.members):
            yi = ShapeRouter.unpad(y[i], req, g.bucket_grid).numpy()
            np.testing.assert_allclose(
                yi, _padded_ref(req.x.numpy(), g.bucket_grid),
                rtol=1e-4, atol=1e-3)
    for attr in ("plan_hits", "plan_misses", "padded_requests",
                 "retunes_enqueued"):
        assert getattr(pm, attr) == getattr(rm, attr), attr
    port.route([FFTRequest(id=0, x=torch.from_numpy(xs[0]),
                           kinds=("fft", "fft"))])
    assert pm.plan_hits == 1


def test_router_background_retune_upgrades_family(tmp_path):
    cache = TuningCache(str(tmp_path / "wisdom.json"))
    r = ShapeRouter(_mesh(), tune_cache=cache)
    req = FFTRequest(id=0, x=torch.from_numpy(cplx((8, 8), 2)),
                     kinds=("fft", "fft"))
    r.route([req])
    fam = next(iter(r.families.values()))
    assert fam.source == "heuristic"         # miss path: model-only knobs
    assert r.run_pending_retunes(max_n=1) == 1
    assert fam.source == "measured"          # measured winner, persisted
    assert not fam.plans                     # variants rebuild lazily
    assert r.run_pending_retunes() == 0      # queue drained
    assert cache.items()                     # the wisdom file has the winner
    # a router restricted to one backend searches only that backend
    pinned = ShapeRouter(_mesh(), tune_cache=TuningCache(),
                         backends=("kernel",))
    pinned.route([req])
    assert next(iter(pinned.families.values())).tuned.backend == "kernel"


# ------------------------------------------------------------- warm start

def test_warm_candidates_filters_like_reference():
    from repro.core.plan import TunedPlan as RefTunedPlan
    from repro.core.plan import TuningCache as RefCache
    from repro.core.tuner import warm_candidates as ref_warm
    from repro_torch.core.plan import tuning_key

    class RefMesh:
        axis_names = NAMES

        class devices:
            shape = (1, 1)

    def key(mesh_shape=(1, 1), platform="cpu", inverse=False, op="fft",
            axes=NAMES, backends=()):
        return tuning_key(grid=(8, 8), mesh_shape=mesh_shape, mesh_axes=axes,
                          kinds=("fft", "fft"), dtype="complex64",
                          inverse=inverse, platform=platform, op=op,
                          backends=backends)

    keys = [key(), key(mesh_shape=(4, 2)), key(platform="NVIDIA H100"),
            key(inverse=True), key(op="fwd+scale+inv"),
            key(axes=NAMES[::-1]), "not;a;tuning;key"]
    fields = dict(decomp="slab", mesh_axes=NAMES, n_chunks=1,
                  predicted_s=1e-3, measured_s=1e-3, source="measured")
    port, ref = TuningCache(), RefCache(path=None)
    for k in keys:
        port.put(k, TunedPlan(backend="cufft", **fields), save=False)
        ref.put(k, RefTunedPlan(backend="xla", **fields))
    got = warm_candidates(port, _mesh())
    want = ref_warm(ref, RefMesh, platform="cpu")
    assert [c["key"] for c in got] == [c["key"] for c in want] == [keys[0]]
    for field in ("grid", "kinds", "dtype", "batch_shape", "mesh_shape"):
        assert got[0][field] == want[0][field]
    assert got[0]["tuned"].decomp == "slab"
    assert [c["key"] for c in warm_candidates(
        port, _mesh(), ops=("fft", "fwd+scale+inv"))] == [keys[0], keys[4]]
    # a kernel-only winner is warmed by a kernel-only service alone
    pinned = key(backends=("kernel",))
    port.put(pinned, TunedPlan(backend="kernel", **fields), save=False)
    assert [c["key"] for c in warm_candidates(port, _mesh())] == [keys[0]]
    got = warm_candidates(port, _mesh(), backends=("kernel",))
    assert [c["key"] for c in got] == [pinned]
    assert got[0]["backends"] == ("kernel",) and got[0]["grid"] == (8, 8)


def test_warmer_rebuilds_from_wisdom_and_first_drain_builds_nothing():
    mesh = _mesh()
    cache = TuningCache()
    tune((8, 8), mesh, mode="auto", cache=cache, backends=("kernel",))
    # the kernel-only winner has a key of its own
    assert [key.endswith(";be=kernel") for key, _ in cache.items()] == [True]
    svc = FFTService(mesh, tune_cache=cache, max_batch=2,
                     backends=("kernel",))
    rep = svc.warm(ensure=[((8, 16), ("fft", "fft"))])
    assert rep.candidates == 1 and rep.warmed == 1
    assert rep.families == 1 and rep.ensured == 1
    assert rep.batch_plans == 4              # buckets (1,), (2,) x 2 families
    assert rep.segments_prebuilt > 0 and not rep.skipped
    sources = {fam.grid: fam.source for fam in svc.router.families.values()}
    assert sources == {(8, 8): "wisdom", (8, 16): "heuristic"}
    assert {fam.tuned.backend for fam in svc.router.families.values()} == \
        {"kernel"}
    inputs = {}
    for i, grid in enumerate([(8, 8), (8, 16), (8, 8), (7, 5), (8, 8)]):
        x = cplx(grid, 200 + i)
        inputs[svc.submit(torch.from_numpy(x))] = x
    misses, loads = GLOBAL_PLAN_CACHE.stats()["misses"], build.counts["loads"]
    results = svc.drain()
    assert GLOBAL_PLAN_CACHE.stats()["misses"] == misses
    assert build.counts["loads"] == loads
    assert all(res.plan_hit for res in results.values())
    for rid, x in inputs.items():
        res = results[rid]
        want = (_padded_ref(x, res.bucket_grid) if res.padded
                else np.fft.fftn(x))
        np.testing.assert_allclose(res.y.numpy(), want, rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------- service

def test_service_end_to_end_single_rank():
    svc = FFTService(_mesh(), max_batch=4)
    inputs = {}
    for i, grid in enumerate([(16, 16), (16, 16), (14, 15), (16, 32)]):
        x = cplx(grid, 300 + i)
        inputs[svc.submit(torch.from_numpy(x))] = x
    assert svc.queue_depth == 4
    results = svc.drain()
    assert svc.queue_depth == 0 and len(results) == 4
    for rid, x in inputs.items():
        res = results[rid]
        want = (_padded_ref(x, res.bucket_grid) if res.padded
                else np.fft.fftn(x))
        np.testing.assert_allclose(res.y.numpy(), want, rtol=1e-4, atol=1e-3)
        assert res.latency_s > 0 and not res.degraded
    m = svc.metrics
    assert m.requests_completed == 4 and m.latency_percentiles()["n"] == 4
    # rfft requests route exact (no padding)
    xr = np.random.default_rng(5).standard_normal((12, 10)).astype(
        np.float32)
    rid = svc.submit(torch.from_numpy(xr), kinds=("rfft", "fft"))
    res = svc.drain()[rid]
    assert not res.padded and res.bucket_grid == (12, 10)
    np.testing.assert_allclose(res.y.numpy()[:7], np.fft.rfftn(
        xr, axes=(1, 0)), rtol=1e-4, atol=1e-3)
    assert "families=" in svc.describe()


def test_service_watchdog_steps_monotonic_across_drains():
    svc = FFTService(_mesh(), max_batch=2)
    for d in range(2):
        for k in range(2):
            svc.submit(torch.from_numpy(cplx((16, 16), 10 * d + k)))
        svc.drain()
    steps = sorted(svc.executor._step_tags)
    assert steps == list(range(len(steps)))  # unique, gapless, monotonic
    assert len(steps) >= 4                   # both drains fed steps


def test_service_refuses_what_is_not_ported_and_single_rank_loss():
    """``verify=`` is ported now (it wires the metrics sink); a one-rank
    mesh still has no survivors to lose to."""
    svc = FFTService(_mesh(), verify="warn")
    assert svc.executor.verify == "warn"
    assert svc.executor.verify_sink == svc.metrics.record_verify_findings
    with pytest.raises(ValueError, match="verify must be one of"):
        FFTService(_mesh(), verify="loud")
    svc = FFTService(_mesh())
    with pytest.raises(ValueError, match="no survivors"):
        svc.lose_devices(1)


def test_entry_points_need_the_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour")
    from repro_torch.launch.serve_fft import serve_fft
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_fft(verbose=False)


def test_serve_fft_driver_on_one_cpu_rank(tmp_path, capsys):
    from repro_torch.launch.serve_fft import main
    path, wisdom = str(tmp_path / "metrics.json"), str(tmp_path / "t.json")
    main(["--device", "cpu", "--check", "--requests", "12", "--round-size",
          "6", "--json", path, "--wisdom", wisdom])
    snap = json.load(open(path))
    drv = snap["driver"]
    assert snap["plan_cache"]["hit_rate"] == 1.0
    assert drv["first_drain"] == {"plan_builds": 0, "kernel_loads": 0}
    assert drv["max_rel_err"] < 1e-4
    assert snap["faults"]["device_loss_events"] == 0
    # the traffic drains' own counts: every routed batch, and no launch on
    # the CPU (the kernel's plain version runs)
    assert drv["traffic_batches"] == \
        snap["plan_cache"]["batches_dispatched"] > 0
    # and the same batches by bucket grid
    assert sum(drv["traffic_batches_by_grid"].values()) == \
        drv["traffic_batches"]
    assert all(len(g.split("x")) == 2 for g in drv["traffic_batches_by_grid"])
    assert set(drv["traffic_launches"].values()) == {0}
    assert drv["drain_rps"] > drv["loop_rps"] > drv["rps"] > 0
    # the kernel-pinned seed is stored under a key of its own
    plans = json.load(open(wisdom))["plans"]
    assert plans and all(k.endswith(";be=kernel") for k in plans)
    assert "CHECK OK" in capsys.readouterr().out


# --------------------------------------------- 4 gloo ranks, one of them lost

@pytest.fixture(scope="module")
def degraded(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("serving"))
    kwargs = dict(requests=16, round_size=8, lose=1, seed=0, device="cpu",
                  check=True, verbose=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_CALIBRATE", "off")
        out = run_ranks("serve_body", 4, root, kwargs)
    recs = []
    for rank in range(4):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            recs.append(json.load(f))
    return recs


def test_degraded_service_matches_fresh_survivors_bitwise(degraded):
    for rec in degraded[:2]:                 # the degraded mesh's ranks
        drv = rec["driver"]
        assert drv["fresh_mesh_bitwise_ok"]
        assert drv["max_rel_err"] < 1e-4
        assert not drv["lost"] and drv["mesh"] == [2, 2]
        assert rec["plan_cache"]["hit_rate"] >= 0.8
        assert drv["first_drain"] == {"plan_builds": 0, "kernel_loads": 0}
        assert rec["faults"]["device_loss_events"] == 1
        assert rec["faults"]["degraded"]
        assert rec["degraded_throughput_rps"] > 0
    assert [rec["driver"]["lost"] for rec in degraded] == \
        [False, False, True, True]


def test_degraded_mesh_shape_matches_reference(degraded):
    from repro_torch.launch.serve_fft import (ODD_GRIDS, PRIMARY_GRID,
                                              SECONDARY_GRID)
    # the served dims: both families' grids and the odd requests' buckets
    dims = tuple(sorted(set(PRIMARY_GRID + SECONDARY_GRID)))
    assert all(n <= 16 for g in ODD_GRIDS for n in g)   # bucketed to 16
    want = list(ref_choose(3, grid=dims))
    for rec in degraded:
        assert rec["driver"]["degraded_mesh"] == want == [2, 1]


def test_lost_rank_refuses_work(degraded):
    for rank, rec in enumerate(degraded):
        check = rec["lose_check"]
        assert check["shape"] == [2, 1]
        if rank < 2:
            # the request queued before the loss completes on the survivors
            assert not check["lost"] and check["completed"] == 1
        else:
            assert check["lost"]
            assert check["raised"] == {"submit": True, "drain": True}
