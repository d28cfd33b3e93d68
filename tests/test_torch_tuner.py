"""The port's tuner (``repro_torch.core.tuner``) and wisdom cache
(``core/plan.py``) against the JAX package's.

* Under the backend name map and one machine (``REPRO_CALIBRATE=off``):
  ``enumerate_candidates`` equals the reference's, the ``rank_candidates``
  order and predictions over cufft/matmul equal xla/matmul's, and the
  heuristic winner over the whole space is the reference's.  The
  ``kernel`` backend is priced by what it runs (radix flops on a power of
  two), where the reference prices ``pallas`` as the dense four-step, so
  its rank differs by design.
* ``auto`` on a small grid: the winner is no slower than the default, the
  wisdom file goes to the port's own path, a second plan measures nothing.
* ``TuningCache`` merges between instances, keeps the machine section and
  loads a wisdom file the JAX package wrote; both packages plan from one
  record.
* 4 gloo ranks in ``auto`` mode agree on one plan and one profile, and the
  tuned plan's output matches the JAX plan with the same knobs.
"""
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import perfmodel as jpm
from repro.core import plan as jplan
from repro.core import tuner as jt
from repro_torch.compat import Mesh, make_mesh
from repro_torch.core import perfmodel as tpm
from repro_torch.core import plan as tplan
from repro_torch.core import tuner as tt
from repro_torch.core.api import plan_fft
from repro_torch.core.transforms import FROM_REFERENCE_BACKEND, \
    REFERENCE_BACKEND
from torch_harness import assert_scaled_close, cplx, run_ranks, run_reference

NAMES = ("data", "model")


def views(shape):
    names = NAMES[:len(shape)]
    port = Mesh(names, tuple(shape), (0,) * len(shape), torch.device("cpu"),
                {n: None for n in names})
    ref = types.SimpleNamespace(axis_names=names,
                                devices=np.empty(shape, dtype=object))
    return port, ref


def to_port(c: jt.Candidate) -> tt.Candidate:
    return tt.Candidate(decomp=c.decomp, mesh_axes=tuple(c.mesh_axes),
                        backend=FROM_REFERENCE_BACKEND[c.backend],
                        n_chunks=c.n_chunks, dim_groups=c.dim_groups,
                        chunk_schedule=c.chunk_schedule)


PROBLEMS = [((16, 32, 64), (2, 4), ("fft",) * 3, ()),
            ((16, 16, 16), (2, 2), ("rfft", "fft", "fft"), ()),
            ((8, 16, 16), (2, 2), ("fft", "fft", "dct2"), (4,)),
            ((8, 8, 16, 16), (2, 2), ("fft",) * 4, ()),
            ((12, 8, 16), (1, 1), ("fft",) * 3, ()),
            ((32, 64), (4,), ("fft", "fft"), (2,))]


@pytest.mark.parametrize("problem", PROBLEMS)
@pytest.mark.parametrize("inverse", [False, True])
def test_enumerate_candidates_match_reference(problem, inverse):
    grid, shape, kinds, batch = problem
    port_mesh, ref_mesh = views(shape)
    got = tt.enumerate_candidates(grid, port_mesh, kinds, inverse=inverse,
                                  n_batch=len(batch), batch_shape=batch)
    want = jt.enumerate_candidates(grid, ref_mesh, kinds, inverse=inverse,
                                   n_batch=len(batch), batch_shape=batch)
    assert got == [to_port(c) for c in want]
    # with a machine the policy engine's per-hop schedules join in
    got = tt.enumerate_candidates(grid, port_mesh, kinds, inverse=inverse,
                                  n_batch=len(batch), batch_shape=batch,
                                  backends=("cufft", "matmul"),
                                  machine=tpm.CPU_CORE)
    want = jt.enumerate_candidates(grid, ref_mesh, kinds, inverse=inverse,
                                   n_batch=len(batch), batch_shape=batch,
                                   backends=("xla", "matmul"),
                                   machine=jpm.CPU_CORE)
    assert got == [to_port(c) for c in want]


@pytest.mark.parametrize("problem", PROBLEMS)
def test_rank_order_matches_reference(problem):
    grid, shape, kinds, batch = problem
    port_mesh, ref_mesh = views(shape)
    got = tt.rank_candidates(
        tt.enumerate_candidates(grid, port_mesh, kinds, n_batch=len(batch),
                                batch_shape=batch,
                                backends=("cufft", "matmul"),
                                machine=tpm.CPU_CORE),
        grid, port_mesh, tpm.CPU_CORE, 8, kinds=kinds)
    want = jt.rank_candidates(
        jt.enumerate_candidates(grid, ref_mesh, kinds, n_batch=len(batch),
                                batch_shape=batch,
                                backends=("xla", "matmul"),
                                machine=jpm.CPU_CORE),
        grid, ref_mesh, jpm.CPU_CORE, 8, kinds=kinds)
    assert [c for _, c in got] == [to_port(c) for _, c in want]
    for (a, _), (b, _) in zip(got, want):
        assert a == pytest.approx(b, rel=1e-12)


@pytest.mark.parametrize("problem", PROBLEMS)
def test_heuristic_winner_matches_reference(problem, monkeypatch):
    grid, shape, kinds, batch = problem
    monkeypatch.setenv("REPRO_CALIBRATE", "off")
    port_mesh, ref_mesh = views(shape)
    dtype = torch.float32 if kinds[0] == "rfft" or "dct2" in kinds \
        else torch.complex64
    got = tt.tune(grid, port_mesh, kinds=kinds, dtype=dtype,
                  batch_shape=batch, mode="heuristic",
                  cache=tplan.TuningCache())
    want = jt.tune(grid, ref_mesh, kinds=kinds,
                   dtype=jnp.dtype(str(dtype).removeprefix("torch.")),
                   batch_shape=batch, mode="heuristic",
                   cache=jplan.TuningCache())
    assert got.source == want.source == "heuristic"
    assert (got.decomp, got.mesh_axes, got.backend, got.n_chunks,
            got.dim_groups, got.chunk_schedule) == \
        (want.decomp, want.mesh_axes, FROM_REFERENCE_BACKEND[want.backend],
         want.n_chunks, want.dim_groups, want.chunk_schedule)
    assert got.predicted_s == pytest.approx(want.predicted_s, rel=1e-12)


def test_kernel_ranks_like_cufft_on_radix_sizes():
    """On power-of-two lines the kernel's predicted time is cufft's, and
    the stable ranking keeps cufft (enumerated first) ahead of it."""
    port_mesh, _ = views((2, 2))
    grid = (16, 16, 16)
    ranked = tt.rank_candidates(
        tt.enumerate_candidates(grid, port_mesh, ("fft",) * 3),
        grid, port_mesh, tpm.CPU_CORE, 8, kinds=("fft",) * 3)
    pred = {c: p for p, c in ranked}
    for c in pred:
        if c.backend == "kernel":
            twin = tt.Candidate(c.decomp, c.mesh_axes, "cufft", c.n_chunks,
                                c.dim_groups, c.chunk_schedule)
            assert pred[c] == pred[twin]
    assert ranked[0][1].backend == "cufft"


# ---------------------------------------------------------------------------
# auto mode and the wisdom file, one rank
# ---------------------------------------------------------------------------

@pytest.fixture
def wisdom(tmp_path, monkeypatch):
    """The port's global wisdom file, redirected into ``tmp_path``."""
    path = str(tmp_path / "port" / "tuning.json")
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", path)
    monkeypatch.setattr(tplan, "_GLOBAL_TUNING_CACHE", None)
    return path


def test_default_wisdom_path_is_the_ports_own(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_TUNING_CACHE", raising=False)
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert tplan.default_tuning_path() == str(
        tmp_path / "repro-fft-torch" / "tuning.json")
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(tmp_path / "t.json"))
    assert tplan.default_tuning_path() == str(tmp_path / "t.json")


def test_auto_tunes_persists_and_reuses(wisdom, monkeypatch):
    mesh = make_mesh((1, 1), NAMES, device="cpu")
    grid = (8, 16, 16)
    plan = plan_fft(mesh, grid, tuning="auto")
    tuned = plan.tuned
    assert tuned.source == "measured" and tuned.measured_s > 0
    assert tuned.measured_s <= tuned.baseline_s   # never worse than default
    assert os.path.exists(wisdom)
    with open(wisdom) as f:
        raw = json.load(f)
    key = tplan.tuning_key(grid=grid, mesh_shape=(1, 1), mesh_axes=NAMES,
                           kinds=("fft",) * 3, dtype="complex64",
                           inverse=False, platform="cpu")
    assert key in raw["plans"] and "cpu" in raw["machine"]
    assert raw["machine"]["cpu"]["calibrated"]
    assert "tuner: " in plan.describe() and "measured" in plan.describe()
    x = torch.from_numpy(cplx(grid, 5))
    assert_scaled_close(plan.forward(x).numpy(), np.fft.fftn(x.numpy()),
                        2e-5)

    calls = {"n": 0}
    measure = tt.measure_candidate

    def counting(*a, **kw):
        calls["n"] += 1
        return measure(*a, **kw)

    monkeypatch.setattr(tt, "measure_candidate", counting)
    # a new process would read the file: a fresh cache on the same path
    again = plan_fft(mesh, grid, tuning="auto",
                     tune_cache=tplan.TuningCache(wisdom))
    assert calls["n"] == 0 and again.tuned == tuned
    # the objective of a PoissonSolver has its own key
    plan_fft(mesh, grid, tuning="auto", tune_objective="fwd+scale+inv",
             tune_cache=tplan.TuningCache(wisdom))
    assert calls["n"] > 0


def test_restricted_tune_is_not_persisted():
    """A restricted winner is never stored as the unrestricted problem's:
    a ``max_chunks`` cap stores nothing, a backend restriction stores
    under its own ``be=`` key, which an unrestricted lookup never reads."""
    mesh = make_mesh((1, 1), NAMES, device="cpu")
    kw = dict(grid=(8, 8), mesh_shape=(1, 1), mesh_axes=NAMES,
              kinds=("fft", "fft"), dtype="complex64", inverse=False,
              platform="cpu")
    cache = tplan.TuningCache()
    tt.tune((8, 8), mesh, mode="auto", cache=cache, machine=tpm.CPU_CORE,
            max_chunks=1, repeats=1)
    assert len(cache) == 0
    got = tt.tune((8, 8), mesh, mode="auto", cache=cache,
                  machine=tpm.CPU_CORE, backends=("cufft",), repeats=1)
    assert got.backend == "cufft"
    assert cache.get(tplan.tuning_key(**kw)) is None
    assert [k for k, _ in cache.items()] == [
        tplan.tuning_key(**kw, backends=("cufft",))]
    assert tplan.parse_tuning_key(tplan.tuning_key(
        **kw, backends=("cufft",)))["backends"] == ("cufft",)


def test_tuning_cache_merges_and_keeps_machine_section(tmp_path):
    path = str(tmp_path / "w.json")
    a, b = tplan.TuningCache(path), tplan.TuningCache(path)
    p1 = tplan.TunedPlan("pencil", NAMES, "kernel", 2, 1e-3, 2e-3,
                         "measured", ts=10.0)
    p2 = tplan.TunedPlan("slab", ("model",), "cufft", 1, 1e-3, 1e-3,
                         "measured", ts=20.0, chunk_schedule=(1,))
    a.put("k1", p1)
    b.put("k2", p2)
    a.put_machine("NVIDIA H100 80GB HBM3",
                  tpm.profile_from_machine(tpm.H100_SXM).to_json())
    merged = tplan.TuningCache(path)
    assert merged.get("k1") == p1 and merged.get("k2") == p2
    prof = tpm.MachineProfile.from_json(
        merged.get_machine("NVIDIA H100 80GB HBM3"))
    assert prof.base == tpm.H100_SXM
    # newest ts wins on a shared key
    b.put("k1", p2)
    assert tplan.TuningCache(path).get("k1") == p2
    # a stale schema or a corrupt file reads as empty
    with open(path, "w") as f:
        f.write("{not json")
    assert len(tplan.TuningCache(path)) == 0


def test_both_packages_plan_from_one_wisdom_file(tmp_path, cpu_mesh):
    """A wisdom file the JAX package wrote loads into the port's cache with
    its backend and profile names mapped; the port's plan from the record
    matches the JAX plan from it."""
    grid = (8, 16, 32)
    path = str(tmp_path / "jax.json")
    ref = jplan.TuningCache(path)
    key = jplan.tuning_key(grid=grid, mesh_shape=(1, 1), mesh_axes=NAMES,
                           kinds=("fft",) * 3, dtype="complex64",
                           inverse=False, platform="cpu")
    rec = jplan.TunedPlan("pencil", NAMES, "pallas", 2, 1e-3, 2e-3,
                          "measured", baseline_s=3e-3, ts=5.0,
                          chunk_schedule=(2, 4))
    ref.put(key, rec)
    ref.put_machine("cpu", jpm.MachineProfile(
        base=jpm.CPU_CORE, platform="cpu", calibrated=True,
        backend_flops=(("pallas", 1e9), ("xla", 2e9))).to_json())
    port = tplan.TuningCache(str(tmp_path / "port.json"))
    assert port.import_reference(path) == 1
    tuned = port.get(key)
    assert tuned.backend == "kernel" and tuned.chunk_schedule == (2, 4)
    assert dict(tpm.MachineProfile.from_json(
        port.get_machine("cpu")).backend_flops) == {"kernel": 1e9,
                                                   "cufft": 2e9}
    # the port's tuner serves the imported record without measuring
    mesh = make_mesh((1, 1), NAMES, device="cpu")
    plan = plan_fft(mesh, grid, tuning="auto", tune_cache=port)
    assert plan.tuned == tuned and plan.chunk_schedule == (2, 4)
    x = cplx(grid, 9)
    got = plan.forward(torch.from_numpy(x)).numpy()
    # ... and so does the JAX package's, from its own file
    jax_plan = japi.plan_fft(cpu_mesh, grid, tuning="auto", tune_cache=ref)
    assert jax_plan.tuned == rec
    assert_scaled_close(got, np.asarray(jax_plan.forward(jnp.asarray(x))),
                        2e-4)


def test_tuning_key_round_trip_matches_reference():
    kw = dict(grid=(8, 16), mesh_shape=(2, 2), mesh_axes=NAMES,
              kinds=("rfft", "fft"), dtype="float32", inverse=True,
              batch_shape=(3,), platform="cpu", op="fwd+scale+inv")
    key = tplan.tuning_key(**kw)
    assert key == jplan.tuning_key(**kw)
    assert tplan.parse_tuning_key(key) == jplan.parse_tuning_key(key)
    assert tplan.parse_tuning_key("grid") is None


# ---------------------------------------------------------------------------
# 4 gloo ranks
# ---------------------------------------------------------------------------

REFERENCE = """
import numpy as np, jax.numpy as jnp
from repro.compat import AxisType, make_mesh
from repro.core.api import plan_fft
mesh = make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
x = jnp.asarray(np.load({x!r}))
plan = plan_fft(mesh, {grid!r}, **{knobs!r})
np.save({out!r}, np.asarray(plan.forward(x)))
print("done")
"""


def test_ranks_agree_in_auto_mode(tmp_path):
    grid = (8, 8, 16)
    x = cplx(grid, 21)
    x_path = str(tmp_path / "x.npy")
    np.save(x_path, x)
    cache_path = str(tmp_path / "wisdom" / "tuning.json")
    out_dir = run_ranks("tuner_body", 4, tmp_path, x_path, grid, cache_path)
    recs = []
    for rank in range(4):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
            recs.append(json.load(f))
    for rec in recs:
        assert rec["tuned"] == recs[0]["tuned"]
        assert rec["profile"] == recs[0]["profile"]
        assert rec["again"] == rec["tuned"]
        assert rec["second_measurements"] == 0
        assert rec["stored_profile"]
    tuned = tplan.TunedPlan.from_json(recs[0]["tuned"])
    assert tuned.source == "measured"
    assert tuned.measured_s <= tuned.baseline_s
    prof = tpm.MachineProfile.from_json(recs[0]["profile"])
    assert prof.calibrated
    with open(cache_path) as f:
        assert len(json.load(f)["plans"]) == 1

    knobs = {"decomp": tuned.decomp, "mesh_axes": tuned.mesh_axes,
             "backend": REFERENCE_BACKEND[tuned.backend],
             "n_chunks": (tuned.chunk_schedule
                          if tuned.chunk_schedule is not None
                          else tuned.n_chunks),
             "dim_groups": tuned.dim_groups}
    ref_path = str(tmp_path / "ref.npy")
    out = run_reference(REFERENCE.format(x=x_path, grid=grid, knobs=knobs,
                                         out=ref_path), devices=4)
    assert "done" in out
    got = np.load(os.path.join(out_dir, "fwd.npy"))
    assert_scaled_close(got, np.load(ref_path), 2e-4)
    assert_scaled_close(got, np.fft.fftn(x), 2e-4)
