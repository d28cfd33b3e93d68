"""The port's plan API (``repro_torch/core/api.py``, ``core/plan.py``) and
the port's boundaries: plan records shared with the JAX package, the
wrappers, CUDA-by-default entry points, and the rule that the port and
``chip_smoke.py`` import nothing of JAX."""
import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import fft3d as j_fft3d
from repro.core.api import plan_fft as j_plan_fft
from repro.core.plan import TunedPlan as JTunedPlan
from repro_torch.compat import make_mesh
from repro_torch.core import api
from repro_torch.core.plan import PlanCache, TunedPlan, plan_key
from torch_harness import assert_scaled_close, cplx

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture
def mesh():
    return make_mesh((1, 1), ("data", "model"), device="cpu")


def _reference_record(**kw) -> dict:
    base = dict(decomp="pencil", mesh_axes=("data", "model"),
                backend="pallas", n_chunks=1, predicted_s=1e-4,
                measured_s=2e-4, source="measured", baseline_s=3e-4,
                ts=123.0)
    base.update(kw)
    return JTunedPlan(**base).to_json()


@pytest.mark.parametrize("ref_backend,port_backend", [
    ("pallas", "kernel"), ("xla", "cufft"), ("matmul", "matmul")])
def test_tuned_plan_reads_reference_records(ref_backend, port_backend):
    rec = _reference_record(backend=ref_backend,
                            dim_groups=((0,), (1, 2)), decomp="hybrid",
                            chunk_schedule=(1,))
    tp = TunedPlan.from_json(rec)
    assert tp.backend == port_backend
    assert (tp.decomp, tp.mesh_axes, tp.dim_groups, tp.chunk_schedule,
            tp.measured_s, tp.ts) == ("hybrid", ("data", "model"),
                                      ((0,), (1, 2)), (1,), 2e-4, 123.0)
    assert TunedPlan.from_json(tp.to_json()) == tp


@pytest.mark.parametrize("decomp,groups", [("pencil", None),
                                           ("slab", None),
                                           ("hybrid", ((0, 1), (2,)))])
def test_reference_record_plans_the_same_schedule(cpu_mesh, mesh, decomp,
                                                  groups):
    """One record, two packages: the stage layouts, hops, backend (mapped)
    and results agree."""
    axes = ("model",) if decomp == "slab" else ("data", "model")
    rec = _reference_record(decomp=decomp, mesh_axes=axes,
                            dim_groups=groups)
    jtuned = JTunedPlan.from_json(rec)
    jplan = j_plan_fft(cpu_mesh, (8, 8, 16), decomp=jtuned.decomp,
                       mesh_axes=jtuned.mesh_axes, backend=jtuned.backend,
                       dim_groups=jtuned.dim_groups)
    tplan = api.plan_fft(mesh, (8, 8, 16), tuned=TunedPlan.from_json(rec))
    tspec, jspec = tplan.pipeline_spec(), jplan.pipeline_spec()
    assert tplan.backend == "kernel" and jplan.backend == "pallas"
    assert [s.spec for s in tspec.decomp.stages] == \
        [s.spec for s in jspec.decomp.stages]
    assert [[(m.mesh_axis, m.split_dim, m.concat_dim) for m in h.moves]
            for h in tspec.decomp.redists] == \
        [[(m.mesh_axis, m.split_dim, m.concat_dim) for m in h.moves]
         for h in jspec.decomp.redists]
    x = cplx((8, 8, 16), 1)
    assert_scaled_close(tplan.forward(torch.from_numpy(x)).numpy(),
                        np.asarray(jplan.forward(jnp.asarray(x))), 2e-4)
    assert "measured 0.200 ms" in tplan.describe()


def test_fft3d_matches_reference_wrapper(cpu_mesh, mesh):
    x = cplx((8, 16, 8), 2)
    for backend in ("kernel", "cufft"):
        got = api.fft3d(torch.from_numpy(x), mesh=mesh, backend=backend)
        want = j_fft3d(jnp.asarray(x), mesh=cpu_mesh,
                       backend={"kernel": "pallas", "cufft": "xla"}[backend])
        assert_scaled_close(got.numpy(), np.asarray(want), 2e-4)
        back = api.ifft3d(got, mesh=mesh, backend=backend)
        assert_scaled_close(back.numpy(), x, 1e-4)


def test_wrappers_memoize_and_batch(mesh):
    api.clear_plan_memo()
    x = cplx((2, 8, 12), 3)
    y = api.fft2d(torch.from_numpy(x), mesh=mesh)
    assert_scaled_close(y.numpy(), np.fft.fftn(x, axes=(1, 2)), 2e-5)
    back = api.ifft2d(y, mesh=mesh)
    assert_scaled_close(back.numpy(), x, 1e-5)
    stats = api.plan_memo_stats()
    assert stats["misses"] == 1 and stats["hits"] == 1
    y64 = api.fftnd(torch.from_numpy(x.astype(np.complex128)), mesh=mesh,
                    ndim=2)
    assert y64.dtype == torch.complex128
    assert api.plan_memo_stats()["misses"] == 2
    real = api.fftnd(torch.from_numpy(x.real.copy()), mesh=mesh, ndim=2)
    assert real.dtype == torch.complex64
    assert api.plan_cache_stats()["memo"]["plans"] == 2
    with pytest.raises(ValueError, match=">= 2 transform dims"):
        api.fftnd(torch.zeros(4, dtype=torch.complex64), mesh=mesh)


def test_plan_introspection_and_operand_checks(mesh):
    plan = api.plan_fft(mesh, (4, 8, 16), backend="kernel")
    assert plan.in_struct.shape == (4, 8, 16)
    assert plan.in_struct.spec == (None, "data", "model")
    assert plan.out_struct.spec == ("data", "model", None)
    assert plan.dtype == torch.complex64 and plan.device.type == "cpu"
    text = plan.describe()
    assert "pencil over ('data', 'model')" in text and "kernel" in text
    assert "static default, untuned" in text
    with pytest.raises(ValueError, match="plan expects"):
        plan.forward(torch.zeros((4, 8, 8), dtype=torch.complex64))
    y = plan(torch.from_numpy(cplx((4, 8, 16), 4)), sharded_in=True)
    assert y.shape == (4, 8, 16)


def test_plan_fft_rejects_what_is_not_ported(mesh):
    with pytest.raises(NotImplementedError, match="tuning='auto'"):
        api.plan_fft(mesh, (8, 8), tuning="auto")
    with pytest.raises(ValueError, match="tuning must be one of"):
        api.plan_fft(mesh, (8, 8), tuning="fast")
    with pytest.raises(ValueError, match="unknown backend 'pallas'"):
        api.plan_fft(mesh, (8, 8), backend="pallas")
    with pytest.raises(ValueError, match="cufft, matmul, kernel"):
        api.plan_fft(mesh, (8, 8), backend="fftw")
    with pytest.raises(ValueError, match="drop backend"):
        api.plan_fft(mesh, (8, 8), backend="cufft",
                     tuned=TunedPlan.from_json(_reference_record()))
    with pytest.raises(ValueError, match="repeat dim"):
        api.plan_fft(mesh, (8, 8, 8), dim_groups=((0, 1), (1, 2)))
    with pytest.raises(NotImplementedError, match="n_chunks"):
        api.plan_fft(mesh, (8, 8, 8), n_chunks=2)


KINDS_CASES = [("rfft", "fft", "fft"), ("fft", "fft", "dct2"),
               ("dct2", "dct2", "dct2"), ("dst2", "fft", "dct2"),
               ("fft", "fft", "fft")]


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


@pytest.mark.parametrize("kinds", KINDS_CASES)
def test_plan_structs_match_reference(cpu_mesh, mesh, kinds):
    """Default dtype, and the shapes and dtypes of the forward and inverse
    operands, equal the reference plan's (R2C real in, complex out on the
    padded grid; R2R real in stays real until a C2C line)."""
    grid = (9, 8, 4)
    tplan = api.plan_fft(mesh, grid, kinds=kinds)
    jplan = j_plan_fft(cpu_mesh, grid, kinds=kinds)
    for name in ("in_struct", "out_struct", "inv_in_struct",
                 "inv_out_struct"):
        t, j = getattr(tplan, name), getattr(jplan, name)
        assert (tuple(t.shape), _dtype_name(t.dtype)) == \
            (tuple(j.shape), j.dtype.name), name
    x = np.random.default_rng(6).standard_normal(grid).astype(np.float32)
    y = tplan.forward(torch.from_numpy(x))
    assert_scaled_close(y.numpy(), np.asarray(jplan.forward(jnp.asarray(x))),
                        2e-5)
    assert tplan.inverse(y).dtype == tplan.inv_out_struct.dtype


def test_plan_dtype_rules():
    """Real-input pipelines (rfft first, or any R2R kind) keep real
    operands; pure C2C promotes to the complex dtype of the precision; the
    inverse wrapper maps a spectral dtype back to the forward one."""
    r2c, r2r, c2c = ("rfft", "fft"), ("fft", "dct2"), ("fft", "fft")
    f32, f64, c64, c128 = (torch.float32, torch.float64, torch.complex64,
                           torch.complex128)
    assert api._forward_plan_dtype(f32, r2c) == f32
    assert api._forward_plan_dtype(f64, r2r) == f64
    assert api._forward_plan_dtype(c64, r2r) == c64
    assert api._forward_plan_dtype(f64, c2c) == c128
    assert api._inverse_plan_dtype(c128, r2c) == f64
    assert api._inverse_plan_dtype(c64, r2r) == f32
    assert api._inverse_plan_dtype(f32, c2c) == c64
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    plan = api.plan_fft(mesh, (8, 8, 8), kinds=("rfft", "fft", "fft"),
                        dtype=torch.complex128)
    assert plan.dtype == f64 and plan.out_struct.dtype == c128
    assert plan.inv_out_struct.dtype == f64


@pytest.mark.parametrize("backend", ["kernel", "cufft"])
def test_r2c_wrappers_match_reference(cpu_mesh, mesh, backend):
    """``fft3d``/``ifft3d`` with R2C kinds: the inverse needs the real-space
    grid, and both share one memoized plan."""
    api.clear_plan_memo()
    kinds = ("rfft", "fft", "fft")
    xr = np.random.default_rng(7).standard_normal((16, 8, 8)).astype(
        np.float32)
    y = api.fft3d(torch.from_numpy(xr), mesh=mesh, kinds=kinds,
                  backend=backend)
    want = j_fft3d(jnp.asarray(xr), mesh=cpu_mesh, kinds=kinds,
                   backend={"kernel": "pallas", "cufft": "xla"}[backend])
    assert y.shape == (9, 8, 8)
    assert_scaled_close(y.numpy(), np.asarray(want), 2e-5)
    back = api.ifft3d(y, mesh=mesh, grid=(16, 8, 8), kinds=kinds,
                      backend=backend)
    assert back.dtype == torch.float32
    assert float(np.max(np.abs(back.numpy() - xr))) < 1e-5
    stats = api.plan_memo_stats()
    assert stats["misses"] == 1 and stats["hits"] == 1
    (plan,) = list(api._PLAN_MEMO.values())
    assert plan.shared
    api.clear_plan_memo()


def test_plan_cache_lru_and_injected_timer():
    ticks = iter(range(100))
    cache = PlanCache(capacity=2, timer=lambda: float(next(ticks)))
    for k in ("a", "b", "a", "c"):
        cache.get_or_create(k, lambda k=k: k.upper())
    stats = cache.stats()
    assert (stats["hits"], stats["misses"], stats["evictions"]) == (1, 3, 1)
    assert cache.keys() == ["a", "c"]
    assert stats["total_build_time_s"] == 2.0
    key = plan_key(kind=("fft",), grid=(8,), dtype="complex64",
                   decomp=("pencil",), mesh_shape=(1, 1),
                   mesh_axes=("data", "model"), backend="kernel",
                   n_chunks=(1,), inverse=False)
    assert key[6] == "kernel" and len(key) == 10


def test_entry_points_default_to_cuda():
    """Without device='cpu' an entry point runs on CUDA, and on a machine
    without a GPU it raises, naming how to ask for the CPU."""
    if torch.cuda.is_available():
        assert make_mesh((1, 1), ("data", "model")).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh((1, 1), ("data", "model"), device="cuda")


def _imports(path: str):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_and_chip_smoke_import_no_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _dirs, names in os.walk(os.path.join(ROOT, "src",
                                                   "repro_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path} imports {mod}"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Alone in a directory, or on a machine without CUDA, the smoke test
    exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the smoke test would run")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    for where in (str(tmp_path), ROOT):
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=where,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
