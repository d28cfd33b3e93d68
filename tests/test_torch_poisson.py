"""The port's spectral Poisson solver (``PoissonSolver``/``poisson_solve``,
``repro_torch/core/api.py``) on 2x2 gloo ranks at 16^3, held to the
reference's own checks (``tests/test_distributed_fft.py``: periodic
residual < 1e-4, the PPB Neumann residual < 1e-3, the batched null mode
< 1e-5) and to the JAX ``poisson_solve`` on 4 fake XLA devices at 2e-4
max-scaled; plus the solver's single-rank surface against the reference.
All with ``tuning="off"``: the reference's heuristic-mode Poisson test
fails on its own (ROADMAP C)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro_torch.compat import make_mesh
from repro_torch.core import api
from repro_torch.core.transforms import REFERENCE_BACKEND
from torch_harness import assert_scaled_close, run_ranks, run_reference

N = 16
DX = 2 * np.pi / N
BACKENDS = ("kernel", "cufft", "matmul")
TOPOLOGIES = (("ppp", ("periodic",) * 3),
              ("ppb", ("periodic", "periodic", "bounded")))

REFERENCE = """
import numpy as np, jax.numpy as jnp
from repro.compat import AxisType, make_mesh
from repro.core.api import poisson_solve
mesh = make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
rhs = jnp.asarray(np.load({rhs!r}))
rhs_b = jnp.asarray(np.load({rhs_b!r}))
for name, topo in {topologies!r}:
    for be in ("pallas", "xla", "matmul"):
        phi = poisson_solve(rhs, mesh=mesh, topology=topo, backend=be)
        np.save({out!r} + f"/phi_{{name}}_{{be}}.npy", np.asarray(phi))
        phi_b = poisson_solve(rhs_b, mesh=mesh, topology=topo, backend=be)
        np.save({out!r} + f"/batched_{{name}}_{{be}}.npy", np.asarray(phi_b))
print("done")
"""


def _rhs(shape, seed: int) -> np.ndarray:
    rhs = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    return rhs - rhs.mean(axis=(-3, -2, -1), keepdims=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("poisson"))
    rhs, rhs_b = _rhs((N, N, N), 3), _rhs((2, N, N, N), 4)
    paths = [os.path.join(root, f) for f in ("rhs.npy", "rhs_b.npy")]
    np.save(paths[0], rhs)
    np.save(paths[1], rhs_b)
    ref_dir = os.path.join(root, "reference")
    os.makedirs(ref_dir)
    out = run_reference(REFERENCE.format(rhs=paths[0], rhs_b=paths[1],
                                         topologies=TOPOLOGIES,
                                         out=ref_dir), devices=4)
    assert "done" in out
    port_dir = run_ranks("poisson_body", 4, root, *paths, BACKENDS,
                         TOPOLOGIES)

    def load(where, name):
        return np.load(os.path.join(where, f"{name}.npy"))

    return {"rhs": rhs, "rhs_b": rhs_b, "ref": lambda n: load(ref_dir, n),
            "port": lambda n: load(port_dir, n)}


def _periodic_residual(phi, rhs) -> float:
    lap = sum(np.roll(phi, s, a) for a in range(3) for s in (1, -1)) - 6 * phi
    return float(np.max(np.abs(lap / DX**2 - rhs)) / np.max(np.abs(rhs)))


def _neumann_residual(phi, rhs) -> float:
    """Interior-point residual with Neumann ghost cells on z."""
    pz = np.concatenate([phi[:, :, :1], phi, phi[:, :, -1:]], axis=2)
    lap = (np.roll(phi, 1, 0) + np.roll(phi, -1, 0) + np.roll(phi, 1, 1)
           + np.roll(phi, -1, 1) + pz[:, :, 2:] + pz[:, :, :-2]
           - 6 * phi) / DX**2
    return float(np.max(np.abs(lap - rhs)) / np.max(np.abs(rhs)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_periodic_residual_on_2x2(runs, backend):
    phi = runs["port"](f"phi_ppp_{backend}")
    assert phi.dtype == np.float32 and phi.shape == (N, N, N)
    assert _periodic_residual(phi, runs["rhs"]) < 1e-4


@pytest.mark.parametrize("backend", BACKENDS)
def test_ppb_neumann_residual_on_2x2(runs, backend):
    """(Periodic, Periodic, Bounded) — the Fig. 8 PPB case (DCT along z)."""
    phi = runs["port"](f"phi_ppb_{backend}")
    assert phi.dtype == np.float32
    assert _neumann_residual(phi, runs["rhs"]) < 1e-3


@pytest.mark.parametrize("name", ["ppp", "ppb"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_null_mode_on_2x2(runs, name, backend):
    """The null (mean) mode is zeroed for every batch element, on the one
    rank that holds spectral index (0, 0, 0): a batched solve agrees with
    per-slice solves."""
    phi_b = runs["port"](f"batched_{name}_{backend}")
    for i in range(2):
        d = np.max(np.abs(phi_b[i] - runs["port"](f"slice{i}_{name}_"
                                                  f"{backend}")))
        assert float(d) < 1e-5
        assert float(np.abs(phi_b[i].mean())) < 1e-5


@pytest.mark.parametrize("name", ["ppp", "ppb"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_solve_matches_reference_on_2x2(runs, name, backend):
    ref_be = REFERENCE_BACKEND[backend]
    for what in ("phi", "batched"):
        got = runs["port"](f"{what}_{name}_{backend}")
        ref = np.real(runs["ref"](f"{what}_{name}_{ref_be}"))
        assert_scaled_close(got, ref, 2e-4)


# ---------------------------------------------------------------------------
# Single rank
# ---------------------------------------------------------------------------

@pytest.fixture
def mesh():
    return make_mesh((1, 1), ("data", "model"), device="cpu")


@pytest.mark.parametrize("topology", ["periodic", "bounded"])
@pytest.mark.parametrize("n,length", [(16, 2 * np.pi), (12, 3.0)])
def test_eigenvalues_match_reference(topology, n, length):
    np.testing.assert_array_equal(
        api.poisson_eigenvalues(n, length, topology),
        japi.poisson_eigenvalues(n, length, topology))


@pytest.mark.parametrize("topology", [("bounded",) * 3,
                                      ("bounded", "periodic", "bounded")])
@pytest.mark.parametrize("backend", BACKENDS)
def test_bounded_topologies_match_reference(cpu_mesh, mesh, topology,
                                            backend):
    """All-bounded (a real all-dct2 plan) and mixed topologies with
    unequal box lengths, against the JAX solve on one device."""
    rhs = _rhs((8, 12, 16), 7)
    lengths = (1.0, 2.0, 3.0)
    got = api.poisson_solve(torch.from_numpy(rhs), mesh=mesh,
                            topology=topology, lengths=lengths,
                            backend=backend)
    ref = japi.poisson_solve(jnp.asarray(rhs), mesh=cpu_mesh,
                             topology=topology, lengths=lengths,
                             backend=REFERENCE_BACKEND[backend])
    assert got.dtype == torch.float32
    assert_scaled_close(got.numpy(), np.real(np.asarray(ref)), 2e-4)


def test_solver_plan_dtypes_and_complex_rhs(mesh):
    solver = api.PoissonSolver(mesh, (8, 8, 8),
                               topology=("periodic", "periodic", "bounded"),
                               backend="kernel")
    assert solver.plan.kinds == ("fft", "fft", "dct2")
    assert solver.plan.dtype == torch.float32
    assert solver.plan.out_struct.dtype == torch.complex64
    # a complex rhs keeps its imaginary part: the solve is linear over C
    re, im = _rhs((8, 8, 8), 5), _rhs((8, 8, 8), 6)
    got = api.poisson_solve(torch.from_numpy(re + 1j * im), mesh=mesh,
                            topology=("periodic", "periodic", "bounded"))
    assert got.dtype == torch.complex64
    want = [api.poisson_solve(torch.from_numpy(p), mesh=mesh,
                              topology=("periodic", "periodic", "bounded"))
            for p in (re, im)]
    assert_scaled_close(got.numpy(), want[0].numpy() + 1j * want[1].numpy(),
                        1e-5)


def test_memoized_solver_is_shared_and_reused(mesh):
    api.clear_plan_memo()
    rhs = torch.from_numpy(_rhs((8, 8, 8), 8))
    a = api.poisson_solve(rhs, mesh=mesh, backend="cufft")
    b = api.poisson_solve(rhs, mesh=mesh, backend="cufft")
    assert torch.equal(a, b)
    stats = api.plan_memo_stats()
    assert stats["misses"] == 1 and stats["hits"] == 1
    (solver,) = list(api._PLAN_MEMO.values())
    assert solver.plan.shared
    assert not api.PoissonSolver(mesh, (8, 8, 8)).plan.shared
    text = solver.describe()
    assert text.startswith("PoissonSolver(topology=PxPxP, tuning='off')")
    assert "kinds=('fft', 'fft', 'fft')" in text
    api.clear_plan_memo()


def test_solver_rejects_what_is_not_ported(mesh):
    for mode in ("heuristic", "auto"):
        with pytest.raises(NotImplementedError, match=f"tuning={mode!r}"):
            api.PoissonSolver(mesh, (8, 8, 8), tuning=mode)
    with pytest.raises(ValueError, match="3-D grid"):
        api.PoissonSolver(mesh, (8, 8))
