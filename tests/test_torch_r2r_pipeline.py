"""R2C and R2R pipelines of the port on 2x2 gloo ranks against the JAX
package's plans on 4 fake XLA devices (``backend="pallas"`` in interpret
mode, ``"xla"`` and ``"matmul"``), pencil and slab, as
``tests/test_distributed_fft.py`` checks the reference: the padded R2C
forward (dim 0: 16//2 + 1 = 9 padded to 10) and the round trips within
1e-5, the mixed ``(fft, fft, dct2)`` plan of the PPB Poisson topology, and
an all-``dct2`` plan whose hops move real blocks."""
import json
import os

import numpy as np
import pytest

from repro_torch.core.transforms import REFERENCE_BACKEND
from torch_harness import assert_scaled_close, run_ranks, run_reference

GRID = (16, 8, 8)
DECOMPS = ("pencil", "slab")
BACKENDS = ("kernel", "cufft", "matmul")
CASES = (("r2c", ("rfft", "fft", "fft")),
         ("ppb", ("fft", "fft", "dct2")),
         ("bbb", ("dct2", "dct2", "dct2")))
NAMES = [name for name, _ in CASES]

REFERENCE = """
import numpy as np, jax.numpy as jnp
from repro.compat import make_mesh
from repro.core.api import plan_fft
mesh = make_mesh((2, 2), ("data", "model"))
x = jnp.asarray(np.load({x!r}))
for name, kinds in {cases!r}:
    for decomp in {decomps!r}:
        for be in ("pallas", "xla", "matmul"):
            plan = plan_fft(mesh, {grid!r}, kinds=kinds, decomp=decomp,
                            backend=be)
            np.save({out!r} + f"/fwd_{{name}}_{{decomp}}_{{be}}.npy",
                    np.asarray(plan.forward(x)))
print("done")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("r2r_pipeline"))
    x = np.random.default_rng(5).standard_normal(GRID).astype(np.float32)
    x_path = os.path.join(root, "x.npy")
    np.save(x_path, x)
    ref_dir = os.path.join(root, "reference")
    os.makedirs(ref_dir)
    out = run_reference(REFERENCE.format(x=x_path, cases=CASES,
                                         decomps=DECOMPS, grid=GRID,
                                         out=ref_dir), devices=4)
    assert "done" in out
    port_dir = run_ranks("r2r_pipeline_body", 4, root, x_path, GRID, CASES,
                         BACKENDS, DECOMPS)
    stats = []
    for rank in range(4):
        with open(os.path.join(port_dir, f"stats{rank}.json")) as f:
            stats.append(json.load(f))

    def load(where, name):
        return np.load(os.path.join(where, f"{name}.npy"))

    return {"x": x, "ref": lambda n: load(ref_dir, n),
            "port": lambda n: load(port_dir, n), "stats": stats}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("decomp", DECOMPS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_forward_matches_reference_on_2x2(runs, name, decomp, backend):
    got = runs["port"](f"fwd_{name}_{decomp}_{backend}")
    ref = runs["ref"](f"fwd_{name}_{decomp}_{REFERENCE_BACKEND[backend]}")
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert_scaled_close(got, ref, 1e-5)


@pytest.mark.parametrize("decomp", DECOMPS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_r2c_pads_frequency_dim_on_2x2(runs, decomp, backend):
    """16//2 + 1 = 9 frequencies padded to 10 (the LCM of the size-2 axes
    that shard dim 0 downstream); the pad is zero and the rest is
    ``fftn(x)[:9]``; the round trip comes back real within 1e-5."""
    y = runs["port"](f"fwd_r2c_{decomp}_{backend}")
    assert y.shape == (10, 8, 8) and y.dtype == np.complex64
    ref = np.fft.fftn(runs["x"])[:9]
    assert_scaled_close(y[:9], ref, 1e-5)
    assert not np.any(y[9:])
    rt = runs["port"](f"rt_r2c_{decomp}_{backend}")
    assert rt.dtype == np.float32
    assert float(np.max(np.abs(rt - runs["x"]))) < 1e-5


@pytest.mark.parametrize("name", ["ppb", "bbb"])
@pytest.mark.parametrize("decomp", DECOMPS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_r2r_round_trip_on_2x2(runs, name, decomp, backend):
    """The unnormalized DCT-III inverse is scaled by 1/(2N): the mixed plan
    comes back complex with the input as its real part, the all-R2R plan
    comes back real."""
    rt = runs["port"](f"rt_{name}_{decomp}_{backend}")
    assert rt.dtype == (np.complex64 if name == "ppb" else np.float32)
    assert float(np.max(np.abs(np.real(rt) - runs["x"]))) < 1e-5


@pytest.mark.parametrize("decomp", DECOMPS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_block_dtypes_on_every_rank(runs, decomp, backend):
    """Every rank's forward block: complex for the R2C and mixed plans,
    float32 for the all-dct2 plan, whose hops moved real blocks."""
    for rank_stats in runs["stats"]:
        assert rank_stats[f"r2c_{decomp}_{backend}"]["out_dtype"] == \
            "complex64"
        assert rank_stats[f"ppb_{decomp}_{backend}"]["out_dtype"] == \
            "complex64"
        assert rank_stats[f"bbb_{decomp}_{backend}"]["out_dtype"] == \
            "float32"
    # pencil output block on a 2x2 mesh: (X/2, Y/2, Z), X padded to 10
    if decomp == "pencil":
        assert runs["stats"][0][f"r2c_pencil_{backend}"]["local_out"] == \
            [5, 4, 8]
