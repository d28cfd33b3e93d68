"""The slice as a whole: the port's 3-D C2C plans on 2x2 gloo ranks against
the JAX package's plans on 4 fake XLA devices (``backend="pallas"`` in
interpret mode, and ``"xla"``), at ``tests/test_pallas_backend.py``'s 2e-4
max-scaled tolerance; plus single-rank plans and the pipeline's static
decisions against the reference."""
import json
import os

import numpy as np
import pytest
import torch

from repro.core import pipeline as jp
from repro.core.decomp import make_decomposition as j_make_decomposition
from repro_torch.compat import make_mesh
from repro_torch.core import pipeline as tp
from repro_torch.core.api import plan_fft
from repro_torch.core.decomp import make_decomposition
from repro_torch.core.transforms import REFERENCE_BACKEND
from torch_harness import (assert_scaled_close, cplx, run_ranks,
                           run_reference)

GRID = (16, 16, 32)
DECOMPS = ("pencil", "slab")
BACKENDS = ("kernel", "cufft", "matmul")

REFERENCE = """
import numpy as np, jax.numpy as jnp
from repro.compat import make_mesh
from repro.core.api import plan_fft
mesh = make_mesh((2, 2), ("data", "model"))
x = jnp.asarray(np.load({x!r}))
for decomp in {decomps!r}:
    for be in ("pallas", "xla", "matmul"):
        plan = plan_fft(mesh, {grid!r}, decomp=decomp, backend=be)
        y = plan.forward(x)
        np.save({out!r} + f"/fwd_{{decomp}}_{{be}}.npy", np.asarray(y))
        np.save({out!r} + f"/inv_{{decomp}}_{{be}}.npy",
                np.asarray(plan.inverse(x)))
print("done")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One reference run (4 fake devices) and one port run (4 gloo ranks)
    on the same seeded operand."""
    root = tmp_path_factory.mktemp("pipeline")
    x = cplx(GRID, 5)
    x_path = os.path.join(str(root), "x.npy")
    np.save(x_path, x)
    ref_dir = os.path.join(str(root), "reference")
    os.makedirs(ref_dir)
    out = run_reference(REFERENCE.format(x=x_path, decomps=DECOMPS,
                                         grid=GRID, out=ref_dir), devices=4)
    assert "done" in out
    port_dir = run_ranks("pipeline_body", 4, root, x_path, GRID, (2, 2),
                         BACKENDS, DECOMPS)
    stats = []
    for rank in range(4):
        with open(os.path.join(port_dir, f"stats{rank}.json")) as f:
            stats.append(json.load(f))

    def load(where, name):
        return np.load(os.path.join(where, f"{name}.npy"))

    return {"x": x, "ref": lambda n: load(ref_dir, n),
            "port": lambda n: load(port_dir, n), "stats": stats}


@pytest.mark.parametrize("decomp", DECOMPS)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("ref_backend", ["pallas", "xla", "matmul"])
def test_forward_matches_reference_on_2x2(runs, decomp, backend,
                                          ref_backend):
    got = runs["port"](f"fwd_{decomp}_{backend}")
    assert_scaled_close(got, runs["ref"](f"fwd_{decomp}_{ref_backend}"),
                        2e-4)
    assert_scaled_close(got, np.fft.fftn(runs["x"]), 2e-4)


@pytest.mark.parametrize("decomp", DECOMPS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_inverse_matches_reference_on_2x2(runs, decomp, backend):
    got = runs["port"](f"inv_{decomp}_{backend}")
    ref = runs["ref"](f"inv_{decomp}_{REFERENCE_BACKEND[backend]}")
    assert_scaled_close(got, ref, 2e-4)


@pytest.mark.parametrize("decomp", DECOMPS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_round_trip_on_2x2(runs, decomp, backend):
    assert_scaled_close(runs["port"](f"rt_{decomp}_{backend}"), runs["x"],
                        1e-4)


def test_pack_epilogue_ran_on_every_rank(runs):
    """With the kernel backend each stage before a hop stores its output as
    the hop's send buffer when its last line transforms the dim the hop
    splits: a pencil packs before both hops in either direction (2 x 3
    calls); a slab only in the inverse (the forward's last line is dim 1,
    the hop splits dim 0); other backends never pack."""
    for rank_stats in runs["stats"]:
        assert rank_stats["pencil_kernel"]["packs"] == 6
        assert rank_stats["slab_kernel"]["packs"] == 2
        for be in ("cufft", "matmul"):
            assert rank_stats[f"pencil_{be}"]["packs"] == 0
        # pencil output block on a 2x2 mesh: (X/2, Y/2, Z)
        assert rank_stats["pencil_kernel"]["local_out"] == [8, 8, 32]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("grid,batch", [((8, 16, 4), ()), ((8, 12), (3,)),
                                        ((4, 6, 8, 2), ())])
def test_single_rank_plans_match_numpy(backend, grid, batch):
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    x = cplx(tuple(batch) + grid, 3)
    plan = plan_fft(mesh, grid, backend=backend, batch_shape=batch)
    y = plan.forward(torch.from_numpy(x))
    axes = tuple(range(len(batch), len(batch) + len(grid)))
    assert_scaled_close(y.numpy(), np.fft.fftn(x, axes=axes), 2e-5)
    back = plan.inverse(y, sharded_in=True)
    assert_scaled_close(back.numpy(), x, 1e-5)


def test_unported_pipeline_features_raise():
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    dec = make_decomposition("pencil", ("data", "model"), 3)
    # chunked hops are ported: the schedule is kept, in execution order
    spec = tp.make_spec(mesh, (8, 8, 8), dec, ("fft",) * 3, n_chunks=(2, 4),
                        inverse=True)
    assert spec.chunk_schedule == (4, 2)
    with pytest.raises(ValueError, match="3 entries"):
        tp.make_spec(mesh, (8, 8, 8), dec, ("fft",) * 3, n_chunks=(1, 1, 1))
    with pytest.raises(ValueError, match="unknown transform kinds"):
        tp.make_spec(mesh, (8, 8, 8), dec, ("fft", "fht", "fft"))


@pytest.mark.parametrize("kind,axes,groups,mesh_shape", [
    ("pencil", ("data", "model"), None, (2, 2)),
    ("pencil", ("data", "model"), None, (2, 4)),
    ("pencil", ("data", "model"), None, (3, 2)),
    ("slab", ("model",), None, (2, 4)),
    ("hybrid", ("data", "model"), ((0,), (1, 2)), (2, 3)),
    ("hybrid", ("data", "model"), ((0, 1), (2,)), (2, 2)),
])
@pytest.mark.parametrize("n0", [16, 15, 8])
def test_rfft_frequency_padding_matches_reference(kind, axes, groups,
                                                  mesh_shape, n0):
    """R2C pads the frequency dim n0//2 + 1 up to the LCM of the axis sizes
    sharding it downstream, as the reference does; other kinds keep it."""
    sizes = dict(zip(("data", "model"), mesh_shape))
    tdec = make_decomposition(kind, axes, 3, dim_groups=groups)
    jdec = j_make_decomposition(kind, axes, 3, dim_groups=groups)
    grid = (n0, 12, 12)
    for kinds in (("rfft", "fft", "fft"), ("fft", "fft", "dct2")):
        got = tp.effective_grid(grid, tdec, sizes, kinds)
        assert got == jp.effective_grid(grid, jdec, sizes, kinds)
        if kinds[0] == "fft":
            assert got == grid
    assert tp._freq_pad_target(tdec, sizes, n0 // 2 + 1) == \
        jp._freq_pad_target(jdec, sizes, n0 // 2 + 1)


@pytest.mark.parametrize("kind,axes,groups", [
    ("pencil", ("data", "model"), None),
    ("slab", ("model",), None),
    ("hybrid", ("data", "model"), ((0,), (1, 2))),
])
@pytest.mark.parametrize("inverse", [False, True])
def test_specs_and_pack_sites_match_reference(cpu_mesh, kind, axes, groups,
                                              inverse):
    """Stage order, in/out specs and the pack-fusion decision of every
    stage equal the reference pipeline's (kernel <-> pallas)."""
    tmesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    tdec = make_decomposition(kind, axes, 3, dim_groups=groups)
    jdec = j_make_decomposition(kind, axes, 3, dim_groups=groups)
    tspec = tp.make_spec(tmesh, (8, 8, 8), tdec, ("fft",) * 3,
                         backend="kernel", inverse=inverse, batch_spec=(None,))
    jspec = jp.make_spec(cpu_mesh, (8, 8, 8), jdec, ("fft",) * 3,
                         backend="pallas", inverse=inverse,
                         batch_spec=(None,))
    assert tspec.in_spec() == tuple(jspec.in_spec())
    assert tspec.out_spec() == tuple(jspec.out_spec())
    assert tspec.chunk_schedule == jspec.chunk_schedule
    assert tp.effective_grid((8, 8, 8), tdec, tmesh.axis_sizes,
                             ("fft",) * 3) == jspec.eff_grid
    tstages, thops = tspec.stage_order()
    jstages, jhops = jspec.stage_order()
    assert [s.spec for s in tstages] == [s.spec for s in jstages]
    for i, (ts, js) in enumerate(zip(tstages, jstages)):
        tn = thops[i] if i < len(thops) else None
        jn = jhops[i] if i < len(jhops) else None
        assert tp._pack_fusion_site(tspec, ts, tn) == \
            jp._pack_fusion_site(jspec, js, jn)
