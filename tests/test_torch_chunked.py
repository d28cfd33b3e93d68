"""Chunked, overlapped hops in the port (``core/redistribute.py`` and
``core/pipeline.py``) against the JAX package.

* Spec parity: ``make_spec``'s per-hop schedule, its pre-clamp ask and its
  clamp warnings equal the reference's (the cases of
  ``tests/test_distributed_fft.py``'s chunk tests among them).
* 4 gloo ranks on a 2x2 mesh run chunked C2C, R2C and DCT plans, forward
  and inverse, on ``cufft`` and on ``kernel`` (its plain version, with the
  pack epilogue per chunk), against the JAX plan with the same schedule on
  4 fake XLA devices at 2e-4 max-scaled (the round trip at 1e-4), and
  against the port's own bulk plan at 5e-6.
* A recorder shows chunk k+1's exchange is issued before ``then`` runs on
  chunk k.
"""
import importlib
import json
import os
import types
import warnings

import numpy as np
import pytest
import torch

from repro.core import decomp as jd
from repro.core import pipeline as jp
from repro_torch.compat import Mesh, make_mesh
from repro_torch.core import decomp as td
from repro_torch.core import pipeline as tp
from repro_torch.core.api import plan_fft
from repro_torch.core.transforms import REFERENCE_BACKEND
from torch_harness import (assert_scaled_close, cplx, run_ranks,
                           run_reference, scaled_err)

# The package exports the function `redistribute` under the module's name.
tred = importlib.import_module("repro_torch.core.redistribute")

NAMES = ("data", "model")


def views(shape):
    port = Mesh(NAMES, tuple(shape), (0, 0), torch.device("cpu"),
                {n: None for n in NAMES})
    ref = types.SimpleNamespace(axis_names=NAMES,
                                devices=np.empty(shape, dtype=object))
    return port, ref


SPEC_CASES = [
    # (grid, decomp, axes, groups, mesh shape, kinds, n_chunks, batch)
    ((4, 8, 16), "pencil", NAMES, None, (2, 4), "c2c", (8, 2), ()),
    ((4, 8, 16), "pencil", NAMES, None, (2, 4), "c2c", 8, ()),
    ((4, 8, 16), "pencil", NAMES, None, (2, 4), "c2c", (2, 2), ()),
    ((8, 8, 16), "slab", ("model",), None, (2, 4), "c2c", 2, ()),
    ((8, 8, 16), "slab", ("model",), None, (2, 4), "c2c", (4,), ()),
    ((8, 8, 16), "pencil", NAMES, None, (2, 2), "r2c", 4, ()),
    ((8, 8, 16), "pencil", NAMES, None, (2, 2), "r2c", (3, 8), ()),
    ((8, 8, 16), "pencil", NAMES[::-1], None, (2, 2), "r2r", (4, 2), ()),
    ((8, 8, 16), "hybrid", NAMES, ((0,), (1, 2)), (2, 2), "c2c", 4, ()),
    ((8, 8, 8, 16), "hybrid", NAMES, ((0, 1), (2, 3)), (2, 2), "c2c",
     (4,), ()),
    ((8, 8, 16), "pencil", NAMES, None, (1, 1), "c2c", 16, ()),
    ((8, 8, 16), "pencil", NAMES, None, (2, 2), "c2c", 3, (6,)),
    ((8, 8, 16), "slab", ("data",), None, (2, 2), "c2c", (5,), (6,)),
    ((8, 8, 16), "pencil", NAMES, None, (2, 2), "c2c", 1, ()),
]


def _kinds(family, ndim):
    return {"c2c": ("fft",) * ndim,
            "r2c": ("rfft",) + ("fft",) * (ndim - 1),
            "r2r": ("dct2",) + ("fft",) * (ndim - 2) + ("dct2",)}[family]


@pytest.mark.parametrize("case", SPEC_CASES)
@pytest.mark.parametrize("inverse", [False, True])
def test_make_spec_matches_reference(case, inverse):
    grid, decomp, axes, groups, shape, family, n_chunks, batch = case
    port_mesh, ref_mesh = views(shape)
    kinds = _kinds(family, len(grid))
    tdec = td.make_decomposition(decomp, axes, len(grid), dim_groups=groups)
    jdec = jd.make_decomposition(decomp, axes, len(grid), dim_groups=groups)
    bspec = (None,) * len(batch)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = tp.make_spec(port_mesh, grid, tdec, kinds, n_chunks=n_chunks,
                           inverse=inverse, batch_spec=bspec)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jp.make_spec(ref_mesh, grid, jdec, kinds, n_chunks=n_chunks,
                            inverse=inverse, batch_spec=bspec)
    assert got.chunk_schedule == want.chunk_schedule
    assert got.chunk_schedule_requested == want.chunk_schedule_requested
    assert (got.n_chunks, got.n_chunks_requested, got.uniform_chunks,
            got.chunk_clamped, got.hop_clamps) == \
        (want.n_chunks, want.n_chunks_requested, want.uniform_chunks,
         want.chunk_clamped, want.hop_clamps)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert tp.chunk_sites(got, port_mesh.axis_sizes) == \
        jp.chunk_sites(want, dict(zip(NAMES, shape)))


def test_reference_clamp_cases_and_describe():
    """The numbers of ``test_distributed_fft.py``'s clamp tests, through
    the port's plan API on a 2x4 rank view."""
    port_mesh, _ = views((2, 4))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        p = plan_fft(port_mesh, (4, 8, 16), decomp="pencil",
                     n_chunks=(8, 2))
    spec = p.pipeline_spec()
    assert spec.chunk_schedule == (4, 2)
    assert spec.chunk_schedule_requested == (8, 2)
    assert spec.hop_clamps == ((0, 8, 4),)
    assert any("clamped" in str(x.message) for x in w)
    text = p.describe()
    assert "per-hop (4, 2)" in text
    assert "clamped from (8, 2) at hop 0" in text
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        p8 = plan_fft(port_mesh, (4, 8, 16), decomp="pencil", n_chunks=8)
    assert p8.n_chunks == 2 and p8.pipeline_spec().n_chunks_requested == 8
    assert "clamped from 8" in p8.describe()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ps = plan_fft(port_mesh, (8, 8, 16), decomp="slab",
                      mesh_axes=("model",), n_chunks=2)
    assert ps.pipeline_spec(inverse=True).chunk_schedule == (1,)
    assert any("no redistribution" in str(x.message) for x in w)
    assert "inverse=1" in ps.describe()


def test_redistribute_falls_back_and_clamps_with_warnings():
    mesh = make_mesh((1, 1), NAMES, device="cpu")
    dec = td.pencil_nd(NAMES, 3)
    x = torch.from_numpy(cplx((4, 6, 8), 1))
    # every dim busy or avoided: bulk with a warning
    with pytest.warns(RuntimeWarning, match="no legal chunk dim for hop 3"):
        got = tred.redistribute(x, dec.redists[0], mesh=mesh, n_chunks=2,
                                avoid_dims=(0, 1, 2), hop_index=3)
    assert got is x
    # hop 0's chunk dim is 2 (size 8): 3 clamps to 2
    seen = []
    with pytest.warns(RuntimeWarning, match=r"chunk dim 2 \(size 8\) of "
                      r"this hop not divisible by n_chunks=3; clamped to 2"):
        got = tred.redistribute(x, dec.redists[0], mesh=mesh, n_chunks=3,
                                then=lambda t: seen.append(t.shape) or t,
                                avoid_dims=(1,))
    assert seen == [(4, 6, 4)] * 2 and torch.equal(got, x)


def test_packed_chunks_join_into_one_send_buffer():
    """Packed chunk outputs join along the chunk dim's place among the
    send buffer's ``others``, equal to packing the joined block."""
    x = torch.from_numpy(cplx((4, 6, 8), 2))
    for split, chunk in ((0, 2), (2, 0), (1, 2)):
        parts = 2
        pieces = x.chunk(2, dim=chunk)
        packed = [tred.PackedBlock(tred.send_buffer(p, split, parts), split)
                  for p in pieces]
        joined = tred._join(packed, chunk)
        assert isinstance(joined, tred.PackedBlock)
        assert torch.equal(joined.send, tred.send_buffer(x, split, parts))
        assert torch.equal(joined.logical(), x)
        # and cutting a packed block gives the chunk's packed layout
        cut = tred._narrow(tred.PackedBlock(tred.send_buffer(x, split, 2),
                                            split), chunk, 0,
                           x.shape[chunk] // 2)
        assert torch.equal(cut.logical(), pieces[0])


# ---------------------------------------------------------------------------
# 4 gloo ranks against 4 fake XLA devices
# ---------------------------------------------------------------------------

GRID = (8, 8, 16)
C2C, R2C, DCT = ("fft",) * 3, ("rfft", "fft", "fft"), ("dct2", "fft", "dct2")
CASES = [
    ("c2c_pencil_cufft_2", C2C, "pencil", "cufft", 2),
    ("c2c_pencil_kernel_24", C2C, "pencil", "kernel", (2, 4)),
    ("c2c_pencil_kernel_4", C2C, "pencil", "kernel", 4),
    ("c2c_slab_kernel_2", C2C, "slab", "kernel", 2),
    ("c2c_hybrid_cufft_2", C2C, "hybrid", "cufft", 2),
    ("r2c_pencil_cufft_22", R2C, "pencil", "cufft", (2, 2)),
    ("r2c_pencil_kernel_2", R2C, "pencil", "kernel", 2),
    ("dct_pencil_cufft_42", DCT, "pencil", "cufft", (4, 2)),
    ("dct_pencil_kernel_2", DCT, "pencil", "kernel", 2),
]

REFERENCE = """
import warnings
import numpy as np, jax.numpy as jnp
from repro.compat import AxisType, make_mesh
from repro.core.api import plan_fft
warnings.simplefilter("ignore")
mesh = make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
xc = jnp.asarray(np.load({x!r}))
xr = jnp.asarray(np.load({xr!r}))
for name, kinds, decomp, be, n_chunks in {cases!r}:
    x = xc if kinds == ("fft",) * 3 else xr
    plan = plan_fft(mesh, {grid!r}, kinds=kinds, decomp=decomp, backend=be,
                    n_chunks=n_chunks)
    y = plan.forward(x)
    np.save({out!r} + f"/fwd_{{name}}.npy", np.asarray(y))
    np.save({out!r} + f"/rt_{{name}}.npy", np.asarray(plan.inverse(y)))
    np.save({out!r} + f"/sched_{{name}}.npy",
            np.asarray(plan.pipeline_spec().chunk_schedule
                       + plan.pipeline_spec(inverse=True).chunk_schedule))
print("done")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("chunked"))
    x = cplx(GRID, 11)
    xr = np.random.default_rng(12).standard_normal(GRID).astype(np.float32)
    paths = [os.path.join(root, f) for f in ("x.npy", "xr.npy")]
    np.save(paths[0], x)
    np.save(paths[1], xr)
    ref_dir = os.path.join(root, "reference")
    os.makedirs(ref_dir)
    ref_cases = [(n, k, d, REFERENCE_BACKEND[b], c)
                 for n, k, d, b, c in CASES]
    out = run_reference(REFERENCE.format(x=paths[0], xr=paths[1],
                                         cases=ref_cases, grid=GRID,
                                         out=ref_dir), devices=4)
    assert "done" in out
    port_dir = run_ranks("chunked_body", 4, root, *paths, GRID, CASES)
    stats = []
    for rank in range(4):
        with open(os.path.join(port_dir, f"stats{rank}.json")) as f:
            stats.append(json.load(f))

    def load(where, name):
        return np.load(os.path.join(where, f"{name}.npy"))

    return {"x": x, "xr": xr, "ref": lambda n: load(ref_dir, n),
            "port": lambda n: load(port_dir, n), "stats": stats}


NAMES_OF_CASES = [c[0] for c in CASES]


@pytest.mark.parametrize("name", NAMES_OF_CASES)
def test_chunked_forward_matches_reference(runs, name):
    assert_scaled_close(runs["port"](f"fwd_{name}"),
                        runs["ref"](f"fwd_{name}"), 2e-4)


@pytest.mark.parametrize("name", NAMES_OF_CASES)
def test_chunked_round_trip_matches_reference(runs, name):
    kinds = dict((c[0], c[1]) for c in CASES)[name]
    x = runs["x"] if kinds == C2C else runs["xr"]
    got = runs["port"](f"rt_{name}")
    assert_scaled_close(got, x, 1e-4)
    assert_scaled_close(got, np.asarray(runs["ref"](f"rt_{name}"),
                                        dtype=got.dtype), 2e-4)


@pytest.mark.parametrize("name", NAMES_OF_CASES)
def test_chunked_matches_own_bulk(runs, name):
    assert scaled_err(runs["port"](f"fwd_{name}"),
                      runs["port"](f"bulk_{name}")) <= 5e-6


@pytest.mark.parametrize("name", NAMES_OF_CASES)
def test_schedules_agree_across_ranks_and_with_reference(runs, name):
    first = runs["stats"][0][name]
    for rank_stats in runs["stats"][1:]:
        assert rank_stats[name] == first
    sched = tuple(first["fwd_schedule"]) + tuple(first["inv_schedule"])
    assert sched == tuple(int(v) for v in runs["ref"](f"sched_{name}"))


def test_pack_epilogue_ran_per_chunk(runs):
    """Kernel pencil: stage 0 packs once for hop 0, and stage 1 packs once
    per chunk of hop 0 for hop 1; other backends never pack."""
    for rank_stats in runs["stats"]:
        s = rank_stats["c2c_pencil_kernel_24"]
        assert s["fwd_schedule"] == [2, 4] and s["inv_schedule"] == [4, 2]
        assert (s["fwd_packs"], s["inv_packs"]) == (1 + 2, 1 + 4)
        s = rank_stats["c2c_pencil_kernel_4"]
        assert (s["fwd_packs"], s["inv_packs"]) == (5, 5)
        assert rank_stats["c2c_pencil_cufft_2"]["fwd_packs"] == 0


def test_inverse_slab_runs_bulk_with_a_warning(runs):
    s = runs["stats"][0]["c2c_slab_kernel_2"]
    assert s["fwd_schedule"] == [2] and s["inv_schedule"] == [1]
    assert any("no redistribution" in w for w in s["warnings"])


def test_next_exchange_issued_before_then_runs(runs):
    for rank_stats in runs["stats"]:
        rec = rank_stats["recorder"]
        assert rec["equal"]
        assert rec["events"] == ["issue", "issue", "then", "issue", "then",
                                 "issue", "then", "then"]
