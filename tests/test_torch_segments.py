"""Stage segments of the port (``core/pipeline.py`` segments and
``DistributedFFT.segments``) against the JAX package.

* Boundary structs: ``segment_structs`` derived from the spec (shape,
  dtype and layout at every boundary, both directions) equal the JAX
  package's ``segment_structs``, which it derives by abstract evaluation on
  4 fake XLA devices.
* 4 gloo ranks on a 2x2 mesh: chained segments equal ``plan.forward`` and
  ``plan.inverse`` bitwise on every rank, with and without donated
  interior buffers (the kernel backend's pack epilogue runs in the fused
  plan only), and the fused results match the JAX plan at 5e-6 scaled.
* In-process: segment specs chain, the plan cache keys segments apart
  from the fused pipeline, donation is refused on shared plans, and a
  donating segment empties its input.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.compat import Mesh, make_mesh
from repro_torch.core import pipeline as tp
from repro_torch.core.api import plan_fft
from repro_torch.core.plan import GLOBAL_PLAN_CACHE
from repro_torch.core.transforms import REFERENCE_BACKEND
from torch_harness import (assert_scaled_close, cplx, run_ranks,
                           run_reference)

NAMES = ("data", "model")
CASES = [
    ("pencil_het", dict(grid=(8, 8, 16), decomp="pencil", n_chunks=(4, 2))),
    ("pencil_rfft", dict(grid=(8, 8, 16), decomp="pencil",
                         kinds=("rfft", "fft", "fft"))),
    ("slab_chunked", dict(grid=(8, 8, 16), decomp="slab", n_chunks=2)),
    ("hybrid4d_het", dict(grid=(4, 4, 8, 8), decomp="hybrid",
                          dim_groups=((0, 1), (2,), (3,)),
                          n_chunks=(2, 4))),
    ("pencil_kernel", dict(grid=(8, 8, 16), decomp="pencil",
                           backend="kernel")),
    ("pencil_dct_batched", dict(grid=(8, 8, 16), decomp="pencil",
                                kinds=("dct2", "fft", "dct2"),
                                batch_shape=(2,))),
]
CASE_NAMES = [c[0] for c in CASES]


def _ref_cases():
    out = []
    for name, kw in CASES:
        kw = dict(kw)
        if "backend" in kw:
            kw["backend"] = REFERENCE_BACKEND[kw["backend"]]
        out.append((name, kw))
    return out


REFERENCE = """
import json, warnings
import numpy as np, jax, jax.numpy as jnp
from repro.compat import AxisType, make_mesh
from repro.core.api import plan_fft
warnings.simplefilter("ignore")
mesh = make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {{}}
for name, kw in {cases!r}:
    kw = dict(kw)
    grid = kw.pop("grid")
    plan = plan_fft(mesh, grid, precompiled=False, **kw)
    rec = {{}}
    for inverse in (False, True):
        rec["inv" if inverse else "fwd"] = [
            [list(s.shape), str(s.dtype), [
                list(e) if isinstance(e, tuple) else e
                for e in s.sharding.spec]
             + [None] * (len(s.shape) - len(s.sharding.spec))]
            for s in plan.segment_boundary_structs(inverse=inverse)]
    out[name] = rec
    if {run!r}:
        x = np.load({xdir!r} + f"/x_{{name}}.npy")
        y = plan(jnp.asarray(x))
        np.save({xdir!r} + f"/ref_fwd_{{name}}.npy", np.asarray(y))
        np.save({xdir!r} + f"/ref_inv_{{name}}.npy",
                np.asarray(plan.inverse(y)))
print("JSON" + json.dumps(out))
"""


def _reference(run: bool, xdir: str = ""):
    out = run_reference(REFERENCE.format(cases=_ref_cases(), run=run,
                                         xdir=xdir), devices=4)
    line = next(ln for ln in out.splitlines() if ln.startswith("JSON"))
    return json.loads(line[4:])


def _port_view(shape=(2, 2)):
    return Mesh(NAMES, tuple(shape), (0,) * len(shape), torch.device("cpu"),
                {n: None for n in NAMES})


def _struct_record(s):
    return [list(s.shape), str(s.dtype).removeprefix("torch."),
            [list(e) if isinstance(e, tuple) else e for e in s.spec]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("segments"))
    port_dir = run_ranks("segments_body", 4, root, CASES)
    ranks = []
    for rank in range(4):
        with open(os.path.join(port_dir, f"rank{rank}.json")) as f:
            ranks.append(json.load(f))
    ref = _reference(True, port_dir)

    def load(name):
        return np.load(os.path.join(port_dir, f"{name}.npy"))

    return {"ranks": ranks, "ref": ref, "load": load}


@pytest.mark.parametrize("name", CASE_NAMES)
@pytest.mark.parametrize("inverse", [False, True])
def test_boundary_structs_match_reference(runs, name, inverse):
    kw = dict(dict(CASES)[name])
    grid = kw.pop("grid")
    plan = plan_fft(_port_view(), grid, **kw)
    got = [_struct_record(s)
           for s in plan.segment_boundary_structs(inverse=inverse)]
    want = runs["ref"][name]["inv" if inverse else "fwd"]
    assert got == want
    # the chain's ends are the plan's own structs
    first, last = ((plan.inv_in_struct, plan.inv_out_struct) if inverse
                   else (plan.in_struct, plan.out_struct))
    structs = plan.segment_boundary_structs(inverse=inverse)
    assert structs[0] == first and structs[-1] == last


@pytest.mark.parametrize("name", CASE_NAMES)
def test_chained_segments_equal_fused_plan_bitwise(runs, name):
    for rank_rec in runs["ranks"]:
        rec = rank_rec[name]
        assert rec["bitwise"] == {"fwd_donate0": True, "inv_donate0": True,
                                  "fwd_donate1": True, "inv_donate1": True}
        assert rec["n_segments"] == (2 if name.startswith("slab") else 3)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_fused_results_match_reference(runs, name):
    load = runs["load"]
    assert_scaled_close(load(f"fwd_{name}"), load(f"ref_fwd_{name}"), 5e-6)
    got = load(f"inv_{name}")
    assert_scaled_close(got, np.asarray(load(f"ref_inv_{name}"),
                                        dtype=got.dtype), 5e-6)


def test_segment_specs_chain_and_segments_are_keyed_apart():
    mesh = make_mesh((1, 1), NAMES, device="cpu")
    plan = plan_fft(mesh, (8, 8, 16), n_chunks=(2, 2))
    for inverse in (False, True):
        spec = plan.pipeline_spec(inverse=inverse)
        n = tp.n_segments(spec)
        assert n == 3
        assert tp.segment_in_spec(spec, 0) == spec.in_spec()
        assert tp.segment_out_spec(spec, n - 1) == spec.out_spec()
        for j in range(n - 1):
            assert tp.segment_out_spec(spec, j) == \
                tp.segment_in_spec(spec, j + 1)
    with pytest.raises(ValueError, match="out of range"):
        tp.build_segment(mesh, plan.pipeline_spec(), 3)
    keys = set(GLOBAL_PLAN_CACHE.keys())
    segs = plan.segments()
    new = set(GLOBAL_PLAN_CACHE.keys()) - keys
    assert len(new) == 3
    assert all(k[-1][2:] == (True if j else False, "segment", j)
               for j, k in enumerate(sorted(new, key=lambda k: k[-1][-1])))
    assert plan.segments() is segs          # one list per variant
    assert plan.segments(donate_intermediates=False) is not segs


def test_segments_refuse_donation_on_shared_plans():
    mesh = make_mesh((1, 1), NAMES, device="cpu")
    plan = plan_fft(mesh, (8, 16))
    plan.shared = True
    with pytest.raises(ValueError, match="shared"):
        plan.segments(donate_input=True)
    assert plan.segments()                  # the non-donating ones are fine


def test_donating_segment_empties_its_input():
    mesh = make_mesh((1, 1), NAMES, device="cpu")
    plan = plan_fft(mesh, (8, 16))
    x = torch.from_numpy(cplx((8, 16), 3))
    keep = x.clone()
    want = plan.forward(keep)
    segs = plan.segments(donate_input=True)
    v = x
    for seg in segs:
        v = seg(v)
    assert torch.equal(v, want)
    assert x.numel() == 0 and x.untyped_storage().size() == 0


def test_structs_come_from_the_spec_not_from_running():
    """The boundary structs are derived without calling a segment."""
    mesh = _port_view()
    plan = plan_fft(mesh, (8, 8, 16), kinds=("rfft", "fft", "fft"))
    calls = []
    orig = tp.build_segment

    def spy(*a, **kw):
        calls.append(a)
        return orig(*a, **kw)

    tp.build_segment = spy
    try:
        structs = tp.segment_structs(mesh, plan.pipeline_spec(),
                                     dtype=torch.float32)
    finally:
        tp.build_segment = orig
    assert not calls
    assert [s.dtype for s in structs] == [torch.float32] + \
        [torch.complex64] * 3
    # the pencil's stage 0 runs the rfft: the pad (5 -> 6) shows from
    # boundary 1 on
    assert [s.shape[0] for s in structs] == [8, 6, 6, 6]
    assert structs[-1].local_shape == plan.out_struct.local_shape
