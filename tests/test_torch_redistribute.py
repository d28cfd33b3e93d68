"""The port's redistribution (``repro_torch/core/redistribute.py``): the
send-buffer layout, bulk hops over gloo ranks for every decomposition
family, and its metadata helpers against the JAX package's."""
import importlib
import json
import os

import numpy as np
import pytest
import torch

from repro.core.decomp import hybrid_nd as j_hybrid_nd
from repro.core.decomp import pencil_nd as j_pencil_nd
from repro_torch.compat import gather, local_block, make_mesh
from repro_torch.core.decomp import hybrid_nd, pencil_nd, slab_nd
from torch_harness import cplx, run_ranks

# The packages export a function named ``redistribute`` that shadows the
# module attribute, so the modules are fetched by name.
jred = importlib.import_module("repro.core.redistribute")
tred = importlib.import_module("repro_torch.core.redistribute")

# (kind, axes, ndim, dim_groups, grid, batch) — all on a 2x2 mesh.
HOP_CASES = [
    ("pencil", ("data", "model"), 3, None, (8, 8, 8), ()),
    ("pencil", ("data", "model"), 3, None, (4, 8, 4), (2,)),
    ("slab", ("model",), 3, None, (8, 4, 8), ()),
    ("hybrid", ("data", "model"), 3, ((0,), (1, 2)), (8, 4, 4), ()),
    ("hybrid", ("data", "model"), 4, ((0, 1), (2, 3)), (4, 4, 4, 4), ()),
    ("hybrid", ("data", "model"), 2, ((0,), (1,)), (8, 12), ()),
]


@pytest.fixture(scope="module")
def hop_results(tmp_path_factory):
    out = run_ranks("redistribute_body", 4,
                    tmp_path_factory.mktemp("redistribute"), HOP_CASES)
    rows = []
    for rank in range(4):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            rows += [(rank, *r) for r in json.load(f)]
    return rows


@pytest.mark.parametrize("case", range(len(HOP_CASES)))
def test_hops_land_declared_blocks_on_4_ranks(hop_results, case):
    """Every hop (forward and inverse order, bulk and from a packed send
    buffer) leaves each rank holding exactly its block under the next
    stage's declared spec — the all_to_all(tiled=True) semantics."""
    rows = [r for r in hop_results if r[1] == case]
    assert rows, "no hop ran for this case"
    bad = [r for r in rows if not r[4]]
    assert not bad, f"mismatched (rank, case, inverse, hop): {bad}"


@pytest.mark.parametrize("case", range(len(HOP_CASES)))
def test_hops_move_real_blocks_on_4_ranks(hop_results, case):
    """All-R2R plans move real blocks: every hop of every decomposition
    family lands a float32 block exactly, as it does a complex one."""
    rows = [r for r in hop_results if r[1] == case]
    assert rows, "no hop ran for this case"
    bad = [r for r in rows if not r[5]]
    assert not bad, f"mismatched float32 (rank, case, inverse, hop): {bad}"


def test_send_buffer_layout_and_unpack_roundtrip():
    x = torch.from_numpy(cplx((4, 6, 8), 1))
    for split in range(3):
        for parts in (1, 2):
            buf = tred.send_buffer(x, split, parts)
            n = x.shape[split]
            others = [s for d, s in enumerate(x.shape) if d != split]
            assert tuple(buf.shape) == (parts, *others, n // parts)
            assert buf.is_contiguous()
            # block i holds indices [i*n/p, (i+1)*n/p) of the split dim
            blk = x.narrow(split, n // parts, n // parts) if parts == 2 \
                else x
            assert torch.equal(buf[parts - 1],
                               blk.movedim(split, -1))
            assert torch.equal(tred.unpack_send(buf, split), x)


def test_packed_block_send_is_zero_copy():
    x = torch.from_numpy(cplx((4, 6, 8), 2))
    buf = tred.send_buffer(x, 2, 2)
    pb = tred.PackedBlock(send=buf, split_dim=2)
    assert tred.send_buffer(pb, 2, 2).data_ptr() == buf.data_ptr()
    assert torch.equal(pb.logical(), x)
    # a packed block asked for another split falls back to its logical form
    assert torch.equal(tred.send_buffer(pb, 0, 2),
                       tred.send_buffer(x, 0, 2))


def test_size_one_axis_is_identity_and_chunks_raise():
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    dec = pencil_nd(("data", "model"), 3)
    x = torch.from_numpy(cplx((4, 4, 4), 3))
    assert tred.redistribute(x, dec.redists[0], mesh=mesh) is x
    pb = tred.PackedBlock(tred.send_buffer(x, 0, 1), 0)
    assert torch.equal(tred.redistribute(pb, dec.redists[0], mesh=mesh), x)
    seen = []
    tred.redistribute(x, dec.redists[1], mesh=mesh, then=seen.append)
    assert seen and seen[0] is x
    # chunked: the next stage runs once per chunk and the chunks join back;
    # a hop whose every dim is busy or avoided runs bulk with a warning
    seen = []
    got = tred.redistribute(x, dec.redists[0], mesh=mesh, n_chunks=2,
                            then=lambda t: seen.append(t.shape) or t,
                            avoid_dims=(1,))
    assert seen == [(4, 4, 2)] * 2 and torch.equal(got, x)
    with pytest.warns(RuntimeWarning, match="no legal chunk dim"):
        tred.redistribute(x, dec.redists[0], mesh=mesh, n_chunks=2,
                          avoid_dims=(0, 1, 2))


def test_local_block_and_gather_single_rank():
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    x = torch.from_numpy(cplx((4, 4, 4), 4))
    spec = (None, "data", ("data", "model"))
    assert local_block(x, spec, mesh) is x
    assert gather(x, spec, mesh) is x
    with pytest.raises(ValueError, match="spec"):
        local_block(x, (None, "data"), mesh)


@pytest.mark.parametrize("n,cap", [(12, 5), (7, 3), (16, 16), (1, 4),
                                   (30, 7)])
def test_largest_divisor_at_most_matches_reference(n, cap):
    assert tred.largest_divisor_at_most(n, cap) == \
        jred.largest_divisor_at_most(n, cap)


@pytest.mark.parametrize("offset", [0, 1])
def test_free_chunk_dim_matches_reference(offset):
    for tdec, jdec in ((pencil_nd(("a", "b"), 3), j_pencil_nd(("a", "b"), 3)),
                       (hybrid_nd(((0,), (1, 2)), ("a", "b")),
                        j_hybrid_nd(((0,), (1, 2)), ("a", "b")))):
        for th, jh in zip(tdec.redists, jdec.redists):
            for avoid in ((), (offset,), (offset + 2,)):
                nd = 3 + offset
                assert tred.free_chunk_dim(th, nd, offset, avoid) == \
                    jred.free_chunk_dim(jh, nd, offset, avoid)


def test_transpose_cost_and_hop_move_shapes_match_reference():
    sizes = {"a": 2, "b": 4}
    for shape, p in (((8, 4, 4), 2), ((16, 2, 8), 4), ((3,), 1)):
        assert tred.transpose_cost_bytes(shape, 8, p) == \
            jred.transpose_cost_bytes(shape, 8, p)
    tdec = hybrid_nd(((0, 1), (2, 3)), ("a", "b"))
    jdec = j_hybrid_nd(((0, 1), (2, 3)), ("a", "b"))
    got = [(m.mesh_axis, s) for m, s in
           tred.hop_move_shapes(tdec.redists[0], (8, 8, 4, 2), sizes)]
    want = [(m.mesh_axis, s) for m, s in
            jred.hop_move_shapes(jdec.redists[0], (8, 8, 4, 2), sizes)]
    assert got == want and len(got) == 2
    assert slab_nd("a", 3).redists[0].moves[0].split_dim == 0
    assert np.prod(got[-1][1]) == 8 * 8 * 4 * 2
