"""The port's decomposition engine (``repro_torch/core/decomp.py``) against
the JAX package's, field by field, plus the hop replay of
``tests/test_decomp.py`` run on the port."""
import pytest

from repro.core import decomp as jd
from repro_torch.core import decomp as td

# (family, axes, ndim, dim_groups)
DECOMPS = [
    ("pencil", ("a", "b"), 3, None),
    ("pencil", ("a", "b", "c"), 4, None),
    ("pencil", ("a",), 2, None),
    ("slab", ("a",), 3, None),
    ("slab", ("b",), 4, None),
    ("hybrid", ("a", "b"), 3, ((0, 1), (2,))),
    ("hybrid", ("a", "b"), 3, ((0,), (1, 2))),
    ("hybrid", ("a", "b"), 4, ((0, 1), (2, 3))),
    ("hybrid", ("a", "b"), 4, ((0,), (1,), (2, 3))),
    ("hybrid", ("a", "b", "c"), 4, ((0, 1), (2, 3))),
    ("hybrid", ("a", "b", "c"), 4, ((0, 1, 2), (3,))),
    ("hybrid", ("a", "b"), 2, ((0,), (1,))),
    ("hybrid", ("a", "b"), 4, None),
]
AXIS_SIZES = {"a": 2, "b": 4, "c": 2}


def _both(family, axes, ndim, groups):
    return (td.make_decomposition(family, axes, ndim, dim_groups=groups),
            jd.make_decomposition(family, axes, ndim, dim_groups=groups))


def _moves(dec):
    return [[(m.mesh_axis, m.split_dim, m.concat_dim) for m in hop.moves]
            for hop in dec.redists]


@pytest.mark.parametrize("family,axes,ndim,groups", DECOMPS)
def test_stage_specs_and_hops_match_reference(family, axes, ndim, groups):
    t, j = _both(family, axes, ndim, groups)
    assert (t.name, t.mesh_axes, t.dim_groups) == \
        (j.name, j.mesh_axes, j.dim_groups)
    assert len(t.stages) == len(j.stages)
    for ts, js in zip(t.stages, j.stages):
        assert ts.spec == js.spec
        assert ts.fft_dims == js.fft_dims
        # the port's plain-tuple spec equals the reference PartitionSpec
        for lead in (0, 2):
            assert ts.partition_spec(lead) == tuple(js.partition_spec(lead))
    assert _moves(t) == _moves(j)
    assert [_moves_of(h.inverse()) for h in t.redists] == \
        [_moves_of(h.inverse()) for h in j.redists]
    assert [h.busy_dims() for h in t.redists] == \
        [h.busy_dims() for h in j.redists]
    assert td.describe_decomp(t.name, t.dim_groups) == \
        jd.describe_decomp(j.name, j.dim_groups)


def _moves_of(hop):
    return [(m.mesh_axis, m.split_dim, m.concat_dim) for m in hop.moves]


@pytest.mark.parametrize("family,axes,ndim,groups", DECOMPS)
def test_hop_replay_matches_declared_specs(family, axes, ndim, groups):
    """Replay every hop's moves on the port's metadata: each move peels its
    axis off the minor end of the source dim and appends it to the
    destination dim; the result must equal the next declared spec."""
    dec = td.make_decomposition(family, axes, ndim, dim_groups=groups)
    spec = [list(td.spec_axes(e)) for e in dec.stages[0].spec]
    for stage, hop in zip(dec.stages[1:], dec.redists):
        for mv in hop.moves:
            assert spec[mv.concat_dim].pop() == mv.mesh_axis
            spec[mv.split_dim].append(mv.mesh_axis)
        assert tuple(tuple(s) for s in spec) == \
            tuple(td.spec_axes(e) for e in stage.spec)


@pytest.mark.parametrize("family,axes,ndim,groups", DECOMPS)
def test_local_shapes_and_grid_validation_match_reference(family, axes,
                                                          ndim, groups):
    t, j = _both(family, axes, ndim, groups)
    good = (16,) * ndim
    for ts, js in zip(t.stages, j.stages):
        assert td.local_shape(ts, good, AXIS_SIZES) == \
            jd.local_shape(js, good, AXIS_SIZES)
    td.validate_grid(t, good, AXIS_SIZES)
    bad = (5,) * ndim
    with pytest.raises(ValueError) as terr:
        td.validate_grid(t, bad, AXIS_SIZES)
    with pytest.raises(ValueError) as jerr:
        jd.validate_grid(j, bad, AXIS_SIZES)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("ndim,n_axes", [(2, 1), (3, 2), (4, 2), (5, 3)])
def test_default_dim_groups_match_reference(ndim, n_axes):
    assert td.default_dim_groups(ndim, n_axes) == \
        jd.default_dim_groups(ndim, n_axes)


@pytest.mark.parametrize("call", [
    lambda m: m.pencil_nd(("a", "b"), 4),
    lambda m: m.slab_nd("a", 1),
    lambda m: m.hybrid_nd(((0,), (2,), (1,)), ("a", "b")),
    lambda m: m.hybrid_nd(((0,), (1,)), ("a", "a")),
    lambda m: m.hybrid_nd(((0, 1), (2,)), ("a", "b"), axis_counts=(3,)),
    lambda m: m.make_decomposition("slab", ("a", "b"), 3),
    lambda m: m.make_decomposition("cube", ("a",), 3),
    lambda m: m.StageLayout(spec=("a", None), fft_dims=(0,)),
    lambda m: m.Redistribution(mesh_axis="a", split_dim=1, concat_dim=1),
])
def test_invalid_constructions_raise_like_reference(call):
    with pytest.raises(ValueError) as terr:
        call(td)
    with pytest.raises(ValueError) as jerr:
        call(jd)
    assert str(terr.value) == str(jerr.value)


def test_paper_layouts_and_axis_products():
    assert td.pencil().stages[0].spec == jd.pencil().stages[0].spec
    assert td.slab().stages[1].spec == jd.slab().stages[1].spec
    for entry in (None, "a", ("a", "b"), ("b", "c", "a")):
        assert td.axis_product(entry, AXIS_SIZES) == \
            jd.axis_product(entry, AXIS_SIZES)
        assert td.spec_axes(entry) == jd.spec_axes(entry)
