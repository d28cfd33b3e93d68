"""Decomposition engine for distributed FFTs (N-D).

The paper's central structural idea (Alg. 1) is that each FFT stage owns its
own distributed array with a *stage-specific* layout.  The textbook 3-D
layouts are pencil and slab:

  pencil:  D1 = (X full,   Y/Py,    Z/Pz)   -> x-FFT local
           D2 = (X/Py,     Y full,  Z/Pz)   -> y-FFT local
           D3 = (X/Py,     Y/Pz,    Z full) -> z-FFT local
  slab:    D1 = (X full,   Y full,  Z/P)    -> 2D xy-FFT local
           D3 = (X/P,      Y full,  Z full) -> z-FFT local

but the stage-per-DArray design admits *any* partition of the spatial dims
into contiguous **stage groups**: stage ``j`` locally transforms group ``j``
while every other group is sharded over the mesh axes.  :func:`hybrid_nd`
builds that general family — "pencil-over-k-axes" **hybrid** schedules:

* all groups of size 1 with one axis each recovers the pencil;
* one ``(ndim-1)``-dim group plus the final dim over one axis is the slab;
* middle points are new schedules: a 4-D FFT on a 2-axis mesh as two 2-dim
  slab stages with a single two-move transpose (pencil would demand three
  axes), or a 3-D "2+1" hybrid that runs 2 stages instead of 3 while still
  using both mesh axes (trading transpose count against per-stage
  parallelism — the pencil/slab swing AccFFT measured).

Because a group can be smaller than the number of axes it must absorb, a
single array dim may be sharded over *several* mesh axes at once: a
``StageLayout.spec`` entry is ``None`` (full), one axis name, or a tuple of
axis names (major axis first, as in JAX's ``PartitionSpec``).

A redistribution between stages is a :class:`RedistHop`: one or more
elementary :class:`Redistribution` moves (one ``all_to_all`` each)
executed sequentially.  Pencil/slab hops have exactly one move; hybrid hops
move every axis leaving the next group, e.g. two moves for the 4-D
two-group schedule.  Move order matters when a dim is sharded by an axis
tuple: axes are peeled off a source dim minor-axis-first, and a receiving
dim's tuple records its arrival order — the construction in
:func:`hybrid_nd` keeps the declared stage specs consistent with what the
sequential ``all_to_all``s actually produce.

These are pure metadata — no device state is touched here, so the module is
importable everywhere (tests, dry-run, benchmarks).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

# A spec entry: mesh axis name, tuple of axis names (major first), or None
# (replicated / full dim).
Axis = Union[None, str, Tuple[str, ...]]


def spec_axes(entry: Axis) -> Tuple[str, ...]:
    """Normalize one spec entry to a (possibly empty) tuple of axis names."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def axis_product(entry: Axis, axis_sizes: Dict[str, int]) -> int:
    """Number of shards a spec entry splits its dim into."""
    p = 1
    for ax in spec_axes(entry):
        p *= axis_sizes[ax]
    return p


def _canon(entry: Axis) -> Axis:
    """Canonical spec entry: () -> None, 1-tuple -> bare name."""
    axes = spec_axes(entry)
    if not axes:
        return None
    if len(axes) == 1:
        return axes[0]
    return axes


@dataclasses.dataclass(frozen=True)
class StageLayout:
    """Layout of one FFT stage's distributed array.

    ``spec[d]`` is the mesh axis — or tuple of axes, major first — that
    shards array dim ``d`` (None = full).  ``fft_dims`` are the array dims
    transformed locally in this stage — they must be unsharded (None) in
    ``spec``.
    """

    spec: Tuple[Axis, ...]
    fft_dims: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "spec", tuple(_canon(e) for e in self.spec))
        for d in self.fft_dims:
            if self.spec[d] is not None:
                raise ValueError(
                    f"stage transforms dim {d} but it is sharded over "
                    f"{self.spec[d]!r}: {self.spec}"
                )

    def partition_spec(self, extra_leading: int = 0) -> Tuple[Axis, ...]:
        """The spec as a plain tuple (the JAX package's ``PartitionSpec``),
        optionally with leading replicated (batch) dims."""
        return (None,) * extra_leading + self.spec


@dataclasses.dataclass(frozen=True)
class Redistribution:
    """One elementary all_to_all move between two layouts.

    On each rank this is one ``all_to_all_single`` over ``mesh_axis``'s
    process subgroup (``core/redistribute.py``):
    local dim ``split_dim`` is scattered across the axis while ``concat_dim``
    is gathered, i.e. the sharding moves from ``concat_dim`` to ``split_dim``.
    """

    mesh_axis: str
    split_dim: int    # full before, sharded after
    concat_dim: int   # sharded before, full after

    def __post_init__(self):
        if self.split_dim == self.concat_dim:
            raise ValueError("split_dim and concat_dim must differ")

    def inverse(self) -> "Redistribution":
        return Redistribution(mesh_axis=self.mesh_axis,
                              split_dim=self.concat_dim,
                              concat_dim=self.split_dim)


@dataclasses.dataclass(frozen=True)
class RedistHop:
    """A global transpose between two stage layouts: 1+ sequential moves.

    Pencil/slab hops are single moves.  Hybrid hops may move sharding
    across several dims (the 4-D two-group schedule) or peel several axes
    off one dim (the 3-D "1+2" hybrid) — one ``all_to_all`` per move, run
    back-to-back.
    """

    moves: Tuple[Redistribution, ...]

    def __post_init__(self):
        object.__setattr__(self, "moves", tuple(self.moves))
        if not self.moves:
            raise ValueError("a RedistHop needs at least one move")

    @property
    def mesh_axes(self) -> Tuple[str, ...]:
        return tuple(m.mesh_axis for m in self.moves)

    def busy_dims(self) -> Tuple[int, ...]:
        """Every dim touched by any move (split or concat side)."""
        dims = []
        for m in self.moves:
            for d in (m.split_dim, m.concat_dim):
                if d not in dims:
                    dims.append(d)
        return tuple(dims)

    def inverse(self) -> "RedistHop":
        """The hop undoing this one: swapped moves in reverse order."""
        return RedistHop(tuple(m.inverse() for m in reversed(self.moves)))


def _as_hop(r) -> RedistHop:
    if isinstance(r, RedistHop):
        return r
    if isinstance(r, Redistribution):
        return RedistHop((r,))
    return RedistHop(tuple(r))


@dataclasses.dataclass(frozen=True)
class Decomposition:
    """A full N-D FFT plan skeleton: stage layouts + redistribution hops.

    ``stages[i]`` is executed, then ``redists[i]`` (if any) realigns data
    for ``stages[i+1]``.  len(redists) == len(stages) - 1.  ``dim_groups``
    records the stage grouping of the spatial dims (always set; hybrid
    schedules are distinguished from each other by it).
    """

    name: str
    mesh_axes: Tuple[str, ...]
    stages: Tuple[StageLayout, ...]
    redists: Tuple[RedistHop, ...]
    dim_groups: Optional[Tuple[Tuple[int, ...], ...]] = None

    def __post_init__(self):
        object.__setattr__(self, "redists",
                           tuple(_as_hop(r) for r in self.redists))
        if len(self.redists) != len(self.stages) - 1:
            raise ValueError("need exactly one redistribution between stages")
        if self.dim_groups is None:
            object.__setattr__(
                self, "dim_groups",
                tuple(tuple(s.fft_dims) for s in self.stages))


def pencil_nd(mesh_axes: Sequence[str], ndim: int) -> Decomposition:
    """Pencil decomposition of ``ndim`` spatial dims over ``ndim-1`` axes.

    Stage ``i`` transforms dim ``i`` locally; the dims before it are sharded
    by the leading mesh axes, the dims after it by the trailing ones.  For
    ndim=3 this is exactly Alg. 1: three stages, two transposes (the x<->y
    transpose over ``mesh_axes[0]``, the y<->z transpose over
    ``mesh_axes[1]``).  For ndim=2 it degenerates to a single transpose over
    one axis (structurally the 2-D slab).
    """
    axes = tuple(mesh_axes)
    if len(axes) != ndim - 1:
        raise ValueError(
            f"pencil over {ndim} dims needs {ndim - 1} mesh axes, "
            f"got {axes!r}")
    stages = tuple(
        StageLayout(spec=axes[:i] + (None,) + axes[i:], fft_dims=(i,))
        for i in range(ndim)
    )
    redists = tuple(
        RedistHop((Redistribution(mesh_axis=axes[i], split_dim=i,
                                  concat_dim=i + 1),))
        for i in range(ndim - 1)
    )
    return Decomposition(name="pencil", mesh_axes=axes, stages=stages,
                         redists=redists)


def slab_nd(a: str, ndim: int) -> Decomposition:
    """Slab decomposition of ``ndim`` spatial dims over one mesh axis.

    Two stages: a local ``(ndim-1)``-dim transform on full slabs, one
    transpose, then the final-dim transform.  Scalability is bounded by
    ``N_last >= |a|`` (the paper's §II-A caveat); ``validate_grid``
    enforces it.
    """
    if ndim < 2:
        raise ValueError("slab decomposition needs >= 2 spatial dims")
    return Decomposition(
        name="slab",
        mesh_axes=(a,),
        stages=(
            StageLayout(spec=(None,) * (ndim - 1) + (a,),
                        fft_dims=tuple(range(ndim - 1))),
            StageLayout(spec=(a,) + (None,) * (ndim - 1),
                        fft_dims=(ndim - 1,)),
        ),
        redists=(RedistHop((Redistribution(mesh_axis=a, split_dim=0,
                                           concat_dim=ndim - 1),)),),
    )


def _balanced_runs(items: Sequence, n_runs: int) -> Tuple[Tuple, ...]:
    """Split ``items`` into ``n_runs`` contiguous runs, earlier runs larger."""
    n = len(items)
    base, extra = divmod(n, n_runs)
    runs, start = [], 0
    for i in range(n_runs):
        size = base + (1 if i < extra else 0)
        runs.append(tuple(items[start:start + size]))
        start += size
    return tuple(runs)


def _group_layout(dims: Tuple[int, ...],
                  axes: Tuple[str, ...]) -> Dict[int, Tuple[str, ...]]:
    """Distribute an ordered axis tuple over a group's dims.

    One axis per dim while they last; a group smaller than its axis count
    packs contiguous runs onto each dim (earlier dims take the extras),
    producing multi-axis sharding.
    """
    if not axes:
        return {d: () for d in dims}
    n_slots = min(len(dims), len(axes))
    runs = _balanced_runs(axes, n_slots)
    out = {d: () for d in dims}
    for d, run in zip(dims[:n_slots], runs):
        out[d] = run
    return out


def hybrid_nd(dim_groups: Sequence[Sequence[int]],
              mesh_axes: Sequence[str], *,
              axis_counts: Optional[Sequence[int]] = None) -> Decomposition:
    """Hybrid (pencil-over-k-axes) decomposition from a stage grouping.

    ``dim_groups`` partitions the spatial dims into contiguous, ordered
    groups; stage ``j`` locally transforms group ``j`` while every other
    group is sharded.  ``mesh_axes`` is the ordered axis pool;
    ``axis_counts[i]`` (optional) is how many of them initially shard group
    ``i+1`` (default: balanced, every boundary gets at least one — so
    ``len(mesh_axes) >= len(dim_groups) - 1`` is required).

    Construction: each axis starts on some group ``i >= 1`` and moves to
    group ``i-1`` at hop ``i-1``, exactly once — so hop ``j`` carries one
    ``all_to_all`` per axis initially assigned to group ``j+1``.  Within a
    hop, axes are peeled off a source dim minor-first (the only order for
    which sequential tiled ``all_to_all``s reproduce a clean block layout),
    and each receiving dim's axis tuple records its arrival order, keeping
    the declared stage specs faithful to the data movement.
    """
    groups = tuple(tuple(int(d) for d in g) for g in dim_groups)
    axes = tuple(mesh_axes)
    g = len(groups)
    if g < 2:
        raise ValueError("hybrid decomposition needs >= 2 stage groups")
    flat = [d for grp in groups for d in grp]
    ndim = len(flat)
    if flat != list(range(ndim)) or any(not grp for grp in groups):
        raise ValueError(
            f"dim_groups must be non-empty contiguous groups covering "
            f"0..{ndim - 1} in order, got {groups!r}")
    if len(set(axes)) != len(axes) or not axes:
        raise ValueError(f"mesh_axes must be distinct and non-empty: {axes!r}")
    if axis_counts is None:
        counts = tuple(len(r) for r in _balanced_runs(axes, g - 1))
    else:
        counts = tuple(int(c) for c in axis_counts)
    if len(counts) != g - 1 or any(c < 1 for c in counts) \
            or sum(counts) != len(axes):
        raise ValueError(
            f"axis_counts must be {g - 1} positive ints summing to "
            f"{len(axes)}, got {counts!r} (hybrid over {g} groups needs "
            f">= {g - 1} mesh axes)")

    # init_axes[i]: ordered axes initially sharding group i (i >= 1).
    init_axes: Dict[int, Tuple[str, ...]] = {0: ()}
    pos = 0
    for i, c in enumerate(counts, start=1):
        init_axes[i] = axes[pos:pos + c]
        pos += c

    # Stage-0 spec: every group i >= 1 carries its initial axes.
    spec: Dict[int, Tuple[str, ...]] = {}
    for i, grp in enumerate(groups):
        spec.update(_group_layout(grp, init_axes[i]))

    stages = [StageLayout(spec=tuple(spec[d] for d in range(ndim)),
                          fft_dims=groups[0])]
    redists = []
    for j in range(g - 1):
        src_grp, dst_grp = groups[j + 1], groups[j]
        moving = init_axes[j + 1]
        dest_of = {}
        for d, run in _group_layout(dst_grp, moving).items():
            for ax in run:
                dest_of[ax] = d
        src_of = {ax: d for d in src_grp for ax in spec[d]}
        # Peel axes off each source dim minor-axis-first: removal rank 0 is
        # the last (minor) axis of the dim's tuple.  Ties across source dims
        # break by the axis's position in the moving tuple.
        def _rank(ax):
            tup = spec[src_of[ax]]
            return (len(tup) - 1 - tup.index(ax), moving.index(ax))
        order = sorted(moving, key=_rank)
        moves = []
        for ax in order:
            s, t = src_of[ax], dest_of[ax]
            moves.append(Redistribution(mesh_axis=ax, split_dim=t,
                                        concat_dim=s))
            spec[s] = tuple(a for a in spec[s] if a != ax)
            spec[t] = spec[t] + (ax,)   # arrival order == tuple order
        redists.append(RedistHop(tuple(moves)))
        stages.append(StageLayout(spec=tuple(spec[d] for d in range(ndim)),
                                  fft_dims=src_grp))
    return Decomposition(name="hybrid", mesh_axes=axes, stages=tuple(stages),
                         redists=tuple(redists), dim_groups=groups)


def default_dim_groups(ndim: int,
                       n_axes: int) -> Tuple[Tuple[int, ...], ...]:
    """Default hybrid grouping: two stages, one hop, all axes in play.

    The front group takes the leading ``ceil(ndim/2)`` dims — for 3-D the
    "2+1" hybrid, for 4-D the two 2-dim slab stages with a single two-move
    transpose.  ``n_axes`` only matters for validation (>= 1).
    """
    if ndim < 2:
        raise ValueError("hybrid decomposition needs >= 2 spatial dims")
    if n_axes < 1:
        raise ValueError("hybrid decomposition needs >= 1 mesh axis")
    head = (ndim + 1) // 2
    return (tuple(range(head)), tuple(range(head, ndim)))


def describe_decomp(name: str, dim_groups=None) -> str:
    """Human-readable decomposition tag, e.g. "pencil" or "hybrid[2+1]".

    Single formatting point for ``Candidate.describe``,
    ``TunedPlan.describe`` and ``DistributedFFT.describe``.
    """
    if name == "hybrid" and dim_groups is not None:
        return name + "[" + "+".join(str(len(g)) for g in dim_groups) + "]"
    return name


def pencil(ay: str = "data", az: str = "model") -> Decomposition:
    """The paper's 3-D pencil (Alg. 1): see :func:`pencil_nd`."""
    return pencil_nd((ay, az), 3)


def slab(a: str = "data") -> Decomposition:
    """The paper's 3-D slab: see :func:`slab_nd`."""
    return slab_nd(a, 3)


def make_decomposition(kind: str, mesh_axes: Sequence[str], ndim: int = 3,
                       dim_groups: Optional[Sequence[Sequence[int]]] = None
                       ) -> Decomposition:
    if kind == "pencil":
        return pencil_nd(mesh_axes, ndim)
    if kind == "slab":
        if len(mesh_axes) != 1:
            raise ValueError("slab decomposition needs one mesh axis")
        return slab_nd(mesh_axes[0], ndim)
    if kind == "hybrid":
        groups = (tuple(tuple(g) for g in dim_groups) if dim_groups is not None
                  else default_dim_groups(ndim, len(mesh_axes)))
        return hybrid_nd(groups, mesh_axes)
    raise ValueError(f"unknown decomposition kind: {kind!r}")


def validate_grid(decomp: Decomposition, grid: Tuple[int, ...],
                  axis_sizes: dict) -> None:
    """Check every stage's local block has integral shape on this mesh.

    A dim sharded by an axis tuple must divide by the *product* of the axis
    sizes; since every sub-product of a tuple divides the full product, this
    also covers the intermediate layouts mid-hop (each move only ever adds
    or removes a suffix of the final tuple).
    """
    for stage in decomp.stages:
        for d, entry in enumerate(stage.spec):
            size = axis_product(entry, axis_sizes)
            if size > 1 and grid[d] % size != 0:
                raise ValueError(
                    f"{decomp.name}: grid dim {d} ({grid[d]}) not divisible "
                    f"by mesh axes {spec_axes(entry)!r} (size {size})"
                )


def local_shape(stage: StageLayout, grid: Tuple[int, ...],
                axis_sizes: dict) -> Tuple[int, ...]:
    """Per-device block shape of this stage's DArray."""
    return tuple(
        n // axis_product(entry, axis_sizes)
        for n, entry in zip(grid, stage.spec)
    )
