"""The distributed FFT pipeline (paper Alg. 1), stage per layout, per rank.

``build_pipeline`` assembles the forward or inverse transform for a
(grid, decomposition, transform kinds) triple on a :class:`~..compat.Mesh`:

    stage-1 local FFTs  ->  redistribution  ->  stage-2  ->  ...  -> stage-k

Every stage owns its own layout (``decomp.stages[i]``) and every
redistribution is an ``all_to_all`` hop (``core/redistribute.py``) that may
be chunk-pipelined for compute/communication overlap.  The overlap depth is
a per-hop ``chunk_schedule`` (one entry per ``RedistHop``): a uniform int
``n_chunks`` is the special case, and ``make_spec`` clamps infeasible
entries per hop and records the ask.  Where the JAX package ``shard_map``s
one function over the mesh, the port returns the per-rank function itself:
each rank calls it on its own block.

With the ``kernel`` backend a stage whose last C2C line transforms the dim
the next hop splits stores that line's output pre-split for the exchange
(the kernel's ``pack_parts`` epilogue): the stage hands a
:class:`~.redistribute.PackedBlock` to the hop, which sends it as it is.

R2C transforms pad the frequency dim up to the LCM of the mesh-axis sizes
that shard it downstream, so every stage keeps integral local shapes; the
inverse pipeline trims the pad before the final irfft.  Unnormalized R2R
inverses (``dct3``/``dst3``) are scaled by ``1/(2N)``.

Split at its hops, a pipeline is a chain of **stage segments**
(``build_segment``/``compile_segment``, boundary shapes from
``segment_structs``): the unit of work of the plan-stream executor
(``core/executor.py``).
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Callable, List, Optional, Tuple

import torch

from . import transforms
from .decomp import (Decomposition, StageLayout, _as_hop, axis_product,
                     local_shape)
from .plan import GLOBAL_PLAN_CACHE, plan_key
from .redistribute import (PackedBlock, free_chunk_dim,
                           largest_divisor_at_most, redistribute)

INVERSE_KIND = {"fft": "ifft", "rfft": "irfft", "dct2": "dct3", "dst2": "dst3"}
# Kinds whose stage line may fuse the pre-hop pack (kernel backend only).
C2C_FUSED_KINDS = ("fft", "ifft")
# Unnormalized R2R pairs satisfy inv(fwd(x)) = 2N x; complex pairs are
# self-normalizing through torch.fft's conventions.
R2R_INV_SCALE = ("dct3", "dst3")


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    grid: Tuple[int, ...]               # logical (pre-padding) grid
    eff_grid: Tuple[int, ...]           # grid after R2C frequency padding
    decomp: Decomposition
    kinds: Tuple[str, ...]              # one transform kind per spatial dim
    backend: str
    # One chunk count per RedistHop, in *execution* order (aligned with
    # ``stage_order()``'s redists: reversed relative to ``decomp.redists``
    # for inverse specs).  A uniform ``n_chunks=k`` is ``(k,) * n_hops``.
    chunk_schedule: Tuple[int, ...]
    inverse: bool
    batch_spec: Tuple[Optional[str], ...]  # shardings of leading batch dims
    # Pre-clamp ask per hop, execution order (() = nothing was requested).
    chunk_schedule_requested: Tuple[int, ...] = ()

    @property
    def spatial_offset(self) -> int:
        return len(self.batch_spec)

    @property
    def n_chunks(self) -> int:
        """Scalar view of the schedule: the deepest hop."""
        return max(self.chunk_schedule, default=1)

    @property
    def n_chunks_requested(self) -> int:
        """Scalar view of the pre-clamp ask (0 = none)."""
        return max(self.chunk_schedule_requested, default=0)

    @property
    def uniform_chunks(self) -> bool:
        """True when both the ask and the schedule are hop-uniform."""
        return (len(set(self.chunk_schedule)) <= 1
                and len(set(self.chunk_schedule_requested)) <= 1)

    @property
    def chunk_clamped(self) -> bool:
        """True when some requested chunk count was clamped at spec time."""
        return (self.chunk_schedule_requested != ()
                and self.chunk_schedule_requested != self.chunk_schedule)

    @property
    def hop_clamps(self) -> Tuple[Tuple[int, int, int], ...]:
        """Per clamped hop: (hop index, requested, effective), exec order."""
        if not self.chunk_schedule_requested:
            return ()
        return tuple((i, ask, got) for i, (ask, got)
                     in enumerate(zip(self.chunk_schedule_requested,
                                      self.chunk_schedule))
                     if ask != got)

    def stage_order(self):
        stages = list(self.decomp.stages)
        redists = list(self.decomp.redists)
        if not self.inverse:
            return stages, redists
        # Reversing a hop reverses its moves LIFO with split/concat swapped,
        # so every intermediate layout is undone in the opposite order.
        return stages[::-1], [hop.inverse() for hop in redists[::-1]]

    def in_spec(self) -> tuple:
        stages, _ = self.stage_order()
        return tuple(self.batch_spec) + stages[0].spec

    def out_spec(self) -> tuple:
        stages, _ = self.stage_order()
        return tuple(self.batch_spec) + stages[-1].spec


def _freq_pad_target(decomp: Decomposition, axis_sizes: dict,
                     nfreq: int) -> int:
    """Pad the R2C frequency dim (dim 0) so all later shardings divide it.

    A stage may shard dim 0 over several mesh axes at once, so the
    per-stage divisor is the product of the sharding axes' sizes.
    """
    divisor = 1
    for stage in decomp.stages[1:]:
        size = axis_product(stage.spec[0], axis_sizes)
        if size > 1:
            divisor = math.lcm(divisor, size)
    return ((nfreq + divisor - 1) // divisor) * divisor


def effective_grid(grid: Tuple[int, ...], decomp: Decomposition,
                   axis_sizes: dict,
                   kinds: Tuple[str, ...]) -> Tuple[int, ...]:
    """The grid the pipeline actually moves: R2C pads the frequency dim.

    For an ``rfft`` first kind, dim 0 becomes ``n//2 + 1`` rounded up to the
    LCM of every mesh-axis size that shards it downstream.
    """
    eff = list(grid)
    if kinds[0] == "rfft":
        eff[0] = _freq_pad_target(decomp, axis_sizes, grid[0] // 2 + 1)
    return tuple(eff)


def chunk_sites(spec: PipelineSpec, axis_sizes: dict
                ) -> List[Tuple[Optional[int], Optional[int]]]:
    """Per executed hop: the (absolute chunk dim, its local size) chunking
    would use.

    ``(None, None)`` means the hop has no legal chunk dim (bulk only);
    ``(d, None)`` means the chunk dim is a leading batch dim whose extent
    the spec does not know.  Shared by the spec-time clamp and the tuner's
    feasibility filter, so both agree with what ``redistribute`` does.
    """
    offset = spec.spatial_offset
    ndim_total = offset + len(spec.eff_grid)
    stages, redists = spec.stage_order()
    sites: List[Tuple[Optional[int], Optional[int]]] = []
    for i, hop in enumerate(redists):
        avoid = tuple(d + offset for d in stages[i + 1].fft_dims)
        d = free_chunk_dim(hop, ndim_total, offset, avoid_dims=avoid)
        if d is None:
            sites.append((None, None))
        elif d < offset:
            sites.append((d, None))
        else:
            block = local_shape(stages[i], spec.eff_grid, axis_sizes)
            sites.append((d, block[d - offset]))
    return sites


def make_spec(mesh, grid: Tuple[int, ...], decomp: Decomposition,
              kinds: Tuple[str, ...], *, backend: str = "cufft",
              n_chunks=1, inverse: bool = False,
              batch_spec: Tuple[Optional[str], ...] = ()) -> PipelineSpec:
    """Build a :class:`PipelineSpec`; ``kinds`` are the forward kinds.

    ``n_chunks`` is an int — a uniform schedule, clamped to the largest
    count dividing every hop's chunk-dim size — or a per-hop sequence in
    **forward hop order** (``decomp.redists`` order, whatever
    ``inverse``), clamped hop by hop with the helpers ``redistribute``
    uses.  Every clamp warns and is recorded
    (``spec.chunk_schedule_requested`` keeps the ask).
    """
    kinds = tuple(kinds)
    bad = [k for k in kinds if k not in transforms.ALL_KINDS]
    if bad:
        raise ValueError(f"unknown transform kinds {bad}; supported: "
                         f"{transforms.ALL_KINDS}")
    axis_sizes = mesh.axis_sizes
    eff = effective_grid(tuple(grid), decomp, axis_sizes, kinds)
    n_hops = len(decomp.redists)
    if isinstance(n_chunks, int):
        uniform = True
        requested = (max(int(n_chunks), 1),) * n_hops
    else:
        uniform = False
        sched = tuple(int(c) for c in n_chunks)
        if len(sched) != n_hops:
            raise ValueError(
                f"chunk schedule {sched} has {len(sched)} entries but "
                f"{decomp.name} over grid {tuple(grid)} has {n_hops} "
                f"redistribution hops")
        if any(c < 1 for c in sched):
            raise ValueError(f"chunk schedule entries must be >= 1: {sched}")
        # Given in forward hop order; an inverse pipeline executes the hops
        # LIFO, so entry i pairs with executed hop n_hops-1-i.
        requested = sched if not inverse else sched[::-1]
    spec = PipelineSpec(grid=tuple(grid), eff_grid=eff, decomp=decomp,
                        kinds=kinds, backend=backend,
                        chunk_schedule=requested, inverse=inverse,
                        batch_spec=tuple(batch_spec),
                        chunk_schedule_requested=requested)
    if all(c <= 1 for c in requested):
        return spec
    sites = chunk_sites(spec, axis_sizes)
    if uniform:
        ask = requested[0]
        sizes = [s for _, s in sites if s is not None]
        if sites and all(d is None for d, _ in sites):
            # No hop can legally chunk (e.g. an inverse slab: the hop plus
            # the next stage's fft_dims cover every dim).
            warnings.warn(
                f"no redistribution of grid {tuple(grid)} has a legal "
                f"chunk dim ({'inverse' if inverse else 'forward'} "
                f"{decomp.name}); running bulk instead of "
                f"n_chunks={ask}", RuntimeWarning, stacklevel=2)
            clamped = (1,) * n_hops
        else:
            # A uniform ask stays uniform: the largest count <= n_chunks
            # dividing every hop's chunk-dim size.
            eff_chunks = (largest_divisor_at_most(math.gcd(*sizes), ask)
                          if sizes else ask)
            if eff_chunks != ask:
                warnings.warn(
                    f"n_chunks={ask} does not evenly chunk every "
                    f"redistribution of grid {tuple(grid)} on this mesh; "
                    f"clamped to {eff_chunks}", RuntimeWarning, stacklevel=2)
            clamped = (eff_chunks,) * n_hops
    else:
        # Per hop: a hop with no legal chunk dim runs bulk; an unknown
        # batch-dim extent is left to redistribute's run-time clamp.
        per_hop = []
        for (d, size), ask in zip(sites, requested):
            if ask <= 1:
                per_hop.append(ask)
            elif d is None:
                per_hop.append(1)
            elif size is None:
                per_hop.append(ask)
            else:
                per_hop.append(largest_divisor_at_most(size, ask))
        clamped = tuple(per_hop)
        if clamped != requested:
            show = (lambda s: tuple(s) if not inverse else tuple(s[::-1]))
            warnings.warn(
                f"chunk schedule {show(requested)} is not feasible on every "
                f"redistribution of grid {tuple(grid)} on this mesh; "
                f"clamped per hop to {show(clamped)}",
                RuntimeWarning, stacklevel=2)
    return dataclasses.replace(spec, chunk_schedule=clamped)


def _pack_fusion_site(spec: PipelineSpec, stage: StageLayout,
                      next_hop) -> Tuple[Optional[int], Optional[str]]:
    """Which of this stage's dims (if any) stores its output pre-split for
    the following hop: the stage's *last-executed* C2C line, when it
    transforms the very dim the hop's first move splits.  Returns
    ``(spatial_dim, mesh_axis)`` or ``(None, None)``.
    """
    if spec.backend != "kernel" or next_hop is None:
        return None, None
    lines = list(_stage_kinds(spec, stage))
    if not lines:
        return None, None
    d_last, kind = lines[-1]
    if kind not in C2C_FUSED_KINDS:
        return None, None
    mv = _as_hop(next_hop).moves[0]
    if mv.split_dim != d_last:
        return None, None
    return d_last, mv.mesh_axis


def _stage_kinds(spec: PipelineSpec, stage: StageLayout):
    """``(spatial dim, kind)`` of one stage's lines, in execution order."""
    dims = stage.fft_dims if not spec.inverse else stage.fft_dims[::-1]
    for d in dims:
        kind = spec.kinds[d]
        yield d, INVERSE_KIND[kind] if spec.inverse else kind


def _stage_transform(spec: PipelineSpec, stage: StageLayout,
                     next_hop=None, axis_sizes=None) -> Callable:
    """Local transform for one stage (may cover 2 dims for slabs).

    ``next_hop``/``axis_sizes`` feed the pack epilogue: when the stage's
    last C2C line transforms the dim the following hop splits, the kernel
    stores it as that hop's send buffer and the stage returns a
    :class:`PackedBlock`.
    """
    off = spec.spatial_offset
    fuse_dim, fuse_axis = (None, None) if axis_sizes is None else \
        _pack_fusion_site(spec, stage, next_hop)

    def run(x: torch.Tensor):
        for d, kind in _stage_kinds(spec, stage):
            if d == fuse_dim:
                parts = axis_sizes[fuse_axis]
                if parts > 1 and x.shape[d + off] % parts == 0:
                    from ..kernels import ops
                    send = ops.packed_fft1d(x, d + off, parts,
                                            inverse=kind == "ifft")
                    return PackedBlock(send=send, split_dim=d + off)
            if kind == "irfft":
                # trim the frequency pad, then invert to the real length
                nfreq = spec.grid[0] // 2 + 1
                x = transforms.apply_1d(x.narrow(d + off, 0, nfreq), d + off,
                                        "irfft", backend=spec.backend,
                                        irfft_n=spec.grid[0])
                continue
            x = transforms.apply_1d(x, d + off, kind, backend=spec.backend)
            if kind == "rfft":
                pad = spec.eff_grid[0] - (spec.grid[0] // 2 + 1)
                if pad:
                    shape = list(x.shape)
                    shape[d + off] = pad
                    x = torch.cat([x, x.new_zeros(shape)], dim=d + off)
            if kind in R2R_INV_SCALE:
                x = x / (2.0 * spec.grid[d])
        return x

    return run


def _local_pipeline(spec: PipelineSpec, mesh) -> Callable:
    """The per-rank pipeline: stage transforms joined by hops."""
    stages, redists = spec.stage_order()
    off = spec.spatial_offset
    axis_sizes = mesh.axis_sizes
    first = _stage_transform(spec, stages[0],
                             next_hop=redists[0] if redists else None,
                             axis_sizes=axis_sizes)
    rest = [
        _stage_transform(spec, stages[i + 1],
                         next_hop=redists[i + 1] if i + 1 < len(redists)
                         else None, axis_sizes=axis_sizes)
        for i in range(len(redists))]

    # The chunk dim must dodge the next stage's transform dims, or the
    # per-chunk transform would run over a split dim.
    avoid = [tuple(d + off for d in stages[i + 1].fft_dims)
             for i in range(len(redists))]

    def run(x: torch.Tensor) -> torch.Tensor:
        x = first(x)
        for i, hop in enumerate(redists):
            x = redistribute(x, hop, mesh=mesh,
                             n_chunks=spec.chunk_schedule[i],
                             then=rest[i], spatial_offset=off,
                             avoid_dims=avoid[i], hop_index=i)
        return x.logical() if isinstance(x, PackedBlock) else x

    return run


def build_pipeline(mesh, spec: PipelineSpec) -> Callable:
    """The per-rank callable of ``spec`` on ``mesh``: takes this rank's
    stage-0 block and returns its block in the last stage's layout."""
    return _local_pipeline(spec, mesh)


@dataclasses.dataclass(frozen=True)
class TensorStruct:
    """Shape/dtype/layout of a pipeline operand (the port's counterpart of
    a sharded ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]          # global shape
    dtype: torch.dtype
    spec: tuple                     # one spec entry per dim
    local_shape: Tuple[int, ...]    # this rank's block


def _struct(mesh, shape, dtype, spec) -> TensorStruct:
    local = tuple(n // axis_product(e, mesh.axis_sizes)
                  for n, e in zip(shape, spec))
    return TensorStruct(tuple(shape), dtype, tuple(spec), local)


def input_struct(mesh, spec: PipelineSpec,
                 batch_shape: Tuple[int, ...] = (),
                 dtype=torch.complex64) -> TensorStruct:
    """Shape/dtype/layout of the pipeline's input.  A forward R2C pipeline
    takes real input of the precision of the dtype asked for."""
    in_grid = spec.eff_grid if spec.inverse else spec.grid
    if not spec.inverse and spec.kinds[0] == "rfft":
        dtype = transforms.real_dtype(dtype)
    return _struct(mesh, tuple(batch_shape) + tuple(in_grid), dtype,
                   spec.in_spec())


def _stage_step(spec: PipelineSpec, stage: StageLayout, shape: list,
                dtype: torch.dtype) -> torch.dtype:
    """What one stage does to the global ``shape`` (updated in place) and
    to ``dtype``, kind by kind: C2C and rfft lines give the complex dtype
    of its precision, rfft pads its dim to ``eff_grid``, irfft trims it to
    ``grid`` and gives the real dtype, and R2R lines keep what they get
    (real stays real; complex is transformed plane by plane)."""
    off = spec.spatial_offset
    for d, kind in _stage_kinds(spec, stage):
        if kind in transforms.C2C_KINDS or kind == "rfft":
            dtype = transforms.complex_dtype(dtype)
        elif kind == "irfft":
            dtype = transforms.real_dtype(dtype)
        if kind == "rfft":
            shape[d + off] = spec.eff_grid[d]
        elif kind == "irfft":
            shape[d + off] = spec.grid[d]
    return dtype


def _output_dtype(spec: PipelineSpec, dtype: torch.dtype) -> torch.dtype:
    """The dtype the stages turn ``dtype`` into (:func:`_stage_step`)."""
    stages, _ = spec.stage_order()
    shape = [0] * (spec.spatial_offset + len(spec.grid))
    for stage in stages:
        dtype = _stage_step(spec, stage, shape, dtype)
    return dtype


def output_struct(mesh, spec: PipelineSpec,
                  batch_shape: Tuple[int, ...] = (),
                  dtype=torch.complex64) -> TensorStruct:
    """Shape/dtype/layout of the pipeline's output: an rfft forward is
    complex on ``eff_grid``, an irfft inverse real on ``grid``, an all-R2R
    plan real for real input."""
    out_grid = spec.grid if spec.inverse else spec.eff_grid
    in_dtype = input_struct(mesh, spec, batch_shape, dtype).dtype
    return _struct(mesh, tuple(batch_shape) + tuple(out_grid),
                   _output_dtype(spec, in_dtype), spec.out_spec())


def stage_local_shapes(spec: PipelineSpec, mesh) -> Tuple[Tuple[int, ...], ...]:
    """Each stage's local block (spatial dims), in execution order."""
    stages, _ = spec.stage_order()
    return tuple(local_shape(s, spec.eff_grid, mesh.axis_sizes)
                 for s in stages)


# ---------------------------------------------------------------------------
# Stage segments: the pipeline split at its redistribution hops.
# ---------------------------------------------------------------------------
#
# Segment 0 applies the stage-0 local transform; segment j (1-based) applies
# hop j-1 — at that hop's own chunk_schedule entry — with stage j's
# transform run per chunk, exactly like the loop body of _local_pipeline.
# The one intended difference is the kernel's pack epilogue: a stage's
# epilogue packs for the *next* hop, which lives in the next segment, so
# segments build every stage with next_hop=None and hand a plain tensor
# across each boundary.  The packed and the plain store hold the same
# values, so chained segments match the fused pipeline bit for bit.


def n_segments(spec: PipelineSpec) -> int:
    """Number of stage segments (== number of stages)."""
    return len(spec.decomp.stages)


def segment_in_spec(spec: PipelineSpec, index: int) -> tuple:
    """Layout of segment ``index``'s input: stage ``index-1``'s (segment 0
    takes the pipeline input layout).  ``segment_out_spec(j) ==
    segment_in_spec(j+1)`` by construction."""
    stages, _ = spec.stage_order()
    return tuple(spec.batch_spec) + stages[max(index - 1, 0)].spec


def segment_out_spec(spec: PipelineSpec, index: int) -> tuple:
    """Layout of segment ``index``'s output (stage ``index``'s)."""
    stages, _ = spec.stage_order()
    return tuple(spec.batch_spec) + stages[index].spec


def build_segment(mesh, spec: PipelineSpec, index: int) -> Callable:
    """The per-rank callable of segment ``index``: takes this rank's block
    in ``segment_in_spec`` and returns it in ``segment_out_spec``."""
    stages, redists = spec.stage_order()
    if not 0 <= index < len(stages):
        raise ValueError(f"segment index {index} out of range for "
                         f"{len(stages)} stages")
    stage_fn = _stage_transform(spec, stages[index], next_hop=None,
                                axis_sizes=mesh.axis_sizes)
    if index == 0:
        return stage_fn
    off = spec.spatial_offset
    hop = redists[index - 1]
    avoid = tuple(d + off for d in stages[index].fft_dims)

    def run(x: torch.Tensor) -> torch.Tensor:
        return redistribute(x, hop, mesh=mesh,
                            n_chunks=spec.chunk_schedule[index - 1],
                            then=stage_fn, spatial_offset=off,
                            avoid_dims=avoid, hop_index=index - 1)

    return run


def segment_structs(mesh, spec: PipelineSpec,
                    batch_shape: Tuple[int, ...] = (),
                    dtype=torch.complex64) -> List[TensorStruct]:
    """Shape/dtype/layout at every segment boundary.

    ``n_segments + 1`` entries: entry ``j`` is segment ``j``'s input and
    entry ``j+1`` its output (entry 0 == ``input_struct``, the last entry
    == ``output_struct``).  Derived from the spec — the R2C pad and the
    irfft trim at the stage that runs them, each kind's dtype rule — and
    never by running the pipeline: the kernel backend reads raw pointers.
    """
    first = input_struct(mesh, spec, batch_shape, dtype)
    structs = [first]
    shape, dt = list(first.shape), first.dtype
    stages, _ = spec.stage_order()
    for j, stage in enumerate(stages):
        dt = _stage_step(spec, stage, shape, dt)
        structs.append(_struct(mesh, tuple(shape), dt,
                               segment_out_spec(spec, j)))
    return structs


def _donating(fn: Callable) -> Callable:
    """``fn`` that gives up its input once it has run: the input is
    emptied in place (``set_()``), so its memory returns to the allocator
    as soon as nothing else holds it.  On CUDA the input is first recorded
    on the current stream, so the allocator reuses the memory only after
    the work queued there has read it."""

    def run(x: torch.Tensor) -> torch.Tensor:
        out = fn(x)
        release(x)
        return out

    return run


# Set on a tensor that :func:`release` emptied, so that :func:`released`
# tells a donated operand from a tensor that was empty to begin with.
_RELEASED = "_repro_released"


def release(x: torch.Tensor) -> None:
    """Empty ``x`` in place (see :func:`_donating`).  ``set_()``, not a
    storage ``resize_(0)``: a tensor whose storage was resized away keeps
    its sizes, and reading it later crashes the process instead of
    raising."""
    if x.is_cuda and x.numel():
        x.record_stream(torch.cuda.current_stream(x.device))
    x.set_()
    setattr(x, _RELEASED, True)


def released(x: Any) -> bool:
    """True iff ``x`` is a tensor that :func:`release` emptied and nothing
    has refilled since (the counterpart of ``jax.Array.is_deleted``)."""
    return (isinstance(x, torch.Tensor) and x.numel() == 0
            and getattr(x, _RELEASED, False))


def pipeline_key(spec: PipelineSpec, mesh, dtype, batch_shape=(),
                 extra: tuple = ()) -> tuple:
    """The ``GLOBAL_PLAN_CACHE`` key of a callable built from ``spec`` on
    ``mesh`` for plan-input ``dtype``: the fused pipeline's with no
    ``extra``, a segment's with its ``(donate, "segment", index)``.  The
    callable closes over the mesh's process groups and device, so the
    mesh object (compared by identity) is part of the key."""
    return plan_key(kind=spec.kinds, grid=spec.grid,
                    dtype=str(dtype).removeprefix("torch."),
                    decomp=(spec.decomp.name,) + tuple(spec.decomp.mesh_axes)
                    + (spec.decomp.dim_groups,),
                    mesh_shape=mesh.shape, mesh_axes=mesh.axis_names,
                    backend=spec.backend, n_chunks=spec.chunk_schedule,
                    inverse=spec.inverse,
                    extra=(tuple(batch_shape), mesh) + tuple(extra))


def compile_segment(mesh, spec: PipelineSpec, index: int,
                    batch_shape: Tuple[int, ...] = (),
                    dtype=torch.complex64, *,
                    donate: bool = False) -> Callable:
    """Build one stage segment's callable, cached in the LRU plan cache.

    ``dtype`` is the **plan input** dtype (the boundary dtypes follow from
    it).  ``donate=True`` builds a variant that gives up its input after
    the call (:func:`release`): the executor builds interior segments
    donating, so an entry holds at most two boundary buffers, and segment
    0 donating only when the caller donated the operand.  The key carries
    ``("segment", index)``, so segments never collide with the fused
    pipeline's entries.
    """
    key = pipeline_key(spec, mesh, dtype, batch_shape,
                       (bool(donate), "segment", int(index)))

    def builder() -> Callable:
        fn = build_segment(mesh, spec, index)
        return _donating(fn) if donate else fn

    return GLOBAL_PLAN_CACHE.get_or_create(key, builder).executable
