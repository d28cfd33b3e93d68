"""The distributed FFT pipeline (paper Alg. 1), stage per layout, per rank.

``build_pipeline`` assembles the forward or inverse transform for a
(grid, decomposition, transform kinds) triple on a :class:`~..compat.Mesh`:

    stage-1 local FFTs  ->  redistribution  ->  stage-2  ->  ...  -> stage-k

Every stage owns its own layout (``decomp.stages[i]``) and every
redistribution is a bulk ``all_to_all`` hop (``core/redistribute.py``).
Where the JAX package ``shard_map``s one function over the mesh, the port
returns the per-rank function itself: each rank calls it on its own block.

With the ``kernel`` backend a stage whose last C2C line transforms the dim
the next hop splits stores that line's output pre-split for the exchange
(the kernel's ``pack_parts`` epilogue): the stage hands a
:class:`~.redistribute.PackedBlock` to the hop, which sends it as it is.

Only C2C kinds and bulk hops are ported; R2C/R2R kinds and ``n_chunks > 1``
raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from . import transforms
from .decomp import (Decomposition, StageLayout, _as_hop, axis_product,
                     local_shape)
from .redistribute import PackedBlock, redistribute

INVERSE_KIND = {"fft": "ifft", "rfft": "irfft", "dct2": "dct3", "dst2": "dst3"}
# Kinds whose stage line may fuse the pre-hop pack (kernel backend only).
C2C_FUSED_KINDS = ("fft", "ifft")


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    grid: Tuple[int, ...]               # logical (pre-padding) grid
    eff_grid: Tuple[int, ...]           # grid after R2C frequency padding
    decomp: Decomposition
    kinds: Tuple[str, ...]              # one transform kind per spatial dim
    backend: str
    # One chunk count per RedistHop, in execution order (all 1: bulk).
    chunk_schedule: Tuple[int, ...]
    inverse: bool
    batch_spec: Tuple[Optional[str], ...]  # shardings of leading batch dims

    @property
    def spatial_offset(self) -> int:
        return len(self.batch_spec)

    @property
    def n_chunks(self) -> int:
        return max(self.chunk_schedule, default=1)

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


def effective_grid(grid: Tuple[int, ...], decomp: Decomposition,
                   axis_sizes: dict,
                   kinds: Tuple[str, ...]) -> Tuple[int, ...]:
    """The grid the pipeline actually moves.  C2C grids move unchanged;
    the R2C frequency padding of the JAX package is not ported yet."""
    if kinds[0] == "rfft":
        raise NotImplementedError("R2C frequency padding is not ported yet")
    return tuple(grid)


def make_spec(mesh, grid: Tuple[int, ...], decomp: Decomposition,
              kinds: Tuple[str, ...], *, backend: str = "cufft",
              n_chunks=1, inverse: bool = False,
              batch_spec: Tuple[Optional[str], ...] = ()) -> PipelineSpec:
    """Build a bulk :class:`PipelineSpec` for C2C kinds.

    ``n_chunks`` must be 1 (or a per-hop sequence of ones): the chunked
    overlap is not ported yet and raises ``NotImplementedError``, as do
    R2C/R2R kinds.
    """
    kinds = tuple(kinds)
    bad = [k for k in kinds if k not in transforms.C2C_KINDS]
    if bad:
        raise NotImplementedError(
            f"transform kinds {bad} are not ported yet; the port's pipeline "
            f"runs C2C kinds {transforms.C2C_KINDS}")
    n_hops = len(decomp.redists)
    sched = ((int(n_chunks),) * n_hops if isinstance(n_chunks, int)
             else tuple(int(c) for c in n_chunks))
    if len(sched) != n_hops:
        raise ValueError(
            f"chunk schedule {sched} has {len(sched)} entries but "
            f"{decomp.name} over grid {tuple(grid)} has {n_hops} "
            f"redistribution hops")
    if any(c != 1 for c in sched):
        raise NotImplementedError(
            f"chunked hops (n_chunks={n_chunks}) are not ported yet; the "
            f"port runs bulk hops (n_chunks=1)")
    eff = effective_grid(tuple(grid), decomp, mesh.axis_sizes, kinds)
    return PipelineSpec(grid=tuple(grid), eff_grid=eff, decomp=decomp,
                        kinds=kinds, backend=backend, chunk_schedule=sched,
                        inverse=inverse, batch_spec=tuple(batch_spec))


def _pack_fusion_site(spec: PipelineSpec, stage: StageLayout,
                      next_hop) -> Tuple[Optional[int], Optional[str]]:
    """Which of this stage's dims (if any) stores its output pre-split for
    the following hop: the stage's *last-executed* C2C line, when it
    transforms the very dim the hop's first move splits.  Returns
    ``(spatial_dim, mesh_axis)`` or ``(None, None)``.
    """
    if spec.backend != "kernel" or next_hop is None:
        return None, None
    dims = stage.fft_dims if not spec.inverse else stage.fft_dims[::-1]
    if not dims:
        return None, None
    d_last = dims[-1]
    kind = spec.kinds[d_last]
    if spec.inverse:
        kind = INVERSE_KIND[kind]
    if kind not in C2C_FUSED_KINDS:
        return None, None
    mv = _as_hop(next_hop).moves[0]
    if mv.split_dim != d_last:
        return None, None
    return d_last, mv.mesh_axis


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
        dims = stage.fft_dims if not spec.inverse else stage.fft_dims[::-1]
        for d in dims:
            kind = spec.kinds[d]
            if spec.inverse:
                kind = INVERSE_KIND[kind]
            if d == fuse_dim:
                parts = axis_sizes[fuse_axis]
                if parts > 1 and x.shape[d + off] % parts == 0:
                    from ..kernels import ops
                    send = ops.packed_fft1d(x, d + off, parts,
                                            inverse=kind == "ifft")
                    return PackedBlock(send=send, split_dim=d + off)
            x = transforms.apply_1d(x, d + off, kind, backend=spec.backend)
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

    def run(x: torch.Tensor) -> torch.Tensor:
        x = first(x)
        for i, hop in enumerate(redists):
            x = redistribute(x, hop, mesh=mesh,
                             n_chunks=spec.chunk_schedule[i],
                             then=rest[i], spatial_offset=off, hop_index=i)
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
    """Shape/dtype/layout of the pipeline's input."""
    in_grid = spec.eff_grid if spec.inverse else spec.grid
    return _struct(mesh, tuple(batch_shape) + tuple(in_grid), dtype,
                   spec.in_spec())


def output_struct(mesh, spec: PipelineSpec,
                  batch_shape: Tuple[int, ...] = (),
                  dtype=torch.complex64) -> TensorStruct:
    """Shape/dtype/layout of the pipeline's output.  C2C stages keep the
    grid and return the complex dtype of the input's precision."""
    out_grid = spec.grid if spec.inverse else spec.eff_grid
    return _struct(mesh, tuple(batch_shape) + tuple(out_grid),
                   transforms.complex_dtype(dtype), spec.out_spec())


def stage_local_shapes(spec: PipelineSpec, mesh) -> Tuple[Tuple[int, ...], ...]:
    """Each stage's local block (spatial dims), in execution order."""
    stages, _ = spec.stage_order()
    return tuple(local_shape(s, spec.eff_grid, mesh.axis_sizes)
                 for s in stages)
