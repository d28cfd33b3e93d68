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

R2C transforms pad the frequency dim up to the LCM of the mesh-axis sizes
that shard it downstream, so every stage keeps integral local shapes; the
inverse pipeline trims the pad before the final irfft.  Unnormalized R2R
inverses (``dct3``/``dst3``) are scaled by ``1/(2N)``.

Only bulk hops are ported; ``n_chunks > 1`` raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from . import transforms
from .decomp import (Decomposition, StageLayout, _as_hop, axis_product,
                     local_shape)
from .redistribute import PackedBlock, redistribute

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


def make_spec(mesh, grid: Tuple[int, ...], decomp: Decomposition,
              kinds: Tuple[str, ...], *, backend: str = "cufft",
              n_chunks=1, inverse: bool = False,
              batch_spec: Tuple[Optional[str], ...] = ()) -> PipelineSpec:
    """Build a bulk :class:`PipelineSpec`; ``kinds`` are the forward kinds.

    ``n_chunks`` must be 1 (or a per-hop sequence of ones): the chunked
    overlap is not ported yet and raises ``NotImplementedError``.
    """
    kinds = tuple(kinds)
    bad = [k for k in kinds if k not in transforms.ALL_KINDS]
    if bad:
        raise ValueError(f"unknown transform kinds {bad}; supported: "
                         f"{transforms.ALL_KINDS}")
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
    """Shape/dtype/layout of the pipeline's input.  A forward R2C pipeline
    takes real input of the precision of the dtype asked for."""
    in_grid = spec.eff_grid if spec.inverse else spec.grid
    if not spec.inverse and spec.kinds[0] == "rfft":
        dtype = transforms.real_dtype(dtype)
    return _struct(mesh, tuple(batch_shape) + tuple(in_grid), dtype,
                   spec.in_spec())


def _output_dtype(spec: PipelineSpec, dtype: torch.dtype) -> torch.dtype:
    """The dtype the stages turn ``dtype`` into, kind by kind in execution
    order: C2C and rfft lines give the complex dtype of its precision,
    irfft the real one, and R2R lines keep what they get (real stays real;
    complex is transformed plane by plane)."""
    stages, _ = spec.stage_order()
    for stage in stages:
        dims = stage.fft_dims if not spec.inverse else stage.fft_dims[::-1]
        for d in dims:
            kind = spec.kinds[d]
            if spec.inverse:
                kind = INVERSE_KIND[kind]
            if kind in transforms.C2C_KINDS or kind == "rfft":
                dtype = transforms.complex_dtype(dtype)
            elif kind == "irfft":
                dtype = transforms.real_dtype(dtype)
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
