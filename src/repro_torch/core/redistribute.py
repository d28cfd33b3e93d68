"""Inter-stage redistribution (global transposes) on each rank.

A hop is one or more :class:`~.decomp.Redistribution` moves.  The JAX
package runs each move as ``lax.all_to_all(split_axis, concat_axis,
tiled=True)`` inside ``shard_map``; here every rank runs it itself:

1. **send buffer** — the split dim is cut into ``p`` blocks (``p`` = the
   move's mesh-axis size) and the block index moved to the front, with the
   split dim's remainder last: ``(p, *others, n/p)``, contiguous.  Block
   ``i`` goes to the rank at coordinate ``i`` on the axis.
2. **exchange** — ``all_to_all_single`` on the axis's process subgroup.
3. **unsplit** — the ``p`` received blocks are laid side by side along the
   concat dim in source order, and the split dim goes back to its place.

A size-1 axis is the identity, as in XLA.  When the kernel backend's
``pack_parts`` epilogue ran, the stage already hands over a
:class:`PackedBlock` whose buffer *is* the send buffer of step 1, so the
exchange ships the kernel's output without a copy.

Two paths, numerically identical:

* ``bulk`` — the hop's moves run once over the whole block, then the next
  stage's transform (``then``).
* ``chunked`` — the block is split into ``n_chunks`` along a dim that no
  move of the hop touches and the next stage does not transform
  (:func:`free_chunk_dim`); each chunk gets its own exchange and its own
  ``then``, and the outputs are joined along the chunk dim.  XLA overlaps
  such independent chains by itself; here the overlap is explicit: chunk
  k+1's first exchange is issued (``all_to_all_single(async_op=True)``)
  before ``then`` runs on chunk k, and its ``work.wait()`` comes just
  before chunk k+1's data is used.  On NCCL ``wait()`` orders the
  collective's stream before the current stream; every chunk's send and
  receive buffers stay referenced until its work is waited on.

A hop with no legal chunk dim runs bulk with a ``RuntimeWarning``, and a
count that does not divide the chunk dim's size is clamped to the largest
divisor that does (``largest_divisor_at_most``), with the JAX package's
warning texts.  When ``then`` returns :class:`PackedBlock` chunks (the
pack epilogue ran per chunk), their send buffers are joined along the
chunk dim's place among ``others`` into one :class:`PackedBlock`.

A chunk cut along the outermost dim of a contiguous block is itself
dense, and the kernel's strided entry reads it in place; a chunk cut along
an inner dim is not, and ``kernels/ops._apply`` copies its lines
(``ops.copies["lines"]``).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from .decomp import _as_hop


def largest_divisor_at_most(n: int, cap: int) -> int:
    """The largest divisor of ``n`` that is <= ``cap`` (>= 1)."""
    for d in range(min(int(cap), int(n)), 1, -1):
        if n % d == 0:
            return d
    return 1


def free_chunk_dim(hop, ndim: int, offset: int,
                   avoid_dims: Sequence[int] = ()) -> Optional[int]:
    """Pick a dim (absolute index) legal for chunk-pipelining this hop.

    Excluded are every dim any of the hop's moves splits or concatenates
    *and* every dim in ``avoid_dims`` (the downstream stage's absolute
    ``fft_dims``).  Returns None when no legal dim exists.
    """
    hop = _as_hop(hop)
    busy = {d + offset for d in hop.busy_dims()}
    busy.update(avoid_dims)
    # Prefer the last spatial dim (largest stride locality for packing).
    for d in range(ndim - 1, offset - 1, -1):
        if d not in busy:
            return d
    # Fall back to a leading batch dim.
    for d in range(offset):
        if d not in busy:
            return d
    return None


@dataclasses.dataclass(frozen=True)
class PackedBlock:
    """A stage output already stored as the next move's send buffer.

    ``send`` is ``(p, *others, n/p)`` and contiguous; ``split_dim`` is the
    absolute dim of the logical block that the move splits.
    """

    send: torch.Tensor
    split_dim: int

    @property
    def parts(self) -> int:
        return self.send.shape[0]

    def logical(self) -> torch.Tensor:
        """The block in its logical layout (a copy)."""
        return unpack_send(self.send, self.split_dim)


Block = Union[torch.Tensor, PackedBlock]


def send_buffer(x: Block, split_dim: int, parts: int) -> torch.Tensor:
    """The contiguous ``(parts, *others, n/parts)`` send buffer of ``x``.

    For a :class:`PackedBlock` built for this split this is its own buffer
    (same storage, no copy).
    """
    if isinstance(x, PackedBlock):
        if x.split_dim != split_dim or x.parts != parts:
            x = x.logical()
        else:
            return x.send.contiguous()
    xm = x.movedim(split_dim, -1)
    seg = xm.shape[-1] // parts
    return xm.unflatten(-1, (parts, seg)).movedim(-2, 0).contiguous()


def unpack_send(buf: torch.Tensor, split_dim: int) -> torch.Tensor:
    """Inverse of :func:`send_buffer` (without the exchange)."""
    return buf.movedim(0, -2).flatten(-2).movedim(-1, split_dim)


def _as_real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


@dataclasses.dataclass
class _InFlight:
    """One issued move.  ``send`` and ``recv`` stay referenced until
    :func:`_land` has waited on ``work``; ``work`` is None for a size-1
    axis, whose ``recv`` is the block itself."""

    send: Optional[torch.Tensor]
    recv: torch.Tensor
    work: Optional[object]
    split: int
    concat: int


def _issue(x: Block, split: int, concat: int, parts: int,
           group) -> _InFlight:
    """Start one tiled all_to_all (``split`` scattered, ``concat``
    gathered) without waiting for it."""
    if parts == 1:
        x = x.logical() if isinstance(x, PackedBlock) else x
        return _InFlight(None, x, None, split, concat)
    send = send_buffer(x, split, parts)
    recv = torch.empty_like(send)
    work = dist.all_to_all_single(_as_real(recv), _as_real(send),
                                  group=group, async_op=True)
    return _InFlight(send, recv, work, split, concat)


def _land(f: _InFlight) -> torch.Tensor:
    """Wait for an issued move and return its block in logical layout."""
    if f.work is None:
        return f.recv
    f.work.wait()
    # recv[i] is rank i's block of shape (*others, n/p); put the source
    # index just before the concat dim and merge the two.
    ci = f.concat if f.concat < f.split else f.concat - 1
    out = f.recv.movedim(0, ci).flatten(ci, ci + 1)
    return out.movedim(-1, f.split)


def _issue_hop(x: Block, hop, mesh, offset: int) -> _InFlight:
    """Issue the hop's first move."""
    mv = hop.moves[0]
    return _issue(x, mv.split_dim + offset, mv.concat_dim + offset,
                  mesh.axis_sizes[mv.mesh_axis], mesh.groups[mv.mesh_axis])


def _land_hop(f: _InFlight, hop, mesh, offset: int) -> torch.Tensor:
    """Wait for the hop's first move, then run its other moves."""
    x = _land(f)
    for mv in hop.moves[1:]:
        x = _land(_issue(x, mv.split_dim + offset, mv.concat_dim + offset,
                         mesh.axis_sizes[mv.mesh_axis],
                         mesh.groups[mv.mesh_axis]))
    return x


def _send_dim(x: PackedBlock, dim: int) -> int:
    """Where logical dim ``dim`` (never the split dim) sits in the send
    buffer ``(p, *others, n/p)``."""
    return 1 + (dim if dim < x.split_dim else dim - 1)


def _narrow(x: Block, dim: int, start: int, length: int) -> Block:
    """Chunk ``[start, start + length)`` of logical dim ``dim``; a
    :class:`PackedBlock` is cut in its send layout."""
    if isinstance(x, PackedBlock):
        return PackedBlock(x.send.narrow(_send_dim(x, dim), start, length),
                           x.split_dim)
    return x.narrow(dim, start, length)


def _join(outs: List[Block], dim: int) -> Block:
    """Chunk outputs joined along logical dim ``dim``: packed chunks join
    their send buffers."""
    if isinstance(outs[0], PackedBlock):
        return PackedBlock(torch.cat([o.send for o in outs],
                                     dim=_send_dim(outs[0], dim)),
                           outs[0].split_dim)
    return torch.cat(outs, dim=dim)


def _bulk(block: Block, hop, mesh, offset: int, then) -> Block:
    x = _land_hop(_issue_hop(block, hop, mesh, offset), hop, mesh, offset)
    return then(x) if then is not None else x


def redistribute(block: Block, hop, *, mesh,
                 n_chunks: int = 1,
                 then: Optional[Callable[[torch.Tensor], Block]] = None,
                 spatial_offset: int = 0,
                 avoid_dims: Sequence[int] = (),
                 hop_index: Optional[int] = None) -> Block:
    """Run one redistribution hop on this rank's block.

    ``spatial_offset`` is the number of leading batch dims before the
    spatial dims the decomposition describes; ``then`` is the next stage's
    local transform, run per chunk when ``n_chunks > 1``; ``avoid_dims``
    are the absolute dims that transform touches, which the chunk dim must
    avoid.  ``n_chunks`` is this hop's entry of the pipeline's
    ``chunk_schedule``; ``hop_index`` labels the warnings.
    """
    hop = _as_hop(hop)
    if n_chunks <= 1:
        return _bulk(block, hop, mesh, spatial_offset, then)
    tag = f"hop {hop_index}" if hop_index is not None else "this hop"
    ndim = (block.send.dim() - 1 if isinstance(block, PackedBlock)
            else block.dim())
    chunk_dim = free_chunk_dim(hop, ndim, spatial_offset, avoid_dims)
    if chunk_dim is None:
        warnings.warn(
            f"no legal chunk dim for {tag} over {hop.mesh_axes} (every dim "
            f"is part of the exchange or of the next stage's transform); "
            f"running the bulk path instead of n_chunks={n_chunks}",
            RuntimeWarning, stacklevel=2)
        return _bulk(block, hop, mesh, spatial_offset, then)
    size = (block.send.shape[_send_dim(block, chunk_dim)]
            if isinstance(block, PackedBlock) else block.shape[chunk_dim])
    eff_chunks = largest_divisor_at_most(size, n_chunks)
    if eff_chunks != n_chunks:
        warnings.warn(
            f"chunk dim {chunk_dim} (size {size}) of {tag} not divisible "
            f"by n_chunks={n_chunks}; clamped to {eff_chunks}",
            RuntimeWarning, stacklevel=2)
        if eff_chunks <= 1:
            return _bulk(block, hop, mesh, spatial_offset, then)
    step = size // eff_chunks
    pieces = [_narrow(block, chunk_dim, k * step, step)
              for k in range(eff_chunks)]
    # Chunk k+1's exchange is in flight while `then` runs on chunk k.
    flight = _issue_hop(pieces[0], hop, mesh, spatial_offset)
    outs = []
    for k in range(eff_chunks):
        nxt = (_issue_hop(pieces[k + 1], hop, mesh, spatial_offset)
               if k + 1 < eff_chunks else None)
        t = _land_hop(flight, hop, mesh, spatial_offset)
        outs.append(then(t) if then is not None else t)
        flight = nxt
    return _join(outs, chunk_dim)


def transpose_cost_bytes(local_shape, dtype_bytes: int, axis_size: int) -> int:
    """Bytes each rank puts on the wire for one all_to_all.

    Of the local block, a fraction (axis_size-1)/axis_size leaves the rank
    (the diagonal block stays local).
    """
    n_elems = 1
    for s in local_shape:
        n_elems *= s
    total = n_elems * dtype_bytes
    return total * (axis_size - 1) // max(axis_size, 1)


def hop_move_shapes(hop, start_shape, axis_sizes):
    """Local block shape seen by each move of a hop, in execution order.

    Yields ``(move, shape_before_move)``; the shape threads through the
    moves (a split divides its dim by the axis size, a concat multiplies).
    """
    shape = list(start_shape)
    for mv in _as_hop(hop).moves:
        yield mv, tuple(shape)
        p = axis_sizes[mv.mesh_axis]
        shape[mv.split_dim] //= p
        shape[mv.concat_dim] *= p
