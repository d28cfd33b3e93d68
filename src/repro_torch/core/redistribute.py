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

Only bulk hops are ported: ``n_chunks > 1`` (the chunk-pipelined overlap)
raises ``NotImplementedError``.  :func:`largest_divisor_at_most`,
:func:`free_chunk_dim`, :func:`transpose_cost_bytes` and
:func:`hop_move_shapes` are pure metadata shared with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

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


def _exchange(send: torch.Tensor, group) -> torch.Tensor:
    recv = torch.empty_like(send)
    as_real = (lambda t: torch.view_as_real(t)) if send.is_complex() \
        else (lambda t: t)
    dist.all_to_all_single(as_real(recv), as_real(send), group=group)
    return recv


def _move(x: Block, split: int, concat: int, parts: int, group) -> torch.Tensor:
    """One tiled all_to_all: ``split`` scattered, ``concat`` gathered."""
    if parts == 1:
        return x.logical() if isinstance(x, PackedBlock) else x
    recv = _exchange(send_buffer(x, split, parts), group)
    # recv[i] is rank i's block of shape (*others, n/p); put the source
    # index just before the concat dim and merge the two.
    ci = concat if concat < split else concat - 1
    out = recv.movedim(0, ci).flatten(ci, ci + 1)
    return out.movedim(-1, split)


def redistribute(block: Block, hop, *, mesh,
                 n_chunks: int = 1,
                 then: Optional[Callable[[torch.Tensor], Block]] = None,
                 spatial_offset: int = 0,
                 hop_index: Optional[int] = None) -> Block:
    """Run one redistribution hop on this rank's block.

    ``spatial_offset`` is the number of leading batch dims before the
    spatial dims the decomposition describes; ``then`` is the next stage's
    local transform; ``hop_index`` labels errors.  The chunked path is not
    ported: ``n_chunks > 1`` raises ``NotImplementedError``.
    """
    if n_chunks > 1:
        tag = f"hop {hop_index}" if hop_index is not None else "this hop"
        raise NotImplementedError(
            f"chunked redistribution (n_chunks={n_chunks} at {tag}) is not "
            f"ported yet; the port runs bulk hops (n_chunks=1)")
    x = block
    for mv in _as_hop(hop).moves:
        x = _move(x, mv.split_dim + spatial_offset,
                  mv.concat_dim + spatial_offset,
                  mesh.axis_sizes[mv.mesh_axis], mesh.groups[mv.mesh_axis])
    if isinstance(x, PackedBlock):
        x = x.logical()
    return then(x) if then is not None else x


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
