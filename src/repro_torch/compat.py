"""Device mesh and block layout helpers (the port's ``repro/compat.py``).

The JAX package builds a named device mesh (``make_mesh``) and runs each
pipeline as a ``shard_map`` body whose input is placed by a
``NamedSharding``.  PyTorch runs one process per rank instead, so the same
roles are played here by:

* :class:`Mesh` — axis names, shape, this rank's coordinates, the torch
  ``device`` it computes on, and one ``torch.distributed`` subgroup per
  axis (from ``init_device_mesh``).  A mesh of one rank needs no process
  group at all.
* :func:`local_block` — the block of a global tensor that a spec assigns to
  this rank (``device_put`` onto a ``NamedSharding``).
* :func:`gather` — the inverse: every rank's block assembled into the
  global tensor on every rank of the mesh.

A mesh may span a subset of the world's ranks (``make_mesh(ranks=...)``):
the degraded mesh of a service that lost devices.  Its collectives then
run on process groups of its own ranks only.

A spec is a plain tuple with one entry per dim: ``None`` (full), an axis
name, or a tuple of axis names (major axis first), as in the JAX package's
``PartitionSpec``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

NO_CUDA_MESSAGE = ("CUDA is not available; pass device='cpu' to run the port "
                   "on the CPU (the kernel backend then uses its plain "
                   "PyTorch version)")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks.

    ``device=None`` means the current CUDA device, and raises a
    ``RuntimeError`` naming ``device='cpu'`` when there is no GPU: the
    port never drops to the CPU on its own.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(NO_CUDA_MESSAGE)
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(NO_CUDA_MESSAGE)
    if dev.type == "cuda" and dev.index is None:
        # "cuda" names the current card: give it its index, so that it
        # compares equal to the device of the tensors made on it
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _spec_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


@dataclasses.dataclass(eq=False)
class Mesh:
    """A named process grid, seen from one rank.

    ``coords[i]`` is this rank's index along ``axis_names[i]``; ranks are
    laid out row-major over ``shape``, like the device array of a JAX mesh.
    ``groups`` maps each axis name to the subgroup of the ranks that share
    every other coordinate (None when the world has one rank).  ``ranks``
    are the global ranks of the mesh in that order (empty: ``0 .. size-1``)
    and ``group`` the process group spanning them (None: the default
    group).
    """

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...]
    device: torch.device
    groups: Dict[str, Optional[object]]
    ranks: Tuple[int, ...] = ()
    group: Optional[object] = None

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def root(self) -> int:
        """The global rank of the mesh's first rank (the one that decides
        for the others, and the one that writes files)."""
        return self.ranks[0] if self.ranks else 0

    def coord(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def __repr__(self) -> str:
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, "
                f"coords={self.coords}, device={self.device})")


def _rank_coords(rank: int, shape: Sequence[int]) -> Tuple[int, ...]:
    coords = []
    for s in reversed(shape):
        coords.append(rank % s)
        rank //= s
    return tuple(reversed(coords))


def _rank_device(device, rank: int) -> torch.device:
    """This rank's device: its own card under NCCL, else what was asked."""
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", rank % torch.cuda.device_count())
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device=None, ranks: Optional[Sequence[int]] = None
              ) -> Optional[Mesh]:
    """Build this rank's view of a named mesh.

    With more than one rank the default process group must already be
    initialized with a world size equal to the product of ``axis_shapes``
    (gloo for ``device='cpu'``, NCCL for CUDA).  ``device=None`` picks the
    CUDA device of this rank and raises when there is none.

    ``ranks`` (increasing global ranks, one per mesh position) builds a
    mesh over a subset of the world instead.  Creating its process groups
    is collective over the default group, so every rank calls this with
    the same arguments; a rank outside ``ranks`` gets None.
    """
    shape = tuple(int(s) for s in axis_shapes)
    names = tuple(axis_names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} differ "
                         f"in length")
    world = math.prod(shape)
    initialized = dist.is_available() and dist.is_initialized()
    if ranks is not None:
        return _subset_mesh(shape, names, tuple(int(r) for r in ranks),
                            device, initialized)
    if world == 1:
        return Mesh(names, shape, (0,) * len(shape), resolve_device(device),
                    {n: None for n in names})
    if not initialized or dist.get_world_size() != world:
        raise RuntimeError(
            f"a {shape} mesh needs torch.distributed initialized with world "
            f"size {world} (got "
            f"{dist.get_world_size() if initialized else 'no process group'})")
    rank = dist.get_rank()
    dev = _rank_device(device, rank)
    from torch.distributed.device_mesh import init_device_mesh
    dmesh = init_device_mesh(dev.type, shape, mesh_dim_names=names)
    return Mesh(names, shape, _rank_coords(rank, shape), dev,
                {n: dmesh.get_group(n) for n in names},
                ranks=tuple(range(world)))


def _subset_mesh(shape, names, ranks: Tuple[int, ...], device,
                 initialized: bool) -> Optional[Mesh]:
    world = math.prod(shape)
    if len(ranks) != world or list(ranks) != sorted(set(ranks)):
        raise ValueError(f"a {shape} mesh needs {world} increasing distinct "
                         f"ranks, got {ranks}")
    rank = dist.get_rank() if initialized else 0
    if not initialized and ranks != (0,):
        raise RuntimeError(f"a mesh over ranks {ranks} needs torch."
                           f"distributed initialized")
    # new_group is collective over the default group: every rank creates
    # every group, in the same order, and keeps the ones it belongs to.
    groups: Dict[str, Optional[object]] = {n: None for n in names}
    for i, name in enumerate(names):
        if shape[i] == 1:
            continue
        for pos in range(world):
            coords = _rank_coords(pos, shape)
            if coords[i]:
                continue
            line = []
            for k in range(shape[i]):
                c = list(coords)
                c[i] = k
                line.append(ranks[_flat_index(c, shape)])
            g = dist.new_group(line)
            if rank in line:
                groups[name] = g
    group = dist.new_group(list(ranks)) if world > 1 else None
    if rank not in ranks:
        return None
    return Mesh(names, shape, _rank_coords(ranks.index(rank), shape),
                _rank_device(device, rank), groups, ranks=ranks, group=group)


def _flat_index(coords: Sequence[int], shape: Sequence[int]) -> int:
    idx = 0
    for c, s in zip(coords, shape):
        idx = idx * s + c
    return idx


def shard_index(entry, mesh: Mesh) -> Tuple[int, int]:
    """(this rank's shard index, shard count) of one spec entry."""
    idx, count = 0, 1
    for ax in _spec_axes(entry):
        size = mesh.axis_sizes[ax]
        idx = idx * size + mesh.coord(ax)
        count *= size
    return idx, count


def local_block(x: torch.Tensor, spec: Sequence, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec``.

    Leading dims beyond ``len(spec)`` are not allowed; pass ``None`` entries
    for replicated (batch) dims.  The block is a view when no dim is split.
    """
    if len(spec) != x.dim():
        raise ValueError(f"spec {tuple(spec)} does not match a "
                         f"{x.dim()}-d tensor")
    for d, entry in enumerate(spec):
        idx, count = shard_index(entry, mesh)
        if count == 1:
            continue
        if x.shape[d] % count:
            raise ValueError(f"dim {d} ({x.shape[d]}) does not split into "
                             f"{count} shards")
        step = x.shape[d] // count
        x = x.narrow(d, idx * step, step)
    return x


def gather(local: torch.Tensor, spec: Sequence, mesh: Mesh) -> torch.Tensor:
    """The global tensor, assembled on every rank of the mesh from each
    rank's block."""
    if mesh.size == 1:
        return local
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    real = [torch.view_as_real(p) if p.is_complex() else p for p in parts]
    dist.all_gather(real, torch.view_as_real(local) if local.is_complex()
                    else local, group=mesh.group)
    counts = [shard_index(e, mesh)[1] for e in spec]
    out = local.new_empty(tuple(s * c for s, c in zip(local.shape, counts)))
    for rank, part in enumerate(parts):
        view = dataclasses.replace(mesh,
                                   coords=_rank_coords(rank, mesh.shape))
        local_block(out, spec, view).copy_(part)
    return out


# ---------------------------------------------------------------------------
# collectives along one tensor dim (the LM's tensor and data parallelism)
# ---------------------------------------------------------------------------

def _single_collective(new: str, old: str):
    # torch 2.13 renamed the flat-tensor collectives (the old names warn)
    return getattr(dist, new, None) or getattr(dist, old)


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The blocks of ``x`` of every rank of ``group``, concatenated along
    ``dim`` in group-rank order."""
    n = dist.get_world_size(group)
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((n * moved.shape[0],) + tuple(moved.shape[1:]))
    _single_collective("all_gather_single", "all_gather_into_tensor")(
        out, moved, group=group)
    return out.movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, of which this rank keeps its block
    along ``dim``."""
    n = dist.get_world_size(group)
    moved = x.movedim(dim, 0).contiguous()
    if moved.shape[0] % n:
        raise ValueError(f"dim {dim} ({moved.shape[0]}) does not split into "
                         f"{n} shards")
    out = moved.new_empty((moved.shape[0] // n,) + tuple(moved.shape[1:]))
    _single_collective("reduce_scatter_single", "reduce_scatter_tensor")(
        out, moved, group=group)
    return out.movedim(0, dim)
