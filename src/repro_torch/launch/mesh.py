"""Device and mesh choice for the LM drivers (the port's counterpart of the
JAX package's ``launch/mesh.py``), and the drivers' process spawner.

Functions, not module-level constants: importing this module touches no
device and no process group.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..compat import Mesh, make_mesh, resolve_device


def make_host_mesh(device=None) -> Optional[Mesh]:
    """The processes there are, as a ``("data", "model")`` mesh.

    One process (no process group, or a world of one) means one card and
    no mesh: None.  Under an initialized process group the world becomes a
    ``(world // model, model)`` mesh with the largest model axis of 4, 2, 1
    dividing it, as the reference (``compat.make_mesh``, which builds the
    axes' subgroups with ``init_device_mesh``).
    """
    if not (dist.is_available() and dist.is_initialized()):
        return None
    n = dist.get_world_size()
    if n == 1:
        return None
    model = next(c for c in (4, 2, 1) if n % c == 0)
    return make_mesh((n // model, model), ("data", "model"), device=device)


def make_lm_mesh(shape: Optional[Sequence[int]] = None,
                 device=None) -> Optional[Mesh]:
    """An explicit ``("data", "model")`` mesh of ``shape`` over the process
    group's world (``make_host_mesh`` when ``shape`` is None)."""
    if shape is None:
        return make_host_mesh(device)
    return make_mesh(tuple(shape), ("data", "model"), device=device)


def parse_mesh(text: str) -> Tuple[int, int]:
    """``"2x2"`` -> ``(2, 2)``: a ``("data", "model")`` mesh shape."""
    parts = text.lower().split("x")
    if len(parts) != 2:
        raise ValueError(f"a mesh is DATAxMODEL, e.g. 2x2; got {text!r}")
    return int(parts[0]), int(parts[1])


def _spawned(rank: int, target, world: int, init_file: str, backend: str,
             args: tuple) -> None:
    if backend == "nccl":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        target(*args)
    finally:
        dist.destroy_process_group()


def spawn(target, world: int, device, *args) -> None:
    """``target(*args)`` on ``world`` spawned ranks under one process
    group: gloo with ``device="cpu"``, else NCCL with rank r on card r.
    ``target`` is a module-level function (it is pickled)."""
    import torch.multiprocessing as mp
    backend = "gloo" if str(device) == "cpu" else "nccl"
    if backend == "nccl":
        resolve_device(None)     # raises without a GPU
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_spawned,
                           args=(target, world,
                                 os.path.join(tmp, "rendezvous"), backend,
                                 args),
                           nprocs=world, join=True, start_method="spawn")
