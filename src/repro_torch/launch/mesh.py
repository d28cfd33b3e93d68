"""Device and mesh choice for the LM drivers (the port's counterpart of the
JAX package's ``launch/mesh.py``).

A function, not a module-level constant: importing this module touches no
device and no process group.
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from ..compat import Mesh, make_mesh


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
