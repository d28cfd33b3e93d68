"""Sharding rules and the parameter builder (the port's counterpart of the
JAX package's ``distributed/sharding.py``).

Logical axes used throughout the model code, as in the reference:

  "fsdp"   — parameter sharding axis(es);
  "tp"     — tensor-parallel axis ("model");
  "batch"  — data-parallel batch axis(es) == fsdp axes.

:class:`MeshRules` is a copy: the model code names the same logical axes,
and ``spec`` resolves them to mesh axis names (a plain tuple, the port's
form of a ``PartitionSpec``, see ``compat.py``).

:class:`ParamBuilder` creates every parameter by path.  Each path draws from
its own ``torch.Generator`` on the builder's device, seeded with
``seed ^ zlib.crc32(path)``, so a parameter's values depend on the seed,
its path and the device alone, never on the order of construction.  The
port's draws are not ``jax.random``'s bits: parity with the JAX package
comes only through the weight converter (``models/convert.py``, whose
``TreeBuilder`` reads each path from a reference tree instead).
:class:`StackedBuilder` gives a stack's repeats their slices of one
stacked draw, as the reference's stacked super-block leaves.

:func:`shard` is an explicit no-op: the port serves an LM on one process
(tensor-parallel LM serving is not ported yet).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Maps logical axis names to physical mesh axes.

    ``fsdp`` may be empty (serving layout: params replicated over the data
    axes, sharded only over "model"); ``batch_axes`` stays populated so
    activations/caches remain data-sharded.
    """
    fsdp: Tuple[str, ...] = ("data",)
    tp: str = "model"
    batch_axes: Optional[Tuple[str, ...]] = None

    @property
    def batch(self) -> Tuple[str, ...]:
        return self.batch_axes if self.batch_axes is not None else self.fsdp

    @staticmethod
    def _axis(axes: Tuple[str, ...]):
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]

    def resolve(self, logical: Optional[str]):
        if logical is None:
            return None
        if logical == "fsdp":
            return self._axis(self.fsdp)
        if logical == "tp":
            return self.tp
        if logical == "batch":
            return self._axis(self.batch)
        raise ValueError(f"unknown logical axis {logical!r}")

    def spec(self, *logical: Optional[str]) -> tuple:
        return tuple(self.resolve(l) for l in logical)

    @staticmethod
    def for_mesh(mesh) -> "MeshRules":
        """Rules for a ``compat.Mesh`` (None: one process, no mesh)."""
        names = tuple(mesh.axis_names) if mesh is not None else ()
        if "pod" in names:
            return MeshRules(fsdp=("pod", "data"))
        return MeshRules(fsdp=("data",))


def shard(x: torch.Tensor, rules: Optional[MeshRules],
          *logical: Optional[str]) -> torch.Tensor:
    """Returns ``x`` unchanged.

    The reference constrains ``x`` to the logical axes' sharding inside a
    jitted program.  The port runs the LM on one process, where every
    tensor is whole, so there is nothing to constrain; the calls stay at
    the reference's places so that tensor-parallel serving has them.
    """
    return x


def path_seed(seed: int, path: str) -> int:
    """The generator seed of one parameter path."""
    return (int(seed) ^ zlib.crc32(path.encode())) & 0xFFFFFFFFFFFFFFFF


class ParamBuilder:
    """Creates parameters by path on ``device`` (required: the builder
    has no device of its own to fall back on).

    ``param`` returns a plain tensor of ``dtype``: ``normal`` draws
    float32 standard normals times ``scale`` and casts, as the reference.
    ``logical`` names each dim's logical axis, as the reference's specs
    (checked against the shape; the port serves on one process, so no
    spec is built from them yet).
    """

    def __init__(self, seed: int, *, device,
                 dtype: torch.dtype = torch.float32):
        self.seed = int(seed)
        self.dtype = dtype
        self.device = torch.device(device)

    def param(self, path: str, shape: Sequence[int],
              logical: Sequence[Optional[str]], init: str = "normal",
              scale: float = 0.02) -> torch.Tensor:
        if len(logical) != len(shape):
            raise ValueError(f"{path}: logical axes {logical} vs shape {shape}")
        out = self._build(path, tuple(int(s) for s in shape), init, scale)
        if tuple(out.shape) != tuple(shape):
            raise ValueError(f"{path}: built shape {tuple(out.shape)} != "
                             f"declared {tuple(shape)}")
        return out

    def _build(self, path, shape, init, scale):
        if init == "normal":
            gen = torch.Generator(device=self.device)
            gen.manual_seed(path_seed(self.seed, path))
            out = torch.randn(shape, generator=gen, dtype=torch.float32,
                              device=self.device)
            return out.mul_(scale).to(self.dtype)
        if init == "zeros":
            return torch.zeros(shape, dtype=self.dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=self.dtype, device=self.device)
        if init == "mamba_a":
            # S4D-real initialization: A = -(1..d_state) along the last dim,
            # broadcast over all leading (stack, channel) dims
            a = torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                             device=self.device)
            return torch.log(a).expand(shape).to(self.dtype).contiguous()
        raise ValueError(f"unknown init {init!r}")


class StackedBuilder:
    """The stack's view of a builder: each path is drawn once as a
    ``(reps, *shape)`` leaf (the reference's stacked super-block leaf) and
    repeat ``r`` gets its slice ``[r]``, a view of that storage."""

    def __init__(self, parent, reps: int):
        self.parent = parent
        self.reps = reps
        self._stacked: Dict[str, torch.Tensor] = {}

    def at(self, r: int) -> "_RepeatBuilder":
        return _RepeatBuilder(self, r)

    def _get(self, path, shape, logical, init, scale) -> torch.Tensor:
        if path not in self._stacked:
            self._stacked[path] = self.parent.param(
                path, (self.reps,) + tuple(shape), (None,) + tuple(logical),
                init=init, scale=scale)
        return self._stacked[path]


@dataclasses.dataclass
class _RepeatBuilder:
    stack: StackedBuilder
    r: int

    def param(self, path: str, shape: Sequence[int],
              logical: Sequence[Optional[str]], init: str = "normal",
              scale: float = 0.02) -> torch.Tensor:
        return self.stack._get(path, shape, logical, init, scale)[self.r]

