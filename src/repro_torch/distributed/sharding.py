"""Sharding rules, the parameter builder and the LM's collectives (the
port's counterpart of the JAX package's ``distributed/sharding.py``).

Logical axes used throughout the model code, as in the reference:

  "fsdp"   — parameter sharding axis(es) (ZeRO-3);
  "tp"     — tensor-parallel axis ("model");
  "batch"  — data-parallel batch axis(es) == fsdp axes.

:class:`MeshRules` is the reference's, plus the ``compat.Mesh`` it runs on
(None: one process) and the dtype of the gradient reductions over the
batch axes.  ``spec`` resolves logical axes to mesh axis names (a plain
tuple, the port's form of a ``PartitionSpec``, see ``compat.py``).

:class:`ParamBuilder` creates every parameter by path and records its spec
(``specs``).  Each path draws from its own ``torch.Generator`` on the
builder's device, seeded with ``seed ^ zlib.crc32(path)``, so a
parameter's values depend on the seed, its path and the device alone,
never on the order of construction.  On a mesh the builder draws each
parameter whole and keeps this rank's block (:func:`place`), so a sharded
model holds the one-process model's values whatever the mesh.  Every
tensor the builder returns carries its spec as ``.spec``; ``layers.
as_param`` keeps it on the parameter.  The port's draws are not
``jax.random``'s bits: parity with the JAX package comes only through the
weight converter (``models/convert.py``, whose ``TreeBuilder`` reads each
path from a reference tree and places it the same way).
:class:`StackedBuilder` gives a stack's repeats their slices of one
stacked draw, as the reference's stacked super-block leaves.

Tensors carry no layout, so where GSPMD would insert a collective at a
``shard`` constraint the port names it (Megatron's conjugate pairs):

* :func:`use` — a parameter as its layer computes with it: gathered over
  the axes its layer does not split (always the fsdp axes; the "model"
  axis on request), released when the layer's autograd graph is; its
  gradient is reduce-scattered back.
* :func:`tp_sum` — the sum of partial results over "model" (a row-
  parallel product); backward passes the gradient on.
* :func:`tp_copy` — a replicated value entering per-rank work; backward
  sums the partial gradients over "model".
* :func:`batch_mean` — a statistic over the batch axes (MoE's router
  balance), with its adjoint.

:func:`shard` stays the identity: an activation is already this rank's
block of the layout it names.  Every helper is the identity when the axis
it reduces over has one rank, so a ``(1, 1)`` mesh computes bit for bit
what no mesh does.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..compat import (_spec_axes, all_gather_dim, local_block,
                      reduce_scatter_dim)


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Maps logical axis names to physical mesh axes.

    ``fsdp`` may be empty (serving layout: params replicated over the data
    axes, sharded only over "model"); ``batch_axes`` stays populated so
    activations/caches remain data-sharded.  ``mesh`` is the
    ``compat.Mesh`` the model runs on (None: one process) and
    ``grad_dtype`` the dtype gradients are summed in over the batch axes
    (None: their own; the train step sets bfloat16 under
    ``grad_compress``).
    """
    fsdp: Tuple[str, ...] = ("data",)
    tp: str = "model"
    batch_axes: Optional[Tuple[str, ...]] = None
    mesh: Optional[object] = dataclasses.field(default=None, compare=False)
    grad_dtype: Optional[torch.dtype] = dataclasses.field(default=None,
                                                          compare=False)

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
            return MeshRules(fsdp=("pod", "data"), mesh=mesh)
        return MeshRules(fsdp=("data",), mesh=mesh)

    # -- this rank's place on the mesh --------------------------------------
    def size(self, axis: str) -> int:
        mesh = self.mesh
        if mesh is None or axis not in mesh.axis_names:
            return 1
        return mesh.axis_sizes[axis]

    def index(self, axis: str) -> int:
        return self.mesh.coord(axis) if self.size(axis) > 1 else 0

    def group(self, axis: str):
        """The process group along ``axis`` (None: one rank there)."""
        return self.mesh.groups[axis] if self.size(axis) > 1 else None

    @property
    def tp_size(self) -> int:
        return self.size(self.tp)

    @property
    def tp_index(self) -> int:
        return self.index(self.tp)

    @property
    def batch_size(self) -> int:
        n = 1
        for ax in self.batch:
            n *= self.size(ax)
        return n


def _tp_group(rules: Optional[MeshRules]):
    return None if rules is None else rules.group(rules.tp)


def shard(x: torch.Tensor, rules: Optional[MeshRules],
          *logical: Optional[str]) -> torch.Tensor:
    """Returns ``x`` unchanged.

    The reference constrains ``x`` to the logical axes' sharding inside a
    jitted program.  The port's activations are already this rank's block
    of that layout (the batch split over the batch axes, a "tp" dim over
    "model"); the collectives that GSPMD inserts at these places are
    explicit (:func:`tp_sum`, :func:`tp_copy`, :func:`use`).
    """
    return x


# ---------------------------------------------------------------------------
# collectives with their adjoints
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, group, dtype=None) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (computed in ``dtype`` when given)."""
    out = x.to(dtype) if dtype is not None and dtype != x.dtype \
        else x.clone()
    dist.all_reduce(out, group=group)
    return out.to(x.dtype)


class _Sum(torch.autograd.Function):
    """All-reduce forward (summed in float32: a bfloat16 partial product is
    rounded once, as the one-process product is, and not again at every
    addition); backward: the gradient (``backward_sum=False``, the model
    axis, whose ranks hold one copy of the loss) or its all-reduce
    (``backward_sum=True``)."""

    @staticmethod
    def forward(ctx, x, group, backward_sum):
        ctx.group, ctx.backward_sum = group, backward_sum
        return _all_reduce(x, group, torch.float32
                           if x.is_floating_point() else None)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce(g, ctx.group, torch.float32)
                if ctx.backward_sum else g, None, None)


class _Copy(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient backward (in
    float32)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, torch.float32), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward: the gradient's
    reduce-scatter (``mode="sum"``: each rank's use contributed a part,
    summed in ``grad_dtype`` when given) or this rank's block of it
    (``mode="slice"``: every rank computed the same whole gradient)."""

    @staticmethod
    def forward(ctx, x, dim, group, mode, grad_dtype):
        ctx.dim, ctx.group, ctx.mode = dim, group, mode
        ctx.grad_dtype = grad_dtype
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.mode == "slice":
            n = dist.get_world_size(ctx.group)
            step = g.shape[ctx.dim] // n
            out = g.narrow(ctx.dim, dist.get_rank(ctx.group) * step, step)
            return out.contiguous(), None, None, None, None
        dt = ctx.grad_dtype
        src = g.to(dt) if dt is not None and dt != g.dtype else g
        out = reduce_scatter_dim(src, ctx.dim, ctx.group).to(g.dtype)
        return out, None, None, None, None


def tp_sum(x: torch.Tensor, rules: Optional[MeshRules]) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over "model" (Megatron's g)."""
    group = _tp_group(rules)
    return x if group is None else _Sum.apply(x, group, False)


def tp_copy(x: torch.Tensor, rules: Optional[MeshRules]) -> torch.Tensor:
    """``x``, replicated over "model", entering per-rank work: backward
    sums the ranks' partial gradients (Megatron's f)."""
    group = _tp_group(rules)
    return x if group is None else _Copy.apply(x, group)


def batch_mean(x: torch.Tensor, rules: Optional[MeshRules]) -> torch.Tensor:
    """The mean of ``x`` over the batch axes (each rank's statistic of its
    rows), with its adjoint: every data rank's loss holds the result."""
    if rules is None or rules.batch_size == 1:
        return x
    for ax in rules.batch:
        group = rules.group(ax)
        if group is not None:
            x = _Sum.apply(x, group, True)
    return x / rules.batch_size


def gather_dim(x: torch.Tensor, dim: int, group, mode: str = "sum",
               grad_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over ``group`` (None: ``x``), with
    the backward ``mode`` of :class:`_Gather`."""
    if group is None:
        return x
    return _Gather.apply(x, dim, group, mode, grad_dtype)


def use(p: torch.Tensor, rules: Optional[MeshRules], *,
        tp: Optional[str] = None) -> torch.Tensor:
    """The parameter ``p`` (this rank's block, spec ``p.spec``) as its
    layer computes with it.

    Every dim split over an fsdp axis is gathered (ZeRO-3), its gradient
    reduce-scattered back in the rules' ``grad_dtype``.  The "model" axis
    is gathered only with ``tp="sum"`` (the ranks use different parts of
    the whole, so their gradients add up) or ``tp="slice"`` (every rank
    computes with the whole the same way and keeps its block of the
    gradient).  The result lives as long as the layer's autograd graph
    (under remat: until its recomputation in backward is done).
    """
    if rules is None or rules.mesh is None or rules.mesh.size == 1:
        return p
    spec = getattr(p, "spec", None)
    if spec is None:
        raise ValueError("a sharded parameter needs its spec (.spec)")
    x = p
    for d, entry in enumerate(spec):
        for ax in reversed(_spec_axes(entry)):   # minor axis first
            if ax == rules.tp:
                if tp is None:
                    continue
                x = gather_dim(x, d, rules.group(ax), tp)
            else:
                x = gather_dim(x, d, rules.group(ax), "sum",
                               rules.grad_dtype)
    return x


def reduce_grads(grads: Dict, specs: Dict, rules: Optional[MeshRules]
                 ) -> Dict:
    """Sums each gradient over the batch axes that do not split its
    parameter (the split ones were reduce-scattered in backward), in the
    rules' ``grad_dtype``: ``grads`` with the sums in place of the
    rank's own."""
    if rules is None or rules.batch_size == 1:
        return grads
    for k, g in grads.items():
        split = {a for e in specs[k] for a in _spec_axes(e)}
        for ax in rules.batch:
            group = rules.group(ax)
            if group is None or ax in split:
                continue
            grads[k] = g = _all_reduce(g, group, rules.grad_dtype)
    return grads


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def place(t: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``spec`` (the
    counterpart of ``device_put`` onto a ``NamedSharding``), an owned
    copy when a dim is split so that the whole can be freed; ``t`` itself
    without a mesh.  The block carries ``spec`` as ``.spec``."""
    spec = tuple(spec)
    out = t
    if mesh is not None and mesh.size > 1:
        blk = local_block(t, spec, mesh)
        if blk.shape != t.shape:
            out = blk.clone()
    out.spec = spec
    return out


def param_pspecs(model) -> Dict:
    """The model's spec by ``models.convert.param_leaves`` key
    (``(reference path, super-block)``): each super-block's leaf has the
    stacked leaf's spec without its leading stack entry."""
    from ..models.convert import param_leaves
    return {k: tuple(p.spec) for k, p in param_leaves(model).items()}


def pspec_tree(model) -> Dict:
    """The reference's spec tree of the model's parameters (nested by
    path; a stacked leaf's spec leads with ``None``), as the reference's
    ``param_pspecs`` gives it for ``init_model``'s tree."""
    from ..models.convert import _set_path
    tree: Dict = {}
    for (path, r), spec in param_pspecs(model).items():
        _set_path(tree, path, spec if r is None else (None,) + spec)
    return tree


def path_seed(seed: int, path: str) -> int:
    """The generator seed of one parameter path."""
    return (int(seed) ^ zlib.crc32(path.encode())) & 0xFFFFFFFFFFFFFFFF


def tp_split(b, n: int) -> bool:
    """Whether builder ``b``'s mesh splits ``n`` (heads, experts) over
    "model": True when its size divides ``n``; False when ``n`` divides
    the size (each rank then holds the one it needs, replicated:
    grouped-query attention with fewer K/V heads than "model" ranks);
    refused otherwise."""
    size = b.rules.tp_size
    if n % size == 0:
        return True
    if size % n == 0:
        return False
    raise ValueError(f"{n} heads do not split over, nor divide, a "
                     f"\"model\" axis of {size}")


class ParamBuilder:
    """Creates parameters by path on ``device`` (required: the builder
    has no device of its own to fall back on), recording each path's spec
    (``specs``) under ``rules``; with ``rules.mesh`` each parameter is this
    rank's block (:func:`place`).

    ``param`` returns a plain tensor of ``dtype``: ``normal`` draws
    float32 standard normals times ``scale`` and casts, as the reference.
    ``logical`` names each dim's logical axis, as the reference's specs.
    """

    def __init__(self, seed: int, *, device,
                 dtype: torch.dtype = torch.float32,
                 rules: Optional[MeshRules] = None):
        self.seed = int(seed)
        self.dtype = dtype
        self.device = torch.device(device)
        self.rules = rules or MeshRules()
        self.specs: Dict[str, tuple] = {}

    def param(self, path: str, shape: Sequence[int],
              logical: Sequence[Optional[str]], init: str = "normal",
              scale: float = 0.02) -> torch.Tensor:
        if len(logical) != len(shape):
            raise ValueError(f"{path}: logical axes {logical} vs shape {shape}")
        out = self._build(path, tuple(int(s) for s in shape), init, scale)
        if tuple(out.shape) != tuple(shape):
            raise ValueError(f"{path}: built shape {tuple(out.shape)} != "
                             f"declared {tuple(shape)}")
        spec = self.specs[path] = self.rules.spec(*logical)
        return place(out, spec, self.rules.mesh)

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
    ``(reps, *shape)`` leaf (the reference's stacked super-block leaf,
    spec ``(None, *spec)``) and repeat ``r`` gets its slice ``[r]``, a
    view of that storage with spec ``spec``."""

    def __init__(self, parent, reps: int):
        self.parent = parent
        self.reps = reps
        self.rules = parent.rules
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

    @property
    def rules(self) -> MeshRules:
        return self.stack.rules

    def param(self, path: str, shape: Sequence[int],
              logical: Sequence[Optional[str]], init: str = "normal",
              scale: float = 0.02) -> torch.Tensor:
        stacked = self.stack._get(path, shape, logical, init, scale)
        out = stacked[self.r]
        out.spec = stacked.spec[1:]
        return out
