"""User-facing API: first-class distributed FFT plans, on torch tensors.

The port's counterpart of the JAX package's ``core/api.py``:

    mesh = make_mesh((1, 1), ("data", "model"))          # CUDA by default
    plan = plan_fft(mesh, (512, 512, 512), backend="kernel")
    yk = plan(x)                # forward (== plan.forward(x))
    x2 = plan.inverse(yk)       # paired inverse, same schedule
    print(plan.describe())

    solver = PoissonSolver(mesh, (512, 512, 512),
                           topology=("periodic", "periodic", "bounded"))
    phi = solver(rhs)           # lap(phi) = rhs, Neumann along the bounded dim

``forward(x)`` takes the full global tensor and each rank transforms its
stage-0 block of it (``device_put`` in the reference);
``forward(x, sharded_in=True)`` takes this rank's block as it is.  Either
way the call returns this rank's block in the last stage's layout
(``plan.out_struct``); ``compat.gather`` assembles the global result.
PyTorch runs eagerly, so there is no compile step, no "precompiled" flag
and no donation.

Only ``tuning="off"`` is ported: the schedule comes from the explicit
knobs, or from a :class:`~.plan.TunedPlan` record passed as ``tuned=``
(which may come from the JAX package's wisdom JSON).  The legacy wrappers
``fftnd``/``ifftnd``/``fft2d``/``ifft2d``/``fft3d``/``ifft3d`` and
``poisson_solve`` memoize one plan (or solver) per problem key in an LRU
(``$REPRO_TORCH_PLAN_MEMO_SIZE``, default 64).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compat import Mesh, local_block, shard_index
from . import transforms
from .decomp import describe_decomp, make_decomposition, validate_grid
from .pipeline import (PipelineSpec, TensorStruct, build_pipeline,
                       input_struct, make_spec, output_struct)
from .plan import GLOBAL_PLAN_CACHE, TunedPlan, env_capacity, plan_key

_DEF_KINDS = ("fft", "fft", "fft")
TUNING_MODES = ("off", "heuristic", "auto")
DTYPES = (torch.complex64, torch.complex128, torch.float32, torch.float64)


def _default_fft_axes(mesh: Mesh, decomp: str, ndim: int) -> Tuple[str, ...]:
    """Pick mesh axes for the pencil/slab/hybrid process grid."""
    names = tuple(mesh.axis_names)
    if decomp == "pencil":
        need = ndim - 1
        if need == 2 and {"data", "model"}.issubset(names):
            return ("data", "model")
        if len(names) < need:
            raise ValueError(
                f"pencil decomposition of {ndim} dims needs a >={need}D "
                f"mesh (consider decomp='hybrid')")
        return names[-need:]
    if decomp == "hybrid":
        if {"data", "model"}.issubset(names):
            extra = tuple(n for n in names if n not in ("data", "model"))
            return ("data", "model") + extra
        return names
    if "model" in names:
        return ("model",)
    return (names[-1],)


def _real_input(kinds: Tuple[str, ...]) -> bool:
    """R2C and R2R pipelines keep real input real."""
    return kinds[0] == "rfft" or any(k in transforms.R2R_KINDS for k in kinds)


def _forward_plan_dtype(x_dtype: torch.dtype,
                        kinds: Tuple[str, ...]) -> torch.dtype:
    """The plan input dtype implied by a forward operand's dtype: R2C and
    R2R pipelines take it as it is; pure-C2C input is promoted to the
    complex dtype of its precision."""
    if _real_input(kinds) or x_dtype.is_complex:
        return x_dtype
    return transforms.complex_dtype(x_dtype)


def _inverse_plan_dtype(y_dtype: torch.dtype,
                        kinds: Tuple[str, ...]) -> torch.dtype:
    """The *forward* plan dtype implied by a spectral operand's dtype:
    real-input pipelines take the real dtype of its precision."""
    if _real_input(kinds):
        return transforms.real_dtype(y_dtype)
    return transforms.complex_dtype(y_dtype)


class DistributedFFT:
    """A reusable distributed FFT plan: plan once, execute many.

    Owns the resolved schedule, the forward and inverse pipeline specs, the
    operand structs and the per-rank pipeline callables.  Construct via
    :func:`plan_fft`.
    """

    def __init__(self, mesh: Mesh, fwd_spec: PipelineSpec,
                 inv_spec: PipelineSpec, *,
                 batch_shape: Tuple[int, ...] = (),
                 dtype: torch.dtype = torch.complex64,
                 tuned: Optional[TunedPlan] = None, tuning: str = "off"):
        self.mesh = mesh
        self._fwd_spec = fwd_spec
        self._inv_spec = inv_spec
        self.batch_shape = tuple(batch_shape)
        self.tuned = tuned
        self.tuning = tuning
        # Wrapper-memoized plans are held by every caller of the wrapper.
        self.shared = False
        self._in_struct = input_struct(mesh, fwd_spec, self.batch_shape,
                                       dtype)
        self._out_struct = output_struct(mesh, fwd_spec, self.batch_shape,
                                         dtype)
        self._inv_in_struct = input_struct(mesh, inv_spec, self.batch_shape,
                                           self._out_struct.dtype)
        self._inv_out_struct = output_struct(mesh, inv_spec,
                                             self.batch_shape,
                                             self._out_struct.dtype)
        self._fns: Dict[bool, Callable] = {
            inv: self._pipeline(inv) for inv in (False, True)}

    def _pipeline(self, inverse: bool) -> Callable:
        spec = self._inv_spec if inverse else self._fwd_spec
        struct = self._inv_in_struct if inverse else self._in_struct
        key = plan_key(kind=spec.kinds, grid=spec.grid, dtype=str(struct.dtype),
                       decomp=(spec.decomp.name,) + tuple(spec.decomp.mesh_axes)
                       + (spec.decomp.dim_groups,),
                       mesh_shape=self.mesh.shape,
                       mesh_axes=self.mesh.axis_names, backend=spec.backend,
                       n_chunks=spec.chunk_schedule, inverse=spec.inverse,
                       # The callable closes over this mesh's process groups
                       # and device, so the mesh object is part of the key.
                       extra=(self.batch_shape, self.mesh))
        return GLOBAL_PLAN_CACHE.get_or_create(
            key, lambda: build_pipeline(self.mesh, spec)).executable

    # -- introspection ------------------------------------------------------

    @property
    def grid(self) -> Tuple[int, ...]:
        return self._fwd_spec.grid

    @property
    def eff_grid(self) -> Tuple[int, ...]:
        return self._fwd_spec.eff_grid

    @property
    def kinds(self) -> Tuple[str, ...]:
        return self._fwd_spec.kinds

    @property
    def decomp(self) -> str:
        return self._fwd_spec.decomp.name

    @property
    def mesh_axes(self) -> Tuple[str, ...]:
        return tuple(self._fwd_spec.decomp.mesh_axes)

    @property
    def backend(self) -> str:
        return self._fwd_spec.backend

    @property
    def n_chunks(self) -> int:
        return self._fwd_spec.n_chunks

    @property
    def chunk_schedule(self) -> Tuple[int, ...]:
        return self._fwd_spec.chunk_schedule

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def dtype(self) -> torch.dtype:
        """Forward input dtype."""
        return self._in_struct.dtype

    @property
    def in_struct(self) -> TensorStruct:
        return self._in_struct

    @property
    def out_struct(self) -> TensorStruct:
        return self._out_struct

    @property
    def inv_in_struct(self) -> TensorStruct:
        return self._inv_in_struct

    @property
    def inv_out_struct(self) -> TensorStruct:
        return self._inv_out_struct

    def pipeline_spec(self, *, inverse: bool = False) -> PipelineSpec:
        return self._inv_spec if inverse else self._fwd_spec

    def describe(self) -> str:
        """Multi-line report: schedule, layouts, and where it came from."""
        tuned_line = (self.tuned.describe() if self.tuned is not None
                      else "untuned")
        decomp = describe_decomp(self.decomp,
                                 self._fwd_spec.decomp.dim_groups)
        name = str(self.dtype).removeprefix("torch.")
        lines = [
            f"DistributedFFT(grid={self.grid}, kinds={self.kinds}, "
            f"batch={self.batch_shape}, dtype={name})",
            f"  mesh: {self.mesh.axis_sizes} on {self.device}",
            f"  schedule: {decomp} over {self.mesh_axes}, "
            f"backend={self.backend}, n_chunks={self.n_chunks} "
            f"(tuning={self.tuning!r})",
            f"  tuner: {tuned_line}",
            f"  in:  {self._in_struct.shape} {self._in_struct.spec} "
            f"local {self._in_struct.local_shape}",
            f"  out: {self._out_struct.shape} {self._out_struct.spec} "
            f"local {self._out_struct.local_shape}",
        ]
        return "\n".join(lines)

    def __repr__(self) -> str:
        return (f"DistributedFFT(grid={self.grid}, kinds={self.kinds}, "
                f"decomp={self.decomp!r}, mesh_axes={self.mesh_axes}, "
                f"backend={self.backend!r}, n_chunks={self.n_chunks})")

    # -- execution ----------------------------------------------------------

    def _execute(self, x: torch.Tensor, *, inverse: bool,
                 sharded_in: bool) -> torch.Tensor:
        struct = self._inv_in_struct if inverse else self._in_struct
        want = struct.local_shape if sharded_in else struct.shape
        if tuple(x.shape) != tuple(want):
            what = "this rank's block " if sharded_in else ""
            raise ValueError(
                f"{'inverse' if inverse else 'forward'} operand has shape "
                f"{tuple(x.shape)}, plan expects {what}{tuple(want)} "
                f"(batch={self.batch_shape}, grid={self.grid})")
        x = x.to(device=self.mesh.device, dtype=struct.dtype)
        if not sharded_in:
            x = local_block(x, struct.spec, self.mesh)
        return self._fns[inverse](x)

    def forward(self, x: torch.Tensor, *,
                sharded_in: bool = False) -> torch.Tensor:
        """Forward transform; returns this rank's output block."""
        return self._execute(x, inverse=False, sharded_in=sharded_in)

    def inverse(self, y: torch.Tensor, *,
                sharded_in: bool = False) -> torch.Tensor:
        """Inverse transform.  A forward output block is already in the
        inverse input layout: ``plan.inverse(plan.forward(x),
        sharded_in=True)`` round-trips."""
        return self._execute(y, inverse=True, sharded_in=sharded_in)

    def __call__(self, x: torch.Tensor, **kw) -> torch.Tensor:
        return self.forward(x, **kw)


def _validate_dim_groups(groups: Tuple[Tuple[int, ...], ...],
                         ndim: int) -> None:
    """Early, specific validation of a hybrid stage grouping."""
    if not groups or any(not g for g in groups):
        raise ValueError(
            f"plan_fft: dim_groups must be non-empty groups of dims, "
            f"got {groups!r}")
    flat = [d for g in groups for d in g]
    if len(set(flat)) != len(flat):
        dupes = sorted({d for d in flat if flat.count(d) > 1})
        raise ValueError(
            f"plan_fft: dim_groups {groups!r} repeat dim(s) {dupes} — "
            f"each dim belongs to exactly one stage group")
    missing = sorted(set(range(ndim)) - set(flat))
    extra = sorted(set(flat) - set(range(ndim)))
    if missing or extra:
        raise ValueError(
            f"plan_fft: dim_groups {groups!r} must cover dims "
            f"0..{ndim - 1} exactly"
            + (f"; missing {missing}" if missing else "")
            + (f"; out of range {extra}" if extra else ""))
    if flat != list(range(ndim)):
        raise ValueError(
            f"plan_fft: dim_groups {groups!r} must be contiguous groups "
            f"in ascending dim order, i.e. flatten to "
            f"{tuple(range(ndim))}")


def plan_fft(mesh: Mesh, grid: Sequence[int], *,
             kinds: Optional[Sequence[str]] = None,
             batch_shape: Sequence[int] = (), dtype=None,
             decomp: Optional[str] = None, backend: Optional[str] = None,
             n_chunks=None,
             mesh_axes: Optional[Sequence[str]] = None,
             dim_groups: Optional[Sequence[Sequence[int]]] = None,
             tuning: str = "off",
             tuned: Optional[TunedPlan] = None) -> DistributedFFT:
    """Build a :class:`DistributedFFT` plan for the trailing ``len(grid)``
    dims of ``batch_shape + grid``-shaped operands on ``mesh``.

    ``dtype`` is the forward input dtype: default complex64 for C2C kinds
    (a real dtype is promoted to the complex dtype of its precision) and
    float32 for R2C/R2R pipelines, which take real input.  ``backend`` is
    one of ``transforms.LOCAL_BACKENDS`` (default ``"cufft"``).
    ``tuned=`` takes the schedule from a :class:`TunedPlan` record instead
    of the knobs.  ``tuning="heuristic"``/``"auto"`` are not ported yet and
    raise ``NotImplementedError``.
    """
    grid = tuple(int(n) for n in grid)
    ndim = len(grid)
    if ndim < 2:
        raise ValueError("plan_fft needs >= 2 transform dims "
                         "(use torch.fft.fft)")
    kinds = tuple(kinds) if kinds is not None else ("fft",) * ndim
    if len(kinds) != ndim:
        raise ValueError(f"plan_fft: {len(kinds)} kinds for ndim={ndim}")
    if tuning not in TUNING_MODES:
        raise ValueError(f"tuning must be one of {TUNING_MODES}, "
                         f"got {tuning!r}")
    if tuning != "off":
        raise NotImplementedError(
            f"tuning={tuning!r} is not ported yet; pass tuning='off' with "
            f"explicit knobs, or a TunedPlan record as tuned=")
    batch_shape = tuple(int(n) for n in batch_shape)
    if dtype is None:
        dtype = torch.float32 if _real_input(kinds) else torch.complex64
    if dtype not in DTYPES:
        raise ValueError(f"plan_fft: dtype must be one of {DTYPES}, "
                         f"got {dtype}")
    dtype = _forward_plan_dtype(dtype, kinds)

    if tuned is not None:
        explicit = [name for name, val in (("decomp", decomp),
                                           ("backend", backend),
                                           ("n_chunks", n_chunks),
                                           ("mesh_axes", mesh_axes),
                                           ("dim_groups", dim_groups))
                    if val is not None]
        if explicit:
            raise ValueError(f"plan_fft: tuned= fixes the schedule; drop "
                             f"{'/'.join(explicit)}")
        decomp, backend = tuned.decomp, tuned.backend
        mesh_axes, dim_groups = tuned.mesh_axes, tuned.dim_groups
        n_chunks = (tuned.chunk_schedule if tuned.chunk_schedule is not None
                    else tuned.n_chunks)
    if decomp is None:
        if dim_groups is not None:
            decomp = "hybrid"
        else:
            decomp = ("pencil" if len(mesh.axis_names) >= ndim - 1
                      else "hybrid")
    if backend is not None and backend not in transforms.LOCAL_BACKENDS:
        raise ValueError(
            f"plan_fft: unknown backend {backend!r}; supported backends: "
            f"{', '.join(transforms.LOCAL_BACKENDS)}")
    backend = backend if backend is not None else "cufft"
    n_chunks = 1 if n_chunks is None else n_chunks
    if dim_groups is not None:
        dim_groups = tuple(tuple(int(d) for d in g) for g in dim_groups)
        if decomp != "hybrid":
            raise ValueError("dim_groups only applies to decomp='hybrid'")
        _validate_dim_groups(dim_groups, ndim)
    axes = (tuple(mesh_axes) if mesh_axes
            else _default_fft_axes(mesh, decomp, ndim))
    if tuned is None:
        sched = None if isinstance(n_chunks, int) else \
            tuple(int(c) for c in n_chunks)
        tuned = TunedPlan(decomp=decomp, mesh_axes=axes, backend=backend,
                          n_chunks=(n_chunks if sched is None
                                    else max(sched, default=1)),
                          predicted_s=0.0, measured_s=0.0, source="default",
                          dim_groups=dim_groups, chunk_schedule=sched)

    dec = make_decomposition(decomp, axes, ndim, dim_groups=dim_groups)
    batch_spec = (None,) * len(batch_shape)
    fwd_spec = make_spec(mesh, grid, dec, kinds, backend=backend,
                         n_chunks=n_chunks, inverse=False,
                         batch_spec=batch_spec)
    validate_grid(dec, fwd_spec.eff_grid, mesh.axis_sizes)
    inv_spec = make_spec(mesh, grid, dec, kinds, backend=backend,
                         n_chunks=n_chunks, inverse=True,
                         batch_spec=batch_spec)
    return DistributedFFT(mesh, fwd_spec, inv_spec, batch_shape=batch_shape,
                          dtype=dtype, tuned=tuned, tuning=tuning)


# ---------------------------------------------------------------------------
# Legacy wrappers: thin, plan-memoizing shims over the plan API.
# ---------------------------------------------------------------------------


def _plan_memo_capacity() -> int:
    return env_capacity("REPRO_TORCH_PLAN_MEMO_SIZE", 64)


_PLAN_MEMO: "OrderedDict[Any, Any]" = OrderedDict()
_PLAN_MEMO_LOCK = threading.Lock()
_MEMO_COUNTERS = {"hits": 0, "misses": 0, "evictions": 0}  # repro-lint: disable=REP004 fixed-key stats counters, not a growing cache


def _memoized(key: Any, factory: Callable[[], Any]) -> Any:
    with _PLAN_MEMO_LOCK:
        obj = _PLAN_MEMO.get(key)
        if obj is not None:
            _PLAN_MEMO.move_to_end(key)
            _MEMO_COUNTERS["hits"] += 1
            return obj
    obj = factory()
    with _PLAN_MEMO_LOCK:
        # Another thread may have raced us; keep the first instance.
        won = _PLAN_MEMO.setdefault(key, obj)
        if won is obj:
            _MEMO_COUNTERS["misses"] += 1
        else:
            _MEMO_COUNTERS["hits"] += 1
        _PLAN_MEMO.move_to_end(key)
        cap = _plan_memo_capacity()
        while len(_PLAN_MEMO) > cap:
            _PLAN_MEMO.popitem(last=False)
            _MEMO_COUNTERS["evictions"] += 1
        return won


def clear_plan_memo() -> None:
    """Drop the wrappers' memoized plans (tests)."""
    with _PLAN_MEMO_LOCK:
        _PLAN_MEMO.clear()
        for k in _MEMO_COUNTERS:
            _MEMO_COUNTERS[k] = 0


def plan_memo_stats() -> Dict[str, int]:
    with _PLAN_MEMO_LOCK:
        return {"plans": len(_PLAN_MEMO),
                "capacity": _plan_memo_capacity(),
                **_MEMO_COUNTERS}


def plan_cache_stats() -> Dict[str, Dict[str, Any]]:
    """Counters of both plan-caching layers: the LRU
    :data:`~.plan.GLOBAL_PLAN_CACHE` of pipeline callables (``compiled``)
    and the wrappers' plan memo (``memo``)."""
    return {"compiled": GLOBAL_PLAN_CACHE.stats(), "memo": plan_memo_stats()}


def _wrapper_plan(mesh: Mesh, grid, kinds, batch_shape, dtype, decomp,
                  backend, n_chunks, mesh_axes, tuning) -> DistributedFFT:
    if n_chunks is not None and not isinstance(n_chunks, int):
        n_chunks = tuple(int(c) for c in n_chunks)  # hashable schedule
    key = ("fft", mesh, tuple(grid), tuple(kinds), tuple(batch_shape),
           dtype, decomp, backend, n_chunks,
           tuple(mesh_axes) if mesh_axes is not None else None, tuning)

    def build() -> DistributedFFT:
        plan = plan_fft(mesh, grid, kinds=kinds, batch_shape=batch_shape,
                        dtype=dtype, decomp=decomp, backend=backend,
                        n_chunks=n_chunks, mesh_axes=mesh_axes, tuning=tuning)
        plan.shared = True
        return plan

    return _memoized(key, build)


def fftnd(x: torch.Tensor, *, mesh: Mesh, ndim: Optional[int] = None,
          decomp: Optional[str] = None,
          kinds: Optional[Sequence[str]] = None,
          backend: Optional[str] = None, n_chunks=None,
          mesh_axes: Optional[Sequence[str]] = None,
          tuning: str = "off") -> torch.Tensor:
    """Distributed forward N-D transform of the trailing ``ndim`` dims of
    the global tensor ``x``; returns this rank's output block.

    Leading ``x.ndim - ndim`` dims are batch dims (replicated).
    """
    ndim = x.dim() if ndim is None else ndim
    if ndim < 2:
        raise ValueError("fftnd needs >= 2 transform dims "
                         "(use torch.fft.fft)")
    if x.dim() < ndim:
        raise ValueError(f"fftnd: ndim={ndim} but input has {x.dim()} dims")
    kinds = tuple(kinds) if kinds is not None else ("fft",) * ndim
    if len(kinds) != ndim:
        raise ValueError(f"fftnd: {len(kinds)} kinds for ndim={ndim}")
    n_batch = x.dim() - ndim
    plan = _wrapper_plan(mesh, tuple(x.shape[n_batch:]), kinds,
                         tuple(x.shape[:n_batch]),
                         _forward_plan_dtype(x.dtype, kinds), decomp,
                         backend, n_chunks, mesh_axes, tuning)
    return plan.forward(x)


def ifftnd(x: torch.Tensor, *, mesh: Mesh, ndim: Optional[int] = None,
           grid: Optional[Tuple[int, ...]] = None,
           decomp: Optional[str] = None,
           kinds: Optional[Sequence[str]] = None,
           backend: Optional[str] = None, n_chunks=None,
           mesh_axes: Optional[Sequence[str]] = None,
           tuning: str = "off") -> torch.Tensor:
    """Inverse of ``fftnd`` on the global spectral tensor ``x``; ``kinds``
    are the FORWARD kinds.  Shares the plan ``fftnd`` memoized.  For R2C
    pipelines pass ``grid``, the real-space grid (the frequency dim of
    ``x`` is padded, so it cannot be inferred)."""
    ndim = (x.dim() if grid is None else len(grid)) if ndim is None else ndim
    if ndim < 2:
        raise ValueError("ifftnd needs >= 2 transform dims "
                         "(use torch.fft.ifft)")
    if x.dim() < ndim:
        raise ValueError(f"ifftnd: ndim={ndim} but input has {x.dim()} dims")
    kinds = tuple(kinds) if kinds is not None else ("fft",) * ndim
    if len(kinds) != ndim:
        raise ValueError(f"ifftnd: {len(kinds)} kinds for ndim={ndim}")
    n_batch = x.dim() - ndim
    logical = tuple(grid) if grid is not None else tuple(x.shape[n_batch:])
    plan = _wrapper_plan(mesh, logical, kinds, tuple(x.shape[:n_batch]),
                         _inverse_plan_dtype(x.dtype, kinds), decomp,
                         backend, n_chunks, mesh_axes, tuning)
    return plan.inverse(x)


def fft2d(x: torch.Tensor, *, mesh: Mesh, **kw) -> torch.Tensor:
    """Distributed forward 2D transform of the trailing two dims of x."""
    return fftnd(x, mesh=mesh, ndim=2, **kw)


def ifft2d(x: torch.Tensor, *, mesh: Mesh, **kw) -> torch.Tensor:
    """Inverse of ``fft2d``."""
    return ifftnd(x, mesh=mesh, ndim=2, **kw)


def fft3d(x: torch.Tensor, *, mesh: Mesh, kinds: Sequence[str] = _DEF_KINDS,
          **kw) -> torch.Tensor:
    """Distributed forward 3D transform of the trailing three dims of x."""
    return fftnd(x, mesh=mesh, ndim=3, kinds=kinds, **kw)


def ifft3d(x: torch.Tensor, *, mesh: Mesh,
           grid: Optional[Tuple[int, int, int]] = None,
           kinds: Sequence[str] = _DEF_KINDS, **kw) -> torch.Tensor:
    """Inverse of ``fft3d``.  ``kinds`` are the FORWARD kinds; R2C
    pipelines need ``grid``, the real-space grid."""
    return ifftnd(x, mesh=mesh, ndim=3, grid=grid, kinds=kinds, **kw)


# ---------------------------------------------------------------------------
# Spectral Poisson solver (Oceananigans-style), on one paired plan.
# ---------------------------------------------------------------------------

def poisson_eigenvalues(n: int, length: float = 2 * np.pi,
                        topology: str = "periodic") -> np.ndarray:
    """Second-order finite-difference spectral eigenvalues
    (Oceananigans-style)."""
    dx = length / n
    i = np.arange(n)
    if topology == "periodic":
        return (2.0 * (np.cos(2.0 * np.pi * i / n) - 1.0)) / dx**2
    # bounded (staggered-grid DCT eigenvalues)
    return (2.0 * (np.cos(np.pi * i / n) - 1.0)) / dx**2


def _poisson_kinds(topology: Sequence[str]) -> Tuple[str, ...]:
    return tuple("fft" if t == "periodic" else "dct2" for t in topology)


class PoissonSolver:
    """Spectral solver for lap(phi) = rhs on a (Periodic|Bounded)^3 box.

    Periodic dims use C2C FFTs; Bounded dims use DCT-II (homogeneous
    Neumann), matching the Oceananigans pressure-solver topologies in paper
    Fig. 8.  One :class:`DistributedFFT` plan serves both directions, and
    the eigenvalue array is built once per dtype and device, as this
    rank's block of the forward output layout.  Only ``tuning="off"`` is
    ported (``plan_fft`` raises for the other modes).  ``solve`` takes the
    global rhs, or this rank's stage-0 block with ``sharded_in=True``, and
    returns this rank's block of phi.
    """

    def __init__(self, mesh: Mesh, grid: Sequence[int], *,
                 topology: Tuple[str, str, str] = ("periodic",) * 3,
                 lengths: Tuple[float, ...] = (2 * np.pi,) * 3,
                 batch_shape: Sequence[int] = (),
                 dtype: torch.dtype = torch.float32,
                 decomp: Optional[str] = None,
                 backend: Optional[str] = None,
                 n_chunks: Optional[int] = None,
                 mesh_axes: Optional[Sequence[str]] = None,
                 tuning: str = "off"):
        grid = tuple(int(n) for n in grid)
        if len(grid) != 3:
            raise ValueError(f"PoissonSolver needs a 3-D grid, got {grid}")
        self.topology = tuple(topology)
        self.lengths = tuple(lengths)
        kinds = _poisson_kinds(self.topology)
        self.plan = plan_fft(mesh, grid, kinds=kinds,
                             batch_shape=batch_shape,
                             dtype=_forward_plan_dtype(dtype, kinds),
                             decomp=decomp, backend=backend,
                             n_chunks=n_chunks, mesh_axes=mesh_axes,
                             tuning=tuning)
        lams = [poisson_eigenvalues(n, l, t)
                for n, l, t in zip(grid, self.lengths, self.topology)]
        lam = (lams[0][:, None, None] + lams[1][None, :, None]
               + lams[2][None, None, :])
        lam[0, 0, 0] = 1.0  # pin the null mode (mean) to zero
        self._lam = lam
        self._lam_dev: Dict[Tuple[torch.dtype, torch.device],
                            torch.Tensor] = {}
        spec = self.plan.out_struct.spec[-3:]
        # Only the rank holding global spectral index (0, 0, 0) zeroes it.
        self._owns_null_mode = all(shard_index(e, mesh)[0] == 0
                                   for e in spec)

    def _lam_for(self, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
        key = (dtype, device)
        lam = self._lam_dev.get(key)
        if lam is None:
            full = torch.from_numpy(self._lam).to(device=device, dtype=dtype)
            lam = local_block(full, self.plan.out_struct.spec[-3:],
                              self.plan.mesh).contiguous()
            self._lam_dev[key] = lam
        return lam

    def describe(self) -> str:
        topo = "x".join(t[0].upper() for t in self.topology)
        return (f"PoissonSolver(topology={topo}, tuning={self.plan.tuning!r})"
                f"\n{self.plan.describe()}")

    def solve(self, rhs: torch.Tensor, *,
              sharded_in: bool = False) -> torch.Tensor:
        """One pressure solve; the null (mean) mode is zeroed per batch
        element and real input comes back real."""
        real_in = not rhs.is_complex()
        xk = self.plan.forward(rhs, sharded_in=sharded_in)
        scaled = xk / self._lam_for(transforms.real_dtype(xk.dtype),
                                    xk.device)
        if self._owns_null_mode:
            # Index only the trailing 3 spectral dims, so every leading
            # batch element is zeroed, not just batch index 0.
            scaled[..., 0, 0, 0] = 0
        phi = self.plan.inverse(scaled, sharded_in=True)
        if real_in and phi.is_complex():
            phi = phi.real
        return phi

    def __call__(self, rhs: torch.Tensor, **kw) -> torch.Tensor:
        return self.solve(rhs, **kw)


def poisson_solve(rhs: torch.Tensor, *, mesh: Mesh,
                  topology: Tuple[str, str, str] = ("periodic",) * 3,
                  lengths: Tuple[float, ...] = (2 * np.pi,) * 3,
                  decomp: Optional[str] = None,
                  backend: Optional[str] = None,
                  n_chunks: Optional[int] = None,
                  mesh_axes: Optional[Sequence[str]] = None,
                  tuning: str = "off") -> torch.Tensor:
    """Solve lap(phi) = rhs spectrally; thin wrapper over PoissonSolver.

    Leading dims of the global ``rhs`` beyond the trailing 3 are batch
    dims.  Builds (and memoizes, per topology/geometry) a
    :class:`PoissonSolver`, so repeated solves share one paired plan and
    one eigenvalue array; returns this rank's block of phi.
    """
    grid = tuple(rhs.shape[-3:])
    batch_shape = tuple(rhs.shape[:-3])
    dtype = _forward_plan_dtype(rhs.dtype, _poisson_kinds(topology))
    if n_chunks is not None and not isinstance(n_chunks, int):
        n_chunks = tuple(int(c) for c in n_chunks)  # hashable schedule
    key = ("poisson", mesh, grid, tuple(topology), tuple(lengths),
           batch_shape, dtype, decomp, backend, n_chunks,
           tuple(mesh_axes) if mesh_axes is not None else None, tuning)

    def build() -> PoissonSolver:
        solver = PoissonSolver(
            mesh, grid, topology=topology, lengths=lengths,
            batch_shape=batch_shape, dtype=dtype, decomp=decomp,
            backend=backend, n_chunks=n_chunks, mesh_axes=mesh_axes,
            tuning=tuning)
        solver.plan.shared = True
        return solver

    return _memoized(key, build).solve(rhs)
