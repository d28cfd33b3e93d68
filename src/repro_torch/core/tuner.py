"""Plan autotuner: the runtime picks the schedule (the paper's thesis).

The port's counterpart of the JAX package's ``core/tuner.py``.  The static
defaults (``decomp="pencil"``, ``backend="cufft"``, ``n_chunks=1``) are the
knobs the paper argues a runtime should choose; :func:`tune` chooses them
for one problem key (global grid, mesh geometry, transform kinds, dtype,
batch shape):

1. **enumerate** candidate plans — decomposition in {pencil, slab, hybrid}
   over every mesh-axis ordering that divides the grid, backend in
   {cufft, matmul, kernel}, ``n_chunks`` in powers of two up to the chunk
   dim's size, plus for multi-hop plans the per-hop chunk schedule the
   scheduler's policy engine proposes (``scheduler.choose_chunk_schedule``);
2. **prune** them with the LogP/roofline model
   (``perfmodel.predict_plan_time``) down to the ``top_k`` survivors;
3. **measure** each survivor (always with the static default as the
   baseline, so the winner never regresses it);
4. **record** the winner in the persistent JSON ``TuningCache``, which
   later processes read instead of searching.

``tuning="heuristic"`` stops after 2 (no timing, no disk writes; it may
read a stored calibration profile); ``tuning="auto"`` runs all four.

**Calibration.**  With ``machine=None`` the model's constants come from
:func:`resolve_profile`: a profile stored in the wisdom file's
``"machine"`` section, or (in auto mode) one measured by
``perfmodel.calibrate`` and stored.  ``REPRO_CALIBRATE=off`` skips
calibration and prunes with the model defaults.

**Ranks agree.**  Every rank runs its own copy of this code, so every
decision that could differ between ranks is made once: rank 0's cache hit
and rank 0's profile are broadcast (``broadcast_object_list``), measured
times are the ``MAX`` over the mesh's ranks after a barrier, and only rank
0 writes the wisdom file — the others reload it after a barrier.  (Rank 0
is the mesh's first rank: a degraded mesh may span a subset of the world,
and its collectives run on its own process group.)  Ranks
that disagreed would issue different collectives and hang.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..compat import Mesh
from .decomp import describe_decomp, make_decomposition, validate_grid
from .perfmodel import (MachineProfile, _calibrate_network, _time_best,
                        as_profile, calibrate, default_machine,
                        hop_cost_terms, platform_name, predict_plan_time,
                        profile_from_machine, stage_comp_times)
from .pipeline import (PipelineSpec, TensorStruct, build_pipeline,
                       chunk_sites, effective_grid, input_struct,
                       make_spec)
from .plan import (TunedPlan, TuningCache, global_tuning_cache,
                   parse_tuning_key, tuning_key)
from .scheduler import choose_chunk_schedule
from .transforms import LOCAL_BACKENDS

#: The tuner's backend space (``transforms.LOCAL_BACKENDS``).
BACKENDS = LOCAL_BACKENDS
OBJECTIVES = ("forward", "fwd+scale+inv")


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the tuner's search space."""

    decomp: str
    mesh_axes: Tuple[str, ...]
    backend: str
    n_chunks: int
    # Stage grouping for decomp="hybrid" (None for pencil/slab).
    dim_groups: Optional[Tuple[Tuple[int, ...], ...]] = None
    # Per-hop chunk schedule (forward hop order); None = uniform n_chunks.
    chunk_schedule: Optional[Tuple[int, ...]] = None

    @property
    def spec_chunks(self):
        """What ``make_spec(n_chunks=...)`` should receive."""
        return (self.chunk_schedule if self.chunk_schedule is not None
                else self.n_chunks)

    def describe(self) -> str:
        decomp = describe_decomp(self.decomp, self.dim_groups)
        chunks = (",".join(map(str, self.chunk_schedule))
                  if self.chunk_schedule is not None else str(self.n_chunks))
        return (f"{decomp}({','.join(self.mesh_axes)})/"
                f"{self.backend}/chunks={chunks}")


# ---------------------------------------------------------------------------
# Rank agreement
# ---------------------------------------------------------------------------

def _multi_rank(mesh: Optional[Mesh]) -> bool:
    return (mesh is not None and mesh.size > 1 and dist.is_available()
            and dist.is_initialized())


def _is_rank0(mesh: Optional[Mesh]) -> bool:
    """Whether this rank decides for the mesh (its first rank)."""
    return not _multi_rank(mesh) or dist.get_rank() == mesh.root


def _from_rank0(obj: Any, mesh: Optional[Mesh]) -> Any:
    """The mesh's first rank's ``obj`` on every rank of the mesh (identity
    on one rank)."""
    if not _multi_rank(mesh):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=mesh.root, group=mesh.group)
    return box[0]


def _barrier(mesh: Optional[Mesh]) -> None:
    if _multi_rank(mesh):
        dist.barrier(group=mesh.group)


# ---------------------------------------------------------------------------
# The machine profile
# ---------------------------------------------------------------------------

# (platform, mesh-axis name) pairs whose all_to_all terms this process
# already tried to measure: recalibration runs at most once per process per
# axis when the network terms stay unmeasurable.
_NET_UPGRADE_ATTEMPTED: set = set()


def resolve_profile(cache: Optional[TuningCache] = None, *,
                    mesh: Optional[Mesh] = None, device=None,
                    allow_calibrate: bool = True,
                    **calibrate_kw) -> MachineProfile:
    """The calibrated :class:`MachineProfile` of this platform, the same on
    every rank.

    Resolution order (decided on rank 0): ``REPRO_CALIBRATE=off`` -> model
    defaults (``calibrated=False``); a profile stored in ``cache``'s
    ``"machine"`` section -> that profile; otherwise calibrate (when
    ``allow_calibrate``) and store it.  A stored profile that lacks this
    mesh's measurable axes is upgraded with the all_to_all benchmarks only.
    Every rank takes part in the measurements (they are collectives) and
    then receives rank 0's profile; only rank 0 writes ``cache``.
    ``calibrate_kw`` goes to ``perfmodel.calibrate`` (tests inject a
    ``timer``).
    """
    from ..compat import resolve_device
    dev = mesh.device if mesh is not None else resolve_device(device)
    platform = platform_name(dev)
    defaults = profile_from_machine(default_machine(dev), platform=platform)
    env = os.environ.get("REPRO_CALIBRATE", "auto").strip().lower()
    if env == "off":
        return defaults
    action: Tuple[str, Optional[MachineProfile]] = ("calibrate", None)
    if _is_rank0(mesh):
        multidev_axes = ({n for n, s in mesh.axis_sizes.items() if s > 1}
                         if mesh is not None else set())
        stored = None
        raw = cache.get_machine(platform) if cache is not None else None
        if raw is not None:
            try:
                stored = MachineProfile.from_json(raw)
            except (KeyError, TypeError, ValueError):
                stored = None  # unreadable profile: recalibrate below
        pending = set()
        if stored is not None:
            uncovered = multidev_axes - set(dict(stored.net_alpha_s))
            pending = {ax for ax in uncovered
                       if (platform, ax) not in _NET_UPGRADE_ATTEMPTED}
        if stored is not None and not (allow_calibrate and pending):
            action = ("stored", stored)
        elif not allow_calibrate:
            action = ("defaults", None)
        else:
            _NET_UPGRADE_ATTEMPTED.update((platform, ax)
                                          for ax in multidev_axes)
            action = ("upgrade", stored) if stored is not None \
                else ("calibrate", None)
    kind, stored = _from_rank0(action, mesh)
    if kind == "stored":
        return stored
    if kind == "defaults":
        return defaults
    if kind == "upgrade":
        # Only the per-axis network terms are missing: rerunning the
        # compute benchmarks would overwrite them with noisier ones.
        alpha_new, bw_new = _calibrate_network(
            mesh, calibrate_kw.get("timer"), calibrate_kw.get("repeats", 3))
        alpha = dict(stored.net_alpha_s)
        alpha.update(alpha_new)
        bw = dict(stored.net_bw)
        bw.update(bw_new)
        prof = dataclasses.replace(
            stored, net_alpha_s=tuple(sorted(alpha.items())),
            net_bw=tuple(sorted(bw.items())), net_calibrated=bool(alpha))
    else:
        prof = calibrate(mesh=mesh, device=dev, platform=platform,
                         **calibrate_kw)
    prof = _from_rank0(prof, mesh)
    if cache is not None:
        cache.put_machine(platform, prof.to_json(), save=_is_rank0(mesh))
    _barrier(mesh)
    return prof


# ---------------------------------------------------------------------------
# The search space
# ---------------------------------------------------------------------------

def _spec_for(mesh: Mesh, grid: Tuple[int, ...], cand_decomp: str,
              mesh_axes: Tuple[str, ...], kinds: Tuple[str, ...],
              backend: str, n_chunks, inverse: bool, n_batch: int,
              dim_groups=None) -> PipelineSpec:
    """``n_chunks`` is an int or a per-hop schedule (forward hop order)."""
    dec = make_decomposition(cand_decomp, mesh_axes, len(grid),
                             dim_groups=dim_groups)
    return make_spec(mesh, grid, dec, kinds, backend=backend,
                     n_chunks=n_chunks, inverse=inverse,
                     batch_spec=(None,) * n_batch)


def feasible_chunk_counts(spec: PipelineSpec, axis_sizes: Dict[str, int],
                          batch_shape: Tuple[int, ...] = (),
                          max_chunks: Optional[int] = None) -> List[int]:
    """Powers of two that evenly chunk every redistribution of ``spec``
    (at each hop's ``pipeline.chunk_sites`` dim); at least ``[1]``."""
    sizes = []
    for d, size in chunk_sites(spec, axis_sizes):
        if d is None:
            return [1]  # some hop has no legal chunk dim: bulk only
        if size is None:
            if d >= len(batch_shape):
                return [1]  # batch extent unknown: don't guess
            sizes.append(batch_shape[d])
        else:
            sizes.append(size)
    counts = [1]
    n = 2
    cap = min(sizes) if sizes else 1
    if max_chunks is not None:
        cap = min(cap, max_chunks)
    while n <= cap and all(s % n == 0 for s in sizes):
        counts.append(n)
        n *= 2
    return counts


def feasible_hop_chunk_counts(spec: PipelineSpec,
                              axis_sizes: Dict[str, int],
                              batch_shape: Tuple[int, ...] = (),
                              max_chunks: Optional[int] = None
                              ) -> List[List[int]]:
    """Per executed hop: the powers of two that evenly chunk that hop; a
    hop with no legal chunk dim contributes ``[1]`` without forcing the
    others bulk."""
    out: List[List[int]] = []
    for d, size in chunk_sites(spec, axis_sizes):
        if d is None:
            out.append([1])
            continue
        if size is None:
            if d >= len(batch_shape):
                out.append([1])  # batch extent unknown: don't guess
                continue
            size = batch_shape[d]
        counts = [1]
        n = 2
        cap = size if max_chunks is None else min(size, max_chunks)
        while n <= cap and size % n == 0:
            counts.append(n)
            n *= 2
        out.append(counts)
    return out


def propose_chunk_schedule(spec: PipelineSpec, axis_sizes: Dict[str, int],
                           machine, *, backend: Optional[str] = None,
                           dtype_bytes: int = 8,
                           batch_shape: Tuple[int, ...] = (),
                           max_chunks: Optional[int] = None,
                           dtype: Optional[torch.dtype] = None
                           ) -> Tuple[int, ...]:
    """The policy engine's per-hop chunk schedule for ``spec``: the Eq. 7
    argmin per hop (``scheduler.choose_chunk_schedule``) over each hop's
    feasible counts, from ``perfmodel.hop_cost_terms``.  Returned in
    **forward hop order**, whatever the spec's direction."""
    prof = as_profile(machine)
    backend = backend or spec.backend
    cands = feasible_hop_chunk_counts(spec, axis_sizes, batch_shape,
                                      max_chunks)
    stage_t = stage_comp_times(spec.grid, spec.decomp, axis_sizes, prof,
                               backend=backend, dtype_bytes=dtype_bytes,
                               kinds=spec.kinds, eff_grid=spec.eff_grid,
                               dtype=dtype)
    terms = hop_cost_terms(spec.grid, spec.decomp, axis_sizes, prof,
                           backend=backend, dtype_bytes=dtype_bytes,
                           kinds=spec.kinds, eff_grid=spec.eff_grid,
                           stage_times=stage_t)
    if spec.inverse:
        # Executed hop j inverts forward hop H-1-j and feeds forward stage
        # H-1-j, whose time is the *previous* forward stage's.
        fwd = terms[::-1]
        terms = [(stage_t[len(terms) - 1 - j],) + tuple(fwd[j][1:])
                 for j in range(len(fwd))]
    sched = choose_chunk_schedule(terms, cands, overlap_floor=prof.overlap)
    return sched if not spec.inverse else sched[::-1]


def _hybrid_groupings(ndim: int, n_axes: int
                      ) -> List[Tuple[Tuple[int, ...], ...]]:
    """Contiguous stage groupings a hybrid over ``n_axes`` axes can run:
    every composition of the dims into ``g`` ordered groups for
    ``2 <= g <= min(ndim, n_axes + 1)``."""
    out: List[Tuple[Tuple[int, ...], ...]] = []
    for g in range(2, min(ndim, n_axes + 1) + 1):
        for cuts in itertools.combinations(range(1, ndim), g - 1):
            bounds = (0,) + cuts + (ndim,)
            out.append(tuple(tuple(range(bounds[i], bounds[i + 1]))
                             for i in range(g)))
    return out


def enumerate_candidates(grid: Tuple[int, ...], mesh: Mesh,
                         kinds: Tuple[str, ...], *, inverse: bool = False,
                         n_batch: int = 0,
                         batch_shape: Tuple[int, ...] = (),
                         backends: Sequence[str] = BACKENDS,
                         max_chunks: Optional[int] = None,
                         machine=None, dtype_bytes: int = 8,
                         dtype: Optional[torch.dtype] = None
                         ) -> List[Candidate]:
    """All valid plans for this (grid, mesh, kinds) problem.

    Mesh-axis orderings are part of the space (``validate_grid`` filters
    those that do not divide the grid); hybrids cover every contiguous
    stage grouping over every ordering of the full axis pool, minus the
    groupings that are structurally the pencil or the slab.  With
    ``machine``, every multi-hop point and backend also gets the policy
    engine's per-hop schedule (:func:`propose_chunk_schedule`) when it is
    not uniform.
    """
    ndim = len(grid)
    names = tuple(mesh.axis_names)
    axis_sizes = mesh.axis_sizes
    # 2-D pencil and 2-D slab are the same two-stage structure; keep one.
    decomp_arity = [("pencil", ndim - 1)]
    if ndim > 2:
        decomp_arity.append(("slab", 1))
    points: List[Tuple[str, Tuple[str, ...], Optional[Tuple]]] = []
    for decomp_kind, arity in decomp_arity:
        for axes in itertools.permutations(names, arity):
            points.append((decomp_kind, axes, None))
    for groups in _hybrid_groupings(ndim, len(names)):
        g = len(groups)
        if g == ndim and len(names) == ndim - 1:
            continue  # structurally the pencil: one axis per boundary
        if g == 2 and len(names) == 1 and len(groups[-1]) == 1:
            continue  # structurally the slab over the single axis
        for axes in itertools.permutations(names, len(names)):
            points.append(("hybrid", axes, groups))
    out: List[Candidate] = []
    for decomp_kind, axes, groups in points:
        try:
            spec = _spec_for(mesh, grid, decomp_kind, axes, kinds,
                             "cufft", 1, inverse, n_batch, dim_groups=groups)
            validate_grid(spec.decomp, spec.eff_grid, axis_sizes)
        except (ValueError, KeyError):
            continue
        chunk_counts = feasible_chunk_counts(
            spec, axis_sizes, batch_shape, max_chunks)
        for n_chunks in chunk_counts:
            for backend in backends:
                out.append(Candidate(decomp=decomp_kind, mesh_axes=axes,
                                     backend=backend, n_chunks=n_chunks,
                                     dim_groups=groups))
        if machine is not None and len(spec.decomp.redists) > 1:
            for backend in backends:
                sched = propose_chunk_schedule(
                    spec, axis_sizes, machine, backend=backend,
                    dtype_bytes=dtype_bytes, batch_shape=batch_shape,
                    max_chunks=max_chunks, dtype=dtype)
                if len(set(sched)) > 1:
                    out.append(Candidate(decomp=decomp_kind, mesh_axes=axes,
                                         backend=backend,
                                         n_chunks=max(sched),
                                         dim_groups=groups,
                                         chunk_schedule=sched))
    return out


def rank_candidates(cands: Sequence[Candidate], grid: Tuple[int, ...],
                    mesh: Mesh, machine, dtype_bytes: int = 8,
                    kinds: Optional[Sequence[str]] = None,
                    dtype: Optional[torch.dtype] = None
                    ) -> List[Tuple[float, Candidate]]:
    """(predicted seconds, candidate), cheapest first (a stable sort, so
    ties keep enumeration order) — the pruning pass.  With ``kinds`` each
    candidate is priced on its own R2C-padded grid; every candidate is
    priced hop by hop (a uniform count is the constant schedule)."""
    axis_sizes = mesh.axis_sizes
    kinds = tuple(kinds) if kinds is not None else None
    ranked = []
    for cand in cands:
        dec = make_decomposition(cand.decomp, cand.mesh_axes, len(grid),
                                 dim_groups=cand.dim_groups)
        eff = (effective_grid(grid, dec, axis_sizes, kinds)
               if kinds is not None else None)
        sched = (cand.chunk_schedule if cand.chunk_schedule is not None
                 else (cand.n_chunks,) * len(dec.redists))
        pred = predict_plan_time(grid, dec, axis_sizes, machine,
                                 backend=cand.backend,
                                 n_chunks=cand.n_chunks,
                                 dtype_bytes=dtype_bytes,
                                 kinds=kinds, eff_grid=eff,
                                 chunk_schedule=sched, dtype=dtype)
        ranked.append((pred["t_total_s"], cand))
    ranked.sort(key=lambda t: t[0])
    return ranked


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

def synth_input(arg: TensorStruct, device, seed: int = 0) -> torch.Tensor:
    """This rank's block of a measurement operand, drawn on ``device`` from
    a seeded ``torch.Generator``: genuinely complex data for complex
    operands (a zero imaginary plane could be favoured), real data in the
    real dtype otherwise."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(arg.local_shape, dtype=arg.dtype, device=device,
                       generator=gen)


def _objective_fn(cand: Candidate, grid, mesh: Mesh, kinds, dtype, *,
                  inverse: bool, batch_shape: Tuple[int, ...],
                  objective: str):
    """The callable one measurement times: the candidate's pipeline on a
    synthesized operand, or the paired forward / spectral scale / inverse
    round trip a PoissonSolver runs."""
    spec = _spec_for(mesh, grid, cand.decomp, cand.mesh_axes, kinds,
                     cand.backend, cand.spec_chunks, inverse,
                     len(batch_shape), dim_groups=cand.dim_groups)
    fn = build_pipeline(mesh, spec)
    arg = input_struct(mesh, spec, batch_shape, dtype)
    x = synth_input(arg, mesh.device)
    if objective != "fwd+scale+inv":
        return lambda: fn(x)
    inv_spec = _spec_for(mesh, grid, cand.decomp, cand.mesh_axes, kinds,
                         cand.backend, cand.spec_chunks, not inverse,
                         len(batch_shape), dim_groups=cand.dim_groups)
    inv = build_pipeline(mesh, inv_spec)
    return lambda: inv(fn(x) * 0.5)


def measure_candidate(cand: Candidate, grid: Tuple[int, ...], mesh: Mesh,
                      kinds: Tuple[str, ...], dtype, *,
                      inverse: bool = False,
                      batch_shape: Tuple[int, ...] = (),
                      repeats: int = 3,
                      objective: str = "forward") -> float:
    """Seconds of one candidate: best of ``repeats`` after a warm-up call
    (which takes the kernel's first-use build), the same on every rank.

    On CUDA each call is timed with CUDA events.  On a multi-rank mesh the
    ranks barrier after the warm-up, time, and take the ``MAX`` over the
    mesh's ranks, so every rank ranks candidates on the same numbers.
    ``objective="fwd+scale+inv"`` times the paired round trip.
    """
    call = _objective_fn(cand, grid, mesh, kinds, dtype, inverse=inverse,
                         batch_shape=tuple(batch_shape), objective=objective)
    device = mesh.device
    call()
    _barrier(mesh)
    t = _time_best(call, repeats, device)
    if _multi_rank(mesh):
        on = device if dist.get_backend() == "nccl" else torch.device("cpu")
        box = torch.tensor([t], dtype=torch.float64, device=on)
        dist.all_reduce(box, op=dist.ReduceOp.MAX, group=mesh.group)
        t = float(box.item())
    return t


def _default_candidate(cands: Sequence[Candidate]) -> Optional[Candidate]:
    """The plan the static API would have used (baseline to never regress):
    pencil, cufft, bulk."""
    for cand in cands:
        if cand.backend == "cufft" and cand.n_chunks == 1 \
                and cand.decomp == "pencil":
            return cand
    return cands[0] if cands else None


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def resolve_tuned_plan(grid: Sequence[int], mesh: Mesh, *,
                       kinds: Optional[Sequence[str]] = None,
                       dtype=torch.complex64, inverse: bool = False,
                       batch_shape: Sequence[int] = (), mode: str = "off",
                       cache: Optional[TuningCache] = None,
                       default: Optional[Candidate] = None,
                       objective: str = "forward",
                       backends: Sequence[str] = BACKENDS) -> TunedPlan:
    """One :class:`TunedPlan` per tuning policy — the plan API's entry.

    ``mode="off"`` wraps the caller's explicit ``default`` candidate in a
    ``source="default"`` plan (no search, no disk); ``"heuristic"`` and
    ``"auto"`` delegate to :func:`tune` (over ``backends``).
    """
    if mode == "off":
        if default is None:
            raise ValueError("resolve_tuned_plan(mode='off') needs a "
                             "default Candidate")
        return TunedPlan(decomp=default.decomp,
                         mesh_axes=tuple(default.mesh_axes),
                         backend=default.backend, n_chunks=default.n_chunks,
                         predicted_s=0.0, measured_s=0.0, source="default",
                         dim_groups=default.dim_groups,
                         chunk_schedule=default.chunk_schedule)
    return tune(grid, mesh, kinds=kinds, dtype=dtype, inverse=inverse,
                batch_shape=batch_shape, mode=mode, cache=cache,
                objective=objective, backends=backends)


def backend_restriction(backends: Sequence[str]) -> Tuple[str, ...]:
    """The tuning key's name for a search over ``backends``: ``()`` when
    they cover every local backend, else the covered ones in
    ``BACKENDS`` order."""
    chosen = tuple(b for b in BACKENDS if b in backends)
    return () if len(chosen) == len(BACKENDS) else chosen


def tune(grid: Sequence[int], mesh: Mesh, *,
         kinds: Optional[Sequence[str]] = None, dtype=torch.complex64,
         inverse: bool = False, batch_shape: Sequence[int] = (),
         mode: str = "auto", cache: Optional[TuningCache] = None,
         machine=None, top_k: int = 3,
         backends: Sequence[str] = BACKENDS,
         max_chunks: Optional[int] = None, repeats: int = 3,
         objective: str = "forward") -> TunedPlan:
    """Pick the best plan for one problem key; see the module docstring.

    ``mode="auto"``       enumerate -> prune -> measure top_k -> persist.
    ``mode="heuristic"``  model-only argmin; no timing, no disk writes.

    ``dtype`` is the plan's forward input dtype.  ``objective=
    "fwd+scale+inv"`` measures the paired round trip under its own wisdom
    key.  A search over some of the ``backends`` reads and writes a key of
    its own (``tuning_key``'s ``be=`` part), so a restricted winner never
    shadows the plan an unrestricted caller would get; a search capped by
    ``max_chunks`` is not persisted.
    """
    grid = tuple(grid)
    batch_shape = tuple(batch_shape)
    kinds = tuple(kinds) if kinds is not None else ("fft",) * len(grid)
    if mode not in ("auto", "heuristic"):
        raise ValueError(f"tune mode must be auto|heuristic, got {mode!r}")
    if objective not in OBJECTIVES:
        raise ValueError(f"tune objective must be one of {OBJECTIVES}, "
                         f"got {objective!r}")
    platform = platform_name(mesh.device)

    key = tuning_key(grid=grid, mesh_shape=mesh.shape,
                     mesh_axes=mesh.axis_names, kinds=kinds,
                     dtype=_dtype_name(dtype), inverse=inverse,
                     batch_shape=batch_shape, platform=platform,
                     op="fft" if objective == "forward" else objective,
                     backends=backend_restriction(backends))
    if mode == "auto":
        if cache is None:
            cache = global_tuning_cache()
        hit = cache.get(key) if _is_rank0(mesh) else None
        # A cached plan must also satisfy this call's restrictions.
        if hit is not None and not (hit.backend in backends and (
                max_chunks is None or hit.n_chunks <= max_chunks)):
            hit = None
        hit = _from_rank0(hit, mesh)
        if hit is not None:
            return hit

    if machine is None:
        # Heuristic mode stays measurement-free but reads a stored profile
        # (an empty TuningCache is falsy, hence no `cache or ...`).
        profile_cache = cache if cache is not None else global_tuning_cache()
        machine = resolve_profile(profile_cache, mesh=mesh,
                                  allow_calibrate=(mode == "auto"))
    dtype_bytes = dtype.itemsize
    cands = enumerate_candidates(grid, mesh, kinds, inverse=inverse,
                                 n_batch=len(batch_shape),
                                 batch_shape=batch_shape, backends=backends,
                                 max_chunks=max_chunks, machine=machine,
                                 dtype_bytes=dtype_bytes, dtype=dtype)
    if not cands:
        raise ValueError(f"no valid plan for grid {grid} on mesh "
                         f"{mesh.axis_sizes}")
    ranked = rank_candidates(cands, grid, mesh, machine, dtype_bytes,
                             kinds=kinds, dtype=dtype)

    if mode == "heuristic":
        pred, best = ranked[0]
        return TunedPlan(decomp=best.decomp, mesh_axes=best.mesh_axes,
                         backend=best.backend, n_chunks=best.n_chunks,
                         predicted_s=pred, measured_s=0.0,
                         source="heuristic", dim_groups=best.dim_groups,
                         chunk_schedule=best.chunk_schedule,
                         objective=objective)

    survivors = [c for _, c in ranked[:max(top_k, 1)]]
    baseline = _default_candidate(cands)
    if baseline is not None and baseline not in survivors:
        survivors.append(baseline)
    predicted = {c: p for p, c in ranked}
    best_cand, best_time, baseline_time = None, float("inf"), 0.0
    for cand in survivors:
        t = measure_candidate(cand, grid, mesh, kinds, dtype,
                              inverse=inverse, batch_shape=batch_shape,
                              repeats=repeats, objective=objective)
        if cand == baseline:
            baseline_time = t
        if t < best_time:
            best_cand, best_time = cand, t
    plan = TunedPlan(decomp=best_cand.decomp, mesh_axes=best_cand.mesh_axes,
                     backend=best_cand.backend, n_chunks=best_cand.n_chunks,
                     predicted_s=predicted.get(best_cand, 0.0),
                     measured_s=best_time, source="measured",
                     baseline_s=baseline_time,
                     ts=_from_rank0(time.time(), mesh),
                     dim_groups=best_cand.dim_groups,
                     chunk_schedule=best_cand.chunk_schedule,
                     objective=objective)
    if max_chunks is None:
        # Rank 0 writes the file; the others read it after the barrier.
        if _is_rank0(mesh):
            cache.put(key, plan)
        _barrier(mesh)
        if not _is_rank0(mesh):
            if cache.path is not None:
                cache.reload()
            else:
                cache.put(key, plan, save=False)
    return plan


# ---------------------------------------------------------------------------
# Warm start (the serving layer)
# ---------------------------------------------------------------------------

def warm_candidates(cache: TuningCache, mesh: Mesh, *,
                    platform: Optional[str] = None,
                    ops: Sequence[str] = ("fft",),
                    backends: Sequence[str] = BACKENDS
                    ) -> List[Dict[str, object]]:
    """Persisted tuning decisions this process could serve warm.

    Enumerates the wisdom file's keys (``TuningCache.items`` +
    ``parse_tuning_key``) and keeps those matching this ``platform``
    (default: the mesh device's, ``perfmodel.platform_name``) and ``mesh``
    geometry (shape *and* axis names — a plan tuned on a (2, 4) mesh is not
    the plan for a (4, 2) one) whose measured ``op`` is in ``ops`` and
    whose search covered the same ``backends`` (``tune``'s key).  Each
    returned dict is the parsed problem plus its ``"tuned"``
    :class:`TunedPlan` and its ``"key"``: everything ``plan_fft`` needs to
    rebuild the winning plan without a measurement.  Unreadable keys
    (other schema versions) are skipped: warm start must never be blocked
    by foreign wisdom.
    """
    platform = platform if platform is not None \
        else platform_name(mesh.device)
    restriction = backend_restriction(backends)
    out: List[Dict[str, object]] = []
    for key, tuned in cache.items():
        prob = parse_tuning_key(key)
        if prob is None or prob["platform"] != platform:
            continue
        if prob["mesh_shape"] != tuple(mesh.shape) \
                or prob["mesh_axes"] != tuple(mesh.axis_names):
            continue
        if prob["op"] not in ops or prob["inverse"]:
            continue
        if prob.get("backends", ()) != restriction:
            continue
        prob["tuned"] = tuned
        prob["key"] = key
        out.append(prob)
    return out
