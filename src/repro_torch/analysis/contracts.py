"""Static sharding-contract checks for built plans.

The port's counterpart of the JAX package's ``analysis/contracts.py``.

``pipeline.segment_in_spec(j+1)`` and ``pipeline.segment_out_spec(j)``
both read the same declared ``StageLayout``, so comparing them can never
catch a corrupted layout chain.  This pass re-derives each boundary
independently: starting from stage ``j``'s declared spec it **replays
hop ``j``'s moves** exactly the way the sequential ``all_to_all``s
execute them (the axis is peeled off the minor end of its source dim's
tuple; the receiving dim appends it in arrival order) and compares the
result against stage ``j+1``'s declared spec.  The other contracts the
runtime silently relies on get the same treatment:

* **CON001** — boundary layout mismatch (hop replay != declared spec,
  an axis peeled from a dim that does not hold it, or out of minor-first
  order);
* **CON002** — a ``chunk_schedule`` entry that cannot divide its hop's
  chunk-dim block (``pipeline.chunk_sites``), a schedule of the wrong
  length, or a non-positive entry;
* **CON003** — a grid dim not divisible by the mesh-axis product that
  shards it in some stage (``decomp.validate_grid`` as diagnostics, on
  the effective grid the pipeline actually moves);
* **CON004** — plan-key collisions: two distinct callables a plan
  would build landing on one ``GLOBAL_PLAN_CACHE`` key, two distinct
  wisdom-key strings parsing to the same tuning problem (the port's
  ``be=`` part, ``tuning.backend_restriction``, is part of the problem:
  a kernel-restricted search and an unrestricted one are two problems),
  or distinct in-memory cache keys aliasing on their string rendering
  (the port's keys hold the :class:`~repro_torch.compat.Mesh` they were
  built for, compared by identity, so a mesh renders with its identity
  too: two meshes of one shape are two keys by design);
* **CON005** — wisdom keys this version cannot parse (warning: they are
  skipped by warm-start, which is usually stale foreign wisdom, not a
  bug).

Entry points: :func:`check_plan` (one ``DistributedFFT``, both
directions, plus its prospective key audit) and :func:`audit_plan_keys`
(cache-wide).  Wired to ``DistributedFFT.verify()`` and
``plan_fft(validate=)``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..compat import Mesh
from ..core.api import _plan_memo_keys
from ..core.decomp import axis_product, spec_axes
from ..core.pipeline import PipelineSpec, chunk_sites, pipeline_key
from ..core.plan import GLOBAL_PLAN_CACHE, parse_tuning_key
from .diagnostics import Diagnostic, DiagnosticReport


# -- CON001: boundary replay -------------------------------------------------

def replay_hop(start_spec: Sequence, hop, *, where: str,
               report: DiagnosticReport) -> Optional[Tuple]:
    """Apply one hop's moves to a stage spec the way the collectives do.

    Returns the resulting spec (entries as axis tuples) or None after
    reporting a CON001 (a move whose axis is not on its source dim, or
    not that dim's minor axis — sequential tiled ``all_to_all``s only
    reproduce a clean block layout peeling minor-first).
    """
    cur: List[Tuple[str, ...]] = [spec_axes(e) for e in start_spec]
    for m in hop.moves:
        src = cur[m.concat_dim]
        if m.mesh_axis not in src:
            report.add(Diagnostic(
                code="CON001", severity="error",
                message=(f"{where}: move over mesh axis {m.mesh_axis!r} "
                         f"gathers dim {m.concat_dim}, but that dim is "
                         f"sharded over {src!r} (axis not present)"),
                hint="the hop's moves disagree with the stage layouts; "
                     "rebuild the decomposition (hybrid_nd keeps them "
                     "consistent)",
                plan_key=where))
            return None
        if src[-1] != m.mesh_axis:
            report.add(Diagnostic(
                code="CON001", severity="error",
                message=(f"{where}: move over mesh axis {m.mesh_axis!r} "
                         f"peels dim {m.concat_dim} out of order — the "
                         f"dim's minor axis is {src[-1]!r} ({src!r}); "
                         f"sequential all_to_alls must peel minor-first"),
                hint="reorder the hop's moves minor-axis-first",
                plan_key=where))
            return None
        cur[m.concat_dim] = src[:-1]
        cur[m.split_dim] = cur[m.split_dim] + (m.mesh_axis,)
    return tuple(cur)


def check_boundaries(spec: PipelineSpec, *, label: str,
                     report: DiagnosticReport) -> None:
    """CON001 over every segment boundary of one direction's pipeline."""
    stages, redists = spec.stage_order()
    for j, hop in enumerate(redists):
        where = f"{label}/boundary{j}"
        got = replay_hop(stages[j].spec, hop, where=where, report=report)
        if got is None:
            continue
        want = tuple(spec_axes(e) for e in stages[j + 1].spec)
        if got != want:
            report.add(Diagnostic(
                code="CON001", severity="error",
                message=(f"{where}: replaying hop {j}'s moves over stage "
                         f"{j}'s layout yields {got!r}, but stage {j + 1} "
                         f"declares {want!r} — segment {j + 1} would emit "
                         f"a sharding its successor does not expect"),
                hint="segment_out_spec(j) must equal segment_in_spec(j+1) "
                     "as *produced by the hop*, not just as declared; "
                     "rebuild the decomposition",
                plan_key=where))


# -- CON002 / CON003: divisibility -------------------------------------------

def check_chunk_schedule(spec: PipelineSpec, axis_sizes: Dict[str, int], *,
                         label: str, report: DiagnosticReport) -> None:
    stages, redists = spec.stage_order()
    sched = spec.chunk_schedule
    if len(sched) != len(redists):
        report.add(Diagnostic(
            code="CON002", severity="error",
            message=(f"{label}: chunk_schedule has {len(sched)} entries "
                     f"for {len(redists)} hops"),
            hint="one entry per RedistHop, execution order",
            plan_key=label))
        return
    sites = chunk_sites(spec, axis_sizes)
    for i, (c, (d, size)) in enumerate(zip(sched, sites)):
        where = f"{label}/hop{i}"
        if c < 1:
            report.add(Diagnostic(
                code="CON002", severity="error",
                message=f"{where}: chunk count {c} < 1",
                hint="chunk counts are positive ints", plan_key=where))
        elif c > 1 and d is None:
            report.add(Diagnostic(
                code="CON002", severity="error",
                message=(f"{where}: schedule asks {c} chunks but the hop "
                         f"has no legal chunk dim (every free dim is "
                         f"transformed by the fused stage)"),
                hint="run this hop bulk (entry 1); make_spec's clamp "
                     "would have done so", plan_key=where))
        elif c > 1 and size is not None and size % c != 0:
            report.add(Diagnostic(
                code="CON002", severity="error",
                message=(f"{where}: {c} chunks do not divide the chunk "
                         f"dim's local block of {size} (dim {d})"),
                hint="use a divisor of the block size (make_spec clamps "
                     "via largest_divisor_at_most)", plan_key=where))


def check_grid_divisibility(spec: PipelineSpec, axis_sizes: Dict[str, int],
                            *, label: str,
                            report: DiagnosticReport) -> None:
    for s_idx, stage in enumerate(spec.decomp.stages):
        for d, entry in enumerate(stage.spec):
            size = axis_product(entry, axis_sizes)
            if size > 1 and spec.eff_grid[d] % size != 0:
                report.add(Diagnostic(
                    code="CON003", severity="error",
                    message=(f"{label}/stage{s_idx}: grid dim {d} "
                             f"({spec.eff_grid[d]}) not divisible by mesh "
                             f"axes {spec_axes(entry)!r} (size {size})"),
                    hint="pick a mesh shape dividing every sharded grid "
                         "dim (choose_fft_mesh_shape) or pad the grid",
                    plan_key=f"{label}/stage{s_idx}"))


# -- CON004 / CON005: key audits ---------------------------------------------

def prospective_plan_keys(plan) -> List[Tuple[str, tuple]]:
    """Every ``GLOBAL_PLAN_CACHE`` key this plan's public paths build,
    through the builders' own ``pipeline.pipeline_key``, without building
    anything: the fused pipeline and each segment per direction (interior
    segments donate, the executor's default)."""
    keys: List[Tuple[str, tuple]] = []
    for inverse in (False, True):
        spec = plan.pipeline_spec(inverse=inverse)
        dtype = plan._direction_dtype(inverse)
        tag = "inv" if inverse else "fwd"
        keys.append((f"{tag}/fused", pipeline_key(
            spec, plan.mesh, dtype, plan.batch_shape)))
        for j in range(len(spec.decomp.stages)):
            keys.append((f"{tag}/segment{j}", pipeline_key(
                spec, plan.mesh, dtype, plan.batch_shape,
                (j > 0, "segment", j))))
    return keys


def key_text(key) -> str:
    """A cache key's string rendering, with each :class:`Mesh` by
    identity (keys compare meshes by identity)."""
    if isinstance(key, tuple):
        inner = ", ".join(key_text(k) for k in key)
        return f"({inner},)" if len(key) == 1 else f"({inner})"
    if isinstance(key, Mesh):
        return f"{key!r}@{id(key):x}"
    return repr(key)


def audit_plan_keys(plans: Sequence = (), *, tune_cache=None,
                    include_global: bool = True) -> DiagnosticReport:
    """CON004/CON005 across the cache layers.

    * per plan: its prospective build keys must be pairwise distinct;
    * wisdom: two different key strings must not parse to one problem
      (``parse_tuning_key`` is field-order-insensitive, so a reordered
      writer would silently split one problem's wisdom in two);
    * in-memory caches: distinct keys must not alias on ``str()`` (a
      serialization/reporting hazard).
    """
    report = DiagnosticReport()
    for plan in plans:
        seen: Dict[tuple, str] = {}
        for label, key in prospective_plan_keys(plan):
            if key in seen:
                report.add(Diagnostic(
                    code="CON004", severity="error",
                    message=(f"plan-key collision: {seen[key]!r} and "
                             f"{label!r} are built under one "
                             f"GLOBAL_PLAN_CACHE key — the second would "
                             f"silently reuse the first's callable"),
                    hint="the key tuple must separate them (direction, "
                         "segment marker, donate flag); the plan's specs "
                         "are corrupted if two directions share a key",
                    plan_key=f"{seen[key]}|{label}"))
            else:
                seen[key] = label

    if tune_cache is not None:
        by_problem: Dict[tuple, str] = {}
        for key in tune_cache.keys():
            prob = parse_tuning_key(key)
            if prob is None:
                report.add(Diagnostic(
                    code="CON005", severity="warning",
                    message=f"unparseable wisdom key {key!r}",
                    hint="warm-start skips it; delete it if it is not a "
                         "newer version's key", plan_key=key))
                continue
            canon = tuple(sorted((k, str(v)) for k, v in prob.items()))
            if canon in by_problem and by_problem[canon] != key:
                report.add(Diagnostic(
                    code="CON004", severity="error",
                    message=(f"wisdom keys {by_problem[canon]!r} and "
                             f"{key!r} parse to the same tuning problem — "
                             f"one problem's wisdom is split across two "
                             f"entries (newest-ts merge cannot see them "
                             f"as one)"),
                    hint="emit keys only via tuning_key() so field order "
                         "is canonical", plan_key=key))
            else:
                by_problem.setdefault(canon, key)

    if include_global:
        for name, keys in (("GLOBAL_PLAN_CACHE", GLOBAL_PLAN_CACHE.keys()),
                           ("_PLAN_MEMO", _plan_memo_keys())):
            by_str: Dict[str, object] = {}
            for key in keys:
                s = key_text(key)
                other = by_str.get(s)
                if other is not None and other != key:
                    report.add(Diagnostic(
                        code="CON004", severity="warning",
                        message=(f"{name}: distinct keys alias on their "
                                 f"string rendering {s!r}"),
                        hint="keep key fields stringly-typed consistently "
                             "(plan_key takes dtype as a string)",
                        plan_key=s))
                else:
                    by_str.setdefault(s, key)
    return report


# -- plan-level entry point --------------------------------------------------

def check_pipeline(spec: PipelineSpec, axis_sizes: Dict[str, int], *,
                   label: str) -> DiagnosticReport:
    """All pipeline-shape contracts for one direction's spec."""
    report = DiagnosticReport()
    check_boundaries(spec, label=label, report=report)
    check_chunk_schedule(spec, axis_sizes, label=label, report=report)
    check_grid_divisibility(spec, axis_sizes, label=label, report=report)
    return report


def check_plan(plan, *, tune_cache=None,
               include_global: bool = False) -> DiagnosticReport:
    """Statically verify one ``DistributedFFT``: both directions' segment
    chains plus its plan-key audit.  Executes nothing."""
    axis_sizes = plan.mesh.axis_sizes
    base = f"plan(grid={plan.grid},kinds={','.join(plan.kinds)})"
    report = DiagnosticReport()
    for inverse in (False, True):
        label = f"{base}/{'inv' if inverse else 'fwd'}"
        report.extend(check_pipeline(plan.pipeline_spec(inverse=inverse),
                                     axis_sizes, label=label))
    report.extend(audit_plan_keys([plan], tune_cache=tune_cache,
                                  include_global=include_global))
    return report
