"""The port's static verifier and sanitizer (``repro_torch/analysis/``)
against the JAX package's (``repro/analysis/``).

* Seeded hazards: each one is built in both packages from the same numpy
  seed (the JAX side in one subprocess, on a (1, 1) mesh like
  ``tests/test_analysis.py``'s ``cpu_mesh``), and both must report the
  same rule codes at the same ``where`` keys: SCHED001-004, DON001,
  DON002, ALIAS001-003, CON001-005 and SAN001 from the mis-modelled
  executors.
* In-process counterparts of ``tests/test_analysis.py``: the
  diagnostics plumbing (dedup, sorted JSON), the interleaving model, the
  executor's ``verify=``/``sanitize=`` hooks, ``plan_fft(validate=)``,
  ``DistributedFFT.verify()`` and ``describe()``, the timed model, the
  service's ``verify_sink`` and ``serve_fft --verify``.
* What the port does differently, as it does it: ``serialize_dispatch=
  False`` is never launched; donation is out of place, so the ALIAS002
  queue does not corrupt its sibling at run time; storage-range aliasing
  of views; the release marker; the ``be=`` wisdom keys.
* 4 gloo ranks (one spawn): sanitize in the async, pool and timed modes
  with 0 SAN001 and outputs bitwise equal to the solo runs, every rank
  launching one order; a rank that reports another order is caught on
  every rank; an unserialized pool queue is refused before launch.
* The port's lint (REP000-REP004, suppressions, the CLI) and the whole
  port clean under it.
"""
import dataclasses as dc
import json
import os
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.analysis import (Diagnostic, DiagnosticReport,
                                  PlanVerificationError, audit_plan_keys,
                                  buffers_alias, check_plan, check_schedule,
                                  check_timed_schedule, diff_ranks,
                                  expected_donations, replay_watchdog)
from repro_torch.analysis.contracts import check_pipeline
from repro_torch.compat import make_mesh
from repro_torch.core.api import plan_fft
from repro_torch.core.decomp import StageLayout
from repro_torch.core.executor import PlanStreamExecutor, SegmentTask
from repro_torch.core.pipeline import release, released
from repro_torch.core.plan import tuning_key
from repro_torch.core.scheduler import CostModel
from repro_torch.core.transforms import REFERENCE_BACKEND
from repro_torch.distributed.fault import StepWatchdog
from torch_harness import run_ranks, run_reference

NAMES = ("data", "model")


def _mesh():
    return make_mesh((1, 1), NAMES, device="cpu")


def _cx(rng, shape):
    """The reference tests' operand draw, as a torch tensor."""
    return torch.from_numpy((rng.standard_normal(shape)
                             + 1j * rng.standard_normal(shape)
                             ).astype(np.complex64))


def _two_plan_queue(mesh):
    rng = np.random.default_rng(0)
    p2d = plan_fft(mesh, (8, 8))
    p3d = plan_fft(mesh, (4, 4, 8))
    return [(p2d, _cx(rng, (8, 8))), (p3d, _cx(rng, (4, 4, 8)))]


def _three_entry_queue(mesh):
    rng = np.random.default_rng(7)
    p2d = plan_fft(mesh, (8, 8))
    p3d = plan_fft(mesh, (4, 4, 8))
    return [(p2d, _cx(rng, (8, 8)), False),
            (p3d, _cx(rng, (4, 4, 8)), False),
            (p2d, _cx(rng, (8, 8)), True)]    # last entry donates


def _where(report):
    return sorted([d.code, d.where()] for d in report)


class MisModeled(PlanStreamExecutor):
    """Dispatches a chain-preserving permutation of the planned merge."""

    def _run_order(self, order, entries):
        rr = sorted(order, key=lambda s: (s.index, s.entry))
        em = sorted(order, key=lambda s: (s.entry, s.index))
        alt = rr if [id(s) for s in rr] != [id(s) for s in order] else em
        return super()._run_order(alt, entries)


class NoDonate(PlanStreamExecutor):
    """Silently ignores ``donate=``."""

    def _segment_exes(self, entry):
        return entry.plan.segments(
            inverse=entry.inverse, donate_input=False,
            donate_intermediates=self.donate_intermediates)


def _fake_queue(chains, kinds=None, streams=None):
    """Synthetic (order, entries) from per-entry cost chains (entry-major
    order, the merge of a single lane)."""
    entries, order = [], []
    for i, costs in enumerate(chains):
        stream = streams[i] if streams else 0
        kind = kinds[i] if kinds else "comp"
        segs = [SegmentTask(entry=i, index=j, kind=kind, cost_s=c,
                            bytes_out=0, tag=f"e{i}", stream=stream)
                for j, c in enumerate(costs)]
        entries.append(SimpleNamespace(tag=f"e{i}", segments=segs,
                                       stream=stream, donate=False))
        order.extend(segs)
    return order, entries


# ---------------------------------------------------------------------------
# Seeded hazards: the same codes at the same where keys as the JAX package
# ---------------------------------------------------------------------------

REFERENCE = r'''
import dataclasses as dc, json, warnings
from types import SimpleNamespace
import numpy as np, jax, jax.numpy as jnp
from repro.analysis import (PlanVerificationError, audit_plan_keys,
                            check_plan, check_schedule, check_timed_schedule)
from repro.analysis.contracts import check_pipeline
from repro.compat import AxisType, make_mesh
from repro.core import PlanStreamExecutor, plan_fft
from repro.core.decomp import StageLayout
from repro.core.executor import SegmentTask
from repro.core.plan import tuning_key
from repro.core.scheduler import CostModel
warnings.simplefilter("ignore")
mesh = make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
axis_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))

def cx(rng, shape):
    return jnp.asarray((rng.standard_normal(shape)
                        + 1j * rng.standard_normal(shape)).astype(np.complex64))

def two():
    rng = np.random.default_rng(0)
    return [(plan_fft(mesh, (8, 8)), cx(rng, (8, 8))),
            (plan_fft(mesh, (4, 4, 8)), cx(rng, (4, 4, 8)))]

def where(rep):
    return sorted([d.code, d.where()] for d in rep)

def fake(chains, kinds=None, streams=None):
    entries, order = [], []
    for i, costs in enumerate(chains):
        stream = streams[i] if streams else 0
        kind = kinds[i] if kinds else "comp"
        segs = [SegmentTask(entry=i, index=j, kind=kind, cost_s=c,
                            bytes_out=0, tag=f"e{i}", stream=stream)
                for j, c in enumerate(costs)]
        entries.append(SimpleNamespace(tag=f"e{i}", segments=segs,
                                       stream=stream, donate=False))
        order.extend(segs)
    return order, entries

out = {}
ex = PlanStreamExecutor(mode="pool", serialize_dispatch=False)
for p, x in two():
    ex.submit(p, x)
out["sched001_unserialized_pool"] = where(ex.verify_schedule())
ex = PlanStreamExecutor(mode="pool")
for p, x in two():
    ex.submit(p, x)
out["serialized_pool_clean"] = where(ex.verify_schedule())

plan = plan_fft(mesh, (8, 8))
x = cx(np.random.default_rng(1), (8, 8))
ex = PlanStreamExecutor(mode="pool")
ex.submit(plan, x, donate=True)
ex.submit(plan, x)
out["don001_pool"] = where(ex.verify_schedule())
ex = PlanStreamExecutor(n_streams=1)
ex.submit(plan, x)
ex.submit(plan, x, donate=True)
out["don001_reader_first"] = where(check_schedule(ex._plan_schedule(),
                                                  ex._queue, mode="async"))
ex = PlanStreamExecutor(n_streams=1)
ex.submit(plan, x, donate=True)
ex.submit(plan, x)
out["don001_donor_first"] = where(check_schedule(ex._plan_schedule(),
                                                 ex._queue, mode="async"))

x2 = cx(np.random.default_rng(2), (8, 8))
ex = PlanStreamExecutor()
ex.submit(plan, x2, donate=True)
ex.submit(plan, cx(np.random.default_rng(3), (8, 8)))
plan.shared = True
out["don002_shared_after_submit"] = where(check_schedule(ex._plan_schedule(),
                                                         ex._queue))
plan.shared = False
ex = PlanStreamExecutor()
ex.submit(plan, x2, donate=True)
ex.submit(plan, x2, donate=True)
out["alias001_double"] = where(check_schedule(ex._plan_schedule(), ex._queue))

ex = PlanStreamExecutor()
for p, xx in two():
    ex.submit(p, xx)
order = ex._plan_schedule()
out["two_plan_clean"] = where(check_schedule(order, ex._queue))
out["sched002_reversed"] = where(check_schedule(list(reversed(order)),
                                                ex._queue))

p8 = plan_fft(mesh, (8, 8, 8), precompiled=False)
out["plan_clean"] = where(check_plan(p8))
spec = p8.pipeline_spec()
stages = list(spec.decomp.stages)
good = stages[1]
swapped = tuple(reversed([e for i, e in enumerate(good.spec)
                          if i not in good.fft_dims]))
bad_spec, j = list(good.spec), 0
for i in range(len(bad_spec)):
    if i not in good.fft_dims:
        bad_spec[i] = swapped[j]
        j += 1
stages[1] = StageLayout(spec=tuple(bad_spec), fft_dims=good.fft_dims)
bad = dc.replace(spec, decomp=dc.replace(spec.decomp, stages=tuple(stages)))
out["con001_corrupt"] = where(check_pipeline(bad, axis_sizes, label="corrupt"))
out["con002_chunk"] = where(check_pipeline(
    dc.replace(spec, chunk_schedule=(3,) + spec.chunk_schedule[1:]),
    axis_sizes, label="chunk"))
out["con002_len"] = where(check_pipeline(
    dc.replace(spec, chunk_schedule=spec.chunk_schedule[:-1]),
    axis_sizes, label="len"))
out["con002_neg"] = where(check_pipeline(
    dc.replace(spec, chunk_schedule=(0,) + spec.chunk_schedule[1:]),
    axis_sizes, label="neg"))
out["con003_grid"] = where(check_pipeline(spec, dict(axis_sizes, model=3),
                                          label="grid"))
pc = plan_fft(mesh, (8, 8), precompiled=False)
object.__setattr__(pc, "_inv_spec", pc._fwd_spec)
out["con004_plan_keys"] = where(check_plan(pc))
k = tuning_key(grid=(16, 16), mesh_shape=(2, 4), mesh_axes=("data", "model"),
               kinds=("fft", "fft"), dtype="complex64", inverse=False)
class Stub:
    def keys(self):
        return [k, ";".join(reversed(k.split(";"))), "not-a-wisdom-key"]
out["con004_con005_wisdom"] = where(audit_plan_keys(tune_cache=Stub(),
                                                    include_global=False))

def view(x):
    return jax.make_array_from_single_device_arrays(
        x.shape, x.sharding, [s.data for s in x.addressable_shards])
p = plan_fft(mesh, (8, 8))
xa = jax.device_put(cx(np.random.default_rng(1), (8, 8)), p.in_struct.sharding)
ex = PlanStreamExecutor(verify="strict")
ex.submit(p, view(xa), donate=True)
ex.submit(p, xa)
out["alias002_view"] = where(ex.verify_schedule())
x3 = jax.device_put(cx(np.random.default_rng(3), (8, 8)), p.in_struct.sharding)
ex = PlanStreamExecutor(verify="strict")
ex.submit(p, x3, donate=True, sharded_in=True)
jax.block_until_ready(ex.run())
ex.submit(p, x3, sharded_in=True)
try:
    ex.run()
    out["alias003_resubmitted"] = []
except PlanVerificationError as e:
    out["alias003_resubmitted"] = where(e.report)

pd = plan_fft(mesh, (8, 8))
pd.segments(donate_input=True)
out["don002_plan_unshared"] = where(pd.verify())
pd.shared = True
out["don002_plan_shared"] = where(pd.verify())

o, e = fake([[1.0] * 10 + [10.0]])
out["sched004"] = where(check_timed_schedule(o, e, mode="timed"))
o, e = fake([[1.0] * 40, [1.0, 1.0]], kinds=["comm", "comp"])
out["sched003_timed"] = where(check_timed_schedule(o, e, mode="timed"))
o, e = fake([[1.0] * 40, [0.5, 0.5], [1.0]], kinds=["comm", "comp", "comp"],
            streams=[0, 0, 1])
out["sched003_pool"] = where(check_timed_schedule(
    o, e, mode="pool", cost_model=CostModel(steal_overhead_s=10.0)))

def three():
    rng = np.random.default_rng(7)
    p2, p3 = plan_fft(mesh, (8, 8)), plan_fft(mesh, (4, 4, 8))
    return [(p2, cx(rng, (8, 8)), False), (p3, cx(rng, (4, 4, 8)), False),
            (p2, cx(rng, (8, 8)), True)]
for mode in ("async", "pool", "timed"):
    ex = PlanStreamExecutor(mode=mode, sanitize=True, verify="strict")
    for pp, xx, d in three():
        ex.submit(pp, xx, donate=d)
    jax.block_until_ready(ex.run())
    out[f"sanitize_clean_{mode}"] = where(ex.last_sanitize_report())

class MisModeled(PlanStreamExecutor):
    def _run_order(self, order, entries):
        rr = sorted(order, key=lambda s: (s.index, s.entry))
        em = sorted(order, key=lambda s: (s.entry, s.index))
        alt = rr if [id(s) for s in rr] != [id(s) for s in order] else em
        return super()._run_order(alt, entries)
ex = MisModeled(sanitize=True, verify_sink=lambda r: None)
for pp, xx, _ in three()[:2]:
    ex.submit(pp, xx)
jax.block_until_ready(ex.run())
out["san001_order"] = where(ex.last_sanitize_report())

class NoDonate(PlanStreamExecutor):
    def _segment_exes(self, entry):
        return entry.plan.segments(
            inverse=entry.inverse, donate_input=False,
            donate_intermediates=self.donate_intermediates)
ex = NoDonate(sanitize=True, verify_sink=lambda r: None)
p = plan_fft(mesh, (8, 8))
xn = jax.device_put(cx(np.random.default_rng(11), (8, 8)), p.in_struct.sharding)
ex.submit(p, xn, donate=True, sharded_in=True)
jax.block_until_ready(ex.run())
out["san001_donation"] = where(ex.last_sanitize_report())
print("JSON" + json.dumps(out))
'''


@pytest.fixture(scope="module")
def reference():
    out = run_reference(REFERENCE, devices=1)
    return json.loads(next(ln for ln in out.splitlines()
                           if ln.startswith("JSON"))[4:])


def _hazards():
    """The port's side of every seeded hazard: name -> report."""
    mesh = _mesh()
    axis_sizes = mesh.axis_sizes
    out = {}
    ex = PlanStreamExecutor(mode="pool", serialize_dispatch=False)
    for p, x in _two_plan_queue(mesh):
        ex.submit(p, x)
    out["sched001_unserialized_pool"] = ex.verify_schedule()
    ex = PlanStreamExecutor(mode="pool")
    for p, x in _two_plan_queue(mesh):
        ex.submit(p, x)
    out["serialized_pool_clean"] = ex.verify_schedule()

    plan = plan_fft(mesh, (8, 8))
    x = _cx(np.random.default_rng(1), (8, 8))
    ex = PlanStreamExecutor(mode="pool")
    ex.submit(plan, x, donate=True)
    ex.submit(plan, x)
    out["don001_pool"] = ex.verify_schedule()
    ex = PlanStreamExecutor(n_streams=1)
    ex.submit(plan, x)
    ex.submit(plan, x, donate=True)
    out["don001_reader_first"] = check_schedule(ex._plan_schedule(),
                                                ex._queue, mode="async")
    ex = PlanStreamExecutor(n_streams=1)
    ex.submit(plan, x, donate=True)
    ex.submit(plan, x)
    out["don001_donor_first"] = check_schedule(ex._plan_schedule(),
                                               ex._queue, mode="async")

    x2 = _cx(np.random.default_rng(2), (8, 8))
    ex = PlanStreamExecutor()
    ex.submit(plan, x2, donate=True)
    ex.submit(plan, _cx(np.random.default_rng(3), (8, 8)))
    plan.shared = True
    out["don002_shared_after_submit"] = check_schedule(ex._plan_schedule(),
                                                       ex._queue)
    plan.shared = False
    ex = PlanStreamExecutor()
    ex.submit(plan, x2, donate=True)
    ex.submit(plan, x2, donate=True)
    out["alias001_double"] = check_schedule(ex._plan_schedule(), ex._queue)

    ex = PlanStreamExecutor()
    for p, xx in _two_plan_queue(mesh):
        ex.submit(p, xx)
    order = ex._plan_schedule()
    out["two_plan_clean"] = check_schedule(order, ex._queue)
    out["sched002_reversed"] = check_schedule(list(reversed(order)),
                                              ex._queue)

    p8 = plan_fft(mesh, (8, 8, 8))
    out["plan_clean"] = check_plan(p8)
    spec = p8.pipeline_spec()
    out["con001_corrupt"] = check_pipeline(_corrupted(spec), axis_sizes,
                                           label="corrupt")
    out["con002_chunk"] = check_pipeline(
        dc.replace(spec, chunk_schedule=(3,) + spec.chunk_schedule[1:]),
        axis_sizes, label="chunk")
    out["con002_len"] = check_pipeline(
        dc.replace(spec, chunk_schedule=spec.chunk_schedule[:-1]),
        axis_sizes, label="len")
    out["con002_neg"] = check_pipeline(
        dc.replace(spec, chunk_schedule=(0,) + spec.chunk_schedule[1:]),
        axis_sizes, label="neg")
    out["con003_grid"] = check_pipeline(spec, dict(axis_sizes, model=3),
                                        label="grid")
    pc = plan_fft(mesh, (8, 8))
    pc._inv_spec = pc._fwd_spec
    out["con004_plan_keys"] = check_plan(pc)
    out["con004_con005_wisdom"] = audit_plan_keys(
        tune_cache=_StubCache(_reordered_wisdom()), include_global=False)

    p = plan_fft(mesh, (8, 8))
    xa = _cx(np.random.default_rng(1), (8, 8))
    ex = PlanStreamExecutor(verify="strict")
    ex.submit(p, xa[:], donate=True)
    ex.submit(p, xa)
    out["alias002_view"] = ex.verify_schedule()
    out["alias003_resubmitted"] = _alias003_report(p)

    pd = plan_fft(mesh, (8, 8))
    pd.segments(donate_input=True)
    out["don002_plan_unshared"] = pd.verify()
    pd.shared = True
    out["don002_plan_shared"] = pd.verify()

    o, e = _fake_queue([[1.0] * 10 + [10.0]])
    out["sched004"] = check_timed_schedule(o, e, mode="timed")
    o, e = _fake_queue([[1.0] * 40, [1.0, 1.0]], kinds=["comm", "comp"])
    out["sched003_timed"] = check_timed_schedule(o, e, mode="timed")
    o, e = _fake_queue([[1.0] * 40, [0.5, 0.5], [1.0]],
                       kinds=["comm", "comp", "comp"], streams=[0, 0, 1])
    out["sched003_pool"] = check_timed_schedule(
        o, e, mode="pool", cost_model=CostModel(steal_overhead_s=10.0))

    for mode in ("async", "pool", "timed"):
        ex = PlanStreamExecutor(mode=mode, sanitize=True, verify="strict")
        for pp, xx, d in _three_entry_queue(mesh):
            ex.submit(pp, xx, donate=d)
        ex.run()
        out[f"sanitize_clean_{mode}"] = ex.last_sanitize_report()
    ex = MisModeled(sanitize=True, verify_sink=lambda r: None)
    for pp, xx, _ in _three_entry_queue(mesh)[:2]:
        ex.submit(pp, xx)
    ex.run()
    out["san001_order"] = ex.last_sanitize_report()
    ex = NoDonate(sanitize=True, verify_sink=lambda r: None)
    p = plan_fft(mesh, (8, 8))
    ex.submit(p, _cx(np.random.default_rng(11), (8, 8)), donate=True,
              sharded_in=True)
    ex.run()
    out["san001_donation"] = ex.last_sanitize_report()
    return out


def _corrupted(spec):
    """Swap one interior stage's layout for a self-consistent but wrong
    one: only an independent hop replay can catch it."""
    stages = list(spec.decomp.stages)
    good = stages[1]
    swapped = tuple(reversed([e for i, e in enumerate(good.spec)
                              if i not in good.fft_dims]))
    bad_spec, j = list(good.spec), 0
    for i in range(len(bad_spec)):
        if i not in good.fft_dims:
            bad_spec[i] = swapped[j]
            j += 1
    stages[1] = StageLayout(spec=tuple(bad_spec), fft_dims=good.fft_dims)
    return dc.replace(spec,
                      decomp=dc.replace(spec.decomp, stages=tuple(stages)))


class _StubCache:
    def __init__(self, keys):
        self._keys = list(keys)

    def keys(self):
        return list(self._keys)


def _reordered_wisdom():
    k = tuning_key(grid=(16, 16), mesh_shape=(2, 4),
                   mesh_axes=("data", "model"), kinds=("fft", "fft"),
                   dtype="complex64", inverse=False)
    return [k, ";".join(reversed(k.split(";"))), "not-a-wisdom-key"]


def _alias003_report(p):
    """Submit an operand, let another executor's run donate it, then run:
    the strict check refuses it with ALIAS003 (resubmitting an emptied
    operand is refused by ``submit`` itself: its shape is gone)."""
    x = _cx(np.random.default_rng(3), (8, 8))
    ex = PlanStreamExecutor(verify="strict")
    ex.submit(p, x, sharded_in=True)
    other = PlanStreamExecutor()
    other.submit(p, x, donate=True, sharded_in=True)
    other.run()
    assert released(x)
    with pytest.raises(PlanVerificationError) as ei:
        ex.run()
    assert len(ex) == 1                        # strict left the queue intact
    with pytest.raises(ValueError, match="operand shape"):
        PlanStreamExecutor().submit(p, x, sharded_in=True)
    return ei.value.report


@pytest.fixture(scope="module")
def hazards():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return _hazards()


HAZARDS = ["sched001_unserialized_pool", "serialized_pool_clean",
           "don001_pool", "don001_reader_first", "don001_donor_first",
           "don002_shared_after_submit", "alias001_double",
           "two_plan_clean", "sched002_reversed", "plan_clean",
           "con001_corrupt", "con002_chunk", "con002_len", "con002_neg",
           "con003_grid", "con004_plan_keys", "con004_con005_wisdom",
           "alias002_view", "alias003_resubmitted", "don002_plan_unshared",
           "sched004", "sched003_timed", "sched003_pool",
           "sanitize_clean_async", "sanitize_clean_pool",
           "sanitize_clean_timed", "san001_order", "san001_donation"]


@pytest.mark.parametrize("name", HAZARDS)
def test_seeded_hazard_codes_match_reference(reference, hazards, name):
    assert _where(hazards[name]) == reference[name], name


def test_don002_shared_plan_where_key_matches_reference(reference, hazards):
    """The plan-level DON002 is keyed by the plan's repr, which names the
    backend: the port's ``cufft`` is the reference's ``xla``."""
    got = [[code, where.replace(f"backend={be!r}",
                                f"backend={REFERENCE_BACKEND[be]!r}")]
           for code, where in _where(hazards["don002_plan_shared"])
           for be in ("cufft",)]
    assert got == reference["don002_plan_shared"]
    assert [c for c, _ in got] == ["DON002"]


def test_seeded_hazards_fire(hazards):
    """The hazards the parity test compares are real findings, not two
    empty reports."""
    want = {"sched001_unserialized_pool": "SCHED001",
            "don001_pool": "DON001", "don001_donor_first": "DON001",
            "don002_shared_after_submit": "DON002",
            "alias001_double": "ALIAS001", "sched002_reversed": "SCHED002",
            "con001_corrupt": "CON001", "con002_chunk": "CON002",
            "con003_grid": "CON003", "con004_plan_keys": "CON004",
            "alias002_view": "ALIAS002", "alias003_resubmitted": "ALIAS003",
            "sched004": "SCHED004", "sched003_timed": "SCHED003",
            "sched003_pool": "SCHED003", "san001_order": "SAN001",
            "san001_donation": "SAN001"}
    for name, code in want.items():
        assert code in hazards[name].codes(), name
    for name in ("serialized_pool_clean", "two_plan_clean", "plan_clean",
                 "don001_reader_first", "sanitize_clean_async",
                 "sanitize_clean_pool", "sanitize_clean_timed"):
        assert not hazards[name].errors, name


# ---------------------------------------------------------------------------
# Diagnostics plumbing
# ---------------------------------------------------------------------------

def test_diagnostic_report_json_and_rendering():
    rep = DiagnosticReport()
    assert not rep and len(rep) == 0
    rep.add(Diagnostic(code="CON001", severity="error", message="boom",
                       hint="fix it", plan_key="p"))
    rep.add(Diagnostic(code="CON005", severity="warning", message="meh"))
    assert len(rep) == 2 and len(rep.errors) == 1
    assert list(rep.codes()) == ["CON001", "CON005"]
    text = rep.render()
    assert "CON001" in text and "fix it" in text
    payload = json.loads(rep.to_json())
    assert payload["count"] == 2 and payload["errors"] == 1
    assert payload["diagnostics"][0]["code"] == "CON001"
    with pytest.raises(ValueError, match="severity"):
        Diagnostic(code="X", severity="fatal", message="no such level")


def test_diagnostic_report_dedups_and_sorts_json():
    dup = Diagnostic(code="DON001", severity="error", message="same defect",
                     plan_key="entry1/seg0")
    rep = DiagnosticReport([dup])
    rep.add(Diagnostic(code="DON001", severity="error",
                       message="same defect", plan_key="entry1/seg0"))
    rep.extend(DiagnosticReport([dup]))
    assert len(rep) == 1                       # three reports, one record
    rep.add(Diagnostic(code="DON001", severity="error",
                       message="same defect", plan_key="entry2/seg0"))
    rep.add(Diagnostic(code="ALIAS002", severity="error", message="later"))
    assert len(rep) == 3
    payload = json.loads(rep.to_json())
    keys = [(d["code"], d.get("plan_key", "")) for d in payload["diagnostics"]]
    assert keys == sorted(keys)                # ALIAS002 first, then DON001s
    assert payload["count"] == 3 and payload["errors"] == 3


def test_port_diagnostics_render_like_the_reference():
    """The port keeps its own copy of the diagnostics module: the same
    record renders and serializes to the same text."""
    from repro.analysis import Diagnostic as RefDiagnostic
    from repro.analysis import DiagnosticReport as RefReport
    kw = dict(code="SCHED001", severity="error", message="m", hint="h",
              plan_key="a|b")
    ref = RefReport([RefDiagnostic(**kw),
                     RefDiagnostic(code="REP002", severity="error",
                                   message="t", path="f.py", line=3)])
    got = DiagnosticReport([Diagnostic(**kw),
                            Diagnostic(code="REP002", severity="error",
                                       message="t", path="f.py", line=3)])
    assert got.render() == ref.render()
    assert got.to_json() == ref.to_json()


# ---------------------------------------------------------------------------
# The interleaving model
# ---------------------------------------------------------------------------

def test_racy_pairs_exhaustive_equals_pairwise_rule():
    """The pairwise rule against every reachable merge, enumerated here:
    a pair is racy iff some merge launches it in each order."""
    from itertools import combinations, permutations

    from repro_torch.analysis.schedule_check import racy_collective_pairs
    chains = [["a0", "a1"], ["b0"], ["c0", "c1", "c2"]]
    merges = [m for m in permutations(sum(chains, []))
              if all([m.index(t) for t in c] == sorted(m.index(t) for t in c)
                     for c in chains)]
    assert len(merges) == 60                   # 6! / (2! 1! 3!)
    orders = {}
    for m in merges:
        for a, b in combinations(m, 2):
            orders.setdefault(tuple(sorted((a, b))), set()).add((a, b))
    exhaustive = sorted(k for k, seen in orders.items() if len(seen) == 2)
    assert racy_collective_pairs(chains) == exhaustive
    assert ("a0", "a1") not in exhaustive and ("a0", "b0") in exhaustive
    assert racy_collective_pairs([["a0", "a1"]]) == []
    assert racy_collective_pairs([["a0"], []]) == []


def test_only_unserialized_pool_dispatch_is_racy():
    """The port's model: with turns every mode launches the planned merge
    (one order); only pool workers without turns race."""
    from repro_torch.analysis.schedule_check import racy_dispatch
    assert racy_dispatch("pool", serialized=False)
    for mode in ("async", "timed", "pool"):
        assert not racy_dispatch(mode, serialized=True)
    for mode in ("async", "timed"):
        assert not racy_dispatch(mode, serialized=False)


# ---------------------------------------------------------------------------
# The executor's verify hooks
# ---------------------------------------------------------------------------

def test_seeded_pool_deadlock_flagged_and_refused_before_dispatch():
    """Pool dispatch without turns: SCHED001 statically; a strict run
    raises before any launch and leaves the queue intact; the default
    (turns) has no reachable cross-order interleaving."""
    mesh = _mesh()
    ex = PlanStreamExecutor(mode="pool", serialize_dispatch=False,
                            verify="strict")
    for plan, x in _two_plan_queue(mesh):
        ex.submit(plan, x)
    assert "SCHED001" in ex.verify_schedule().codes()
    assert len(ex) == 2
    with pytest.raises(PlanVerificationError, match="SCHED001"):
        ex.run()
    assert len(ex) == 2
    assert all(e.out is None for e in ex._queue)
    ex2 = PlanStreamExecutor(mode="pool")
    for plan, x in _two_plan_queue(mesh):
        ex2.submit(plan, x)
    assert "SCHED001" not in ex2.verify_schedule().codes()


@pytest.mark.parametrize("verify", ["off", "warn", "strict"])
def test_unserialized_dispatch_is_never_launched(verify):
    """``serialize_dispatch=False`` is accepted for the static check only:
    ``run()`` raises before anything launches whatever ``verify`` is (a
    clean strict check too), and the queue stays as it was."""
    mesh = _mesh()
    plan = plan_fft(mesh, (8, 8))
    x = _cx(np.random.default_rng(5), (8, 8))
    snap = x.clone()
    ex = PlanStreamExecutor(mode="async", serialize_dispatch=False,
                            verify=verify)
    ex.submit(plan, x, donate=True)
    assert not ex.verify_schedule().errors     # one entry: nothing racy
    with pytest.raises(RuntimeError, match="serialize_dispatch=False"):
        ex.run()
    assert len(ex) == 1 and ex._queue[0].out is None
    assert torch.equal(x, snap) and not released(x)   # nothing ran


def test_clean_queue_runs_under_strict_verify():
    mesh = _mesh()
    queue = _two_plan_queue(mesh)
    ex = PlanStreamExecutor(verify="strict")
    for plan, x in queue:
        ex.submit(plan, x)
    outs = ex.run()
    assert len(outs) == len(queue)
    for (plan, x), y in zip(queue, outs):
        assert torch.equal(y, plan(x))
    assert ex.last_verify_report() is not None
    assert not len(ex.last_verify_report())


def test_run_twice_is_safe():
    mesh = _mesh()
    plan = plan_fft(mesh, (8, 8))
    rng = np.random.default_rng(4)
    ex = PlanStreamExecutor(mode="timed", profile=True, verify="warn")
    ex.submit(plan, _cx(rng, (8, 8)))
    assert len(ex.run()) == 1 and len(ex) == 0
    assert ex.run() == []
    x2 = _cx(rng, (8, 8))
    ex.submit(plan, x2)
    out2 = ex.run()
    assert len(out2) == 1 and torch.equal(out2[0], plan(x2))


def test_warn_mode_routes_findings_to_sink_or_warning():
    """verify='warn' proceeds with a hazard: its findings go to the sink
    when one is wired, else to a warning.  (ALIAS002 here: in the port it
    leaves every result intact, see below.)"""
    mesh = _mesh()
    plan = plan_fft(mesh, (8, 8))
    x = _cx(np.random.default_rng(6), (8, 8))
    solo = plan(x.clone())
    findings = []
    ex = PlanStreamExecutor(verify="warn", verify_sink=findings.append)
    ex.submit(plan, x[:], donate=True)
    ex.submit(plan, x)
    outs = ex.run()
    assert [f.codes() for f in findings] == [["ALIAS002"]]
    assert all(torch.equal(y, solo) for y in outs)
    ex = PlanStreamExecutor(verify="warn")
    ex.submit(plan, x[:], donate=True)
    ex.submit(plan, x)
    with pytest.warns(UserWarning, match="ALIAS002"):
        ex.run()


def test_don001_hazard_fails_at_runtime_without_verify():
    """What DON001 guards against, in the port: the reader's operand is the
    donated tensor itself, emptied by the donor's segment 0, so the
    reader's segment raises instead of reading stale memory."""
    mesh = _mesh()
    plan = plan_fft(mesh, (8, 8))
    x = _cx(np.random.default_rng(8), (8, 8))
    ex = PlanStreamExecutor(n_streams=1)
    ex.submit(plan, x, donate=True)
    ex.submit(plan, x)
    with pytest.raises(RuntimeError):
        ex.run()
    assert released(x)


# ---------------------------------------------------------------------------
# Storage provenance: views, the release marker, ALIAS002 at run time
# ---------------------------------------------------------------------------

def test_release_marks_what_it_empties():
    x = _cx(np.random.default_rng(0), (4, 4))
    assert not released(x) and not released(torch.empty(0))
    assert not released(np.zeros(3))
    v = x[1:3]
    release(v)
    assert released(v) and v.numel() == 0
    assert not released(x) and x.shape == (4, 4)   # the storage's owner
    v.set_(torch.zeros(2, dtype=v.dtype))           # refilled: live again
    assert not released(v)


def test_buffers_alias_identity_views_and_ranges():
    x = _cx(np.random.default_rng(0), (8, 8))
    y = _cx(np.random.default_rng(1), (8, 8))
    assert buffers_alias(x, x)
    for view in (x[:], x[2:5], x.conj(), torch.view_as_real(x[3]),
                 torch.as_strided(x, (2, 2), (8, 1), 9), x.t()):
        assert view is not x
        assert buffers_alias(x, view) and buffers_alias(view, x)
    assert not buffers_alias(x, y)
    assert not buffers_alias(x[:4], x[4:])          # disjoint rows
    assert not buffers_alias(x, torch.empty(0))
    assert not buffers_alias(x, x.clone())
    release(x[:])                                   # a released view
    assert not buffers_alias(x[:0], x)


def test_alias002_view_aliased_donation_flagged_and_refused():
    mesh = _mesh()
    p = plan_fft(mesh, (8, 8))
    x = _cx(np.random.default_rng(1), (8, 8))
    ex = PlanStreamExecutor(verify="strict")
    ex.submit(p, x[:], donate=True)
    ex.submit(p, x)
    assert "ALIAS002" in ex.verify_schedule().codes()
    with pytest.raises(PlanVerificationError) as ei:
        ex.run()
    assert "ALIAS002" in ei.value.report.codes()
    assert len(ex) == 2


def test_alias002_hazard_does_not_corrupt_at_runtime_without_verify():
    """What the port's runtime does with the ALIAS002 queue: donation is
    out of place (``release`` empties the donated tensor object only), so
    the sibling's operand keeps the storage and its values, and both
    results equal the solo runs.  The JAX package's donation deletes the
    shared buffer instead and the sibling fails."""
    mesh = _mesh()
    p = plan_fft(mesh, (8, 8))
    x = _cx(np.random.default_rng(2), (8, 8))
    snap = x.clone()
    solo = p(snap)
    view = x[:]
    ex = PlanStreamExecutor()
    ex.submit(p, view, donate=True)
    ex.submit(p, x)
    outs = ex.run()
    assert released(view)
    assert torch.equal(x, snap) and not released(x)
    assert all(torch.equal(y, solo) for y in outs)


def test_alias003_emptied_operand_refused():
    mesh = _mesh()
    report = _alias003_report(plan_fft(mesh, (8, 8)))
    assert report.codes() == ["ALIAS003"]


def test_don002_shared_plan_with_donating_variants():
    p = plan_fft(_mesh(), (8, 8))
    p.segments(donate_input=True)
    assert "DON002" not in p.verify().codes()
    p.shared = True
    rep = p.verify()
    assert "DON002" in rep.codes()
    assert all(d.severity == "error" for d in rep if d.code == "DON002")


def test_expected_donations_model():
    def seg(i, j):
        return SegmentTask(entry=i, index=j, kind="comp", cost_s=1.0,
                           bytes_out=0, tag=f"e{i}/seg{j}", stream=0)
    entries = [SimpleNamespace(tag="e0", donate=True,
                               segments=[seg(0, 0), seg(0, 1)]),
               SimpleNamespace(tag="e1", donate=False,
                               segments=[seg(1, 0)])]
    rows = dict(expected_donations(entries))
    assert rows == {"e0/seg0": True, "e0/seg1": True, "e1/seg0": False}
    rows2 = dict(expected_donations(entries, donate_intermediates=False))
    assert rows2["e0/seg0"] is True and rows2["e0/seg1"] is False


# ---------------------------------------------------------------------------
# Contracts: plan_fft(validate=), DistributedFFT.verify(), describe()
# ---------------------------------------------------------------------------

def test_clean_plan_verifies_and_describe_stamps_it():
    plan = plan_fft(_mesh(), (8, 8, 8), backend="kernel")
    assert "verified: not verified" in plan.describe()
    assert len(check_plan(plan)) == 0
    report = plan.verify()
    assert len(report) == 0 and plan.verified is True
    assert "verified: contracts clean" in plan.describe()


def test_colliding_plan_keys_flagged_and_described():
    plan = plan_fft(_mesh(), (8, 8))
    plan._inv_spec = plan._fwd_spec
    assert "CON004" in check_plan(plan).codes()
    assert plan.verify().errors and plan.verified is False
    assert "FINDINGS" in plan.describe()
    with pytest.raises(PlanVerificationError, match="CON004"):
        plan.verify(strict=True)


def test_plan_fft_validate_modes(monkeypatch):
    mesh = _mesh()
    plan = plan_fft(mesh, (8, 8), validate="strict")
    assert plan.verified is True
    assert plan_fft(mesh, (8, 8)).verified is None     # off: not run
    with pytest.raises(ValueError, match="validate"):
        plan_fft(mesh, (8, 8), validate="paranoid")
    # a plan with findings: warn hands it back with a warning, strict
    # raises
    from repro_torch.core import api
    real = api.DistributedFFT.__init__

    def corrupting(self, *a, **kw):
        real(self, *a, **kw)
        self._inv_spec = self._fwd_spec

    monkeypatch.setattr(api.DistributedFFT, "__init__", corrupting)
    with pytest.warns(RuntimeWarning, match="CON004"):
        plan = plan_fft(mesh, (8, 8), validate="warn")
    assert plan.verified is False
    with pytest.raises(PlanVerificationError, match="CON004"):
        plan_fft(mesh, (8, 8), validate="strict")


def test_wisdom_key_audit_with_backend_restricted_keys():
    """The port's ``be=`` part names a problem of its own: a restricted
    key beside the unrestricted one is no collision, a reordered
    restricted key is one, and an unparseable key is a warning."""
    base = dict(grid=(16, 16), mesh_shape=(2, 2),
                mesh_axes=("data", "model"), kinds=("fft", "fft"),
                dtype="complex64", inverse=False)
    free = tuning_key(**base)
    kernel = tuning_key(**base, backends=("kernel",))
    assert kernel != free and ";be=kernel" in kernel
    clean = audit_plan_keys(tune_cache=_StubCache([free, kernel]),
                            include_global=False)
    assert len(clean) == 0
    reordered = ";".join(reversed(kernel.split(";")))
    rep = audit_plan_keys(tune_cache=_StubCache([free, kernel, reordered,
                                                 "junk"]),
                          include_global=False)
    assert _where(rep) == [["CON004", reordered], ["CON005", "junk"]]
    assert len(rep.errors) == 1


def test_prospective_keys_are_the_keys_the_builders_make():
    """The audit's keys come from the builders' own ``pipeline_key``: the
    fused pipelines and the executor's default segments of a plan land
    in ``GLOBAL_PLAN_CACHE`` under exactly the keys the audit predicts."""
    from repro_torch.analysis.contracts import prospective_plan_keys
    from repro_torch.core.plan import GLOBAL_PLAN_CACHE
    before = set(GLOBAL_PLAN_CACHE.keys())
    plan = plan_fft(_mesh(), (8, 8, 16), n_chunks=(2, 2))
    for inverse in (False, True):
        plan.segments(inverse=inverse)
    built = set(GLOBAL_PLAN_CACHE.keys()) - before
    predicted = dict(prospective_plan_keys(plan))
    assert len(predicted) == 8                 # 2 x (fused + 3 segments)
    assert set(predicted.values()) <= set(GLOBAL_PLAN_CACHE.keys())
    assert built <= set(predicted.values())
    assert {k[2] for k in predicted.values()} == {"complex64"}


def test_global_key_audit_reads_the_port_caches():
    """The cache-wide audit reads ``GLOBAL_PLAN_CACHE`` and the wrappers'
    memo: two meshes of one shape are two keys by design (the mesh is
    compared by identity), so they do not alias; a key part whose repr
    hides a difference does."""
    from repro_torch.analysis import contracts
    from repro_torch.core import api
    from repro_torch.core.api import _plan_memo_keys, fft2d
    m1, m2 = _mesh(), _mesh()
    x = _cx(np.random.default_rng(0), (8, 8))
    for m in (m1, m2):
        plan_fft(m, (8, 8)).forward(x)
        fft2d(x, mesh=m)
    assert len(_plan_memo_keys()) >= 2
    assert "CON004" not in audit_plan_keys().codes()

    class Opaque:
        def __init__(self, v):
            self.v = v

        def __eq__(self, other):
            return isinstance(other, Opaque) and other.v == self.v

        def __hash__(self):
            return hash(self.v)

        def __repr__(self):
            return "Opaque()"

    with api._PLAN_MEMO_LOCK:
        api._PLAN_MEMO[("probe", Opaque(1))] = None
        api._PLAN_MEMO[("probe", Opaque(2))] = None
    try:
        rep = audit_plan_keys()
        assert [d.severity for d in rep.by_code("CON004")] == ["warning"]
        assert "_PLAN_MEMO" in rep.by_code("CON004")[0].message
    finally:
        with api._PLAN_MEMO_LOCK:
            for k in [k for k in api._PLAN_MEMO if k[0] == "probe"]:
                del api._PLAN_MEMO[k]
    assert contracts.key_text((m1,)) != contracts.key_text((m2,))


# ---------------------------------------------------------------------------
# Timed model: SCHED003 / SCHED004 (fake-clock units)
# ---------------------------------------------------------------------------

def test_replay_watchdog_mirrors_step_watchdog():
    """The replay flags what the port's StepWatchdog flags, sample for
    sample."""
    assert replay_watchdog([1.0] * 20) == []
    assert replay_watchdog([1.0] * 7 + [50.0]) == []
    durations = [1.0] * 8 + [10.0, 10.0, 10.0, 1.5, 4.0]
    assert replay_watchdog(durations) == [8, 9, 10, 12]
    stamps, t = [], 0.0
    for d in durations:                  # start() and stop() read a stamp
        stamps += [t, t + d]
        t += d
    clock = iter(stamps)
    wd = StepWatchdog(tolerance=2.0, window=32, timer=lambda: next(clock))
    for step, _ in enumerate(durations):
        wd.start(step)
        wd.stop()
    assert [s for s, _ in wd.flagged] == replay_watchdog(durations)


def test_sched004_watchdog_false_flag_window():
    order, entries = _fake_queue([[1.0] * 10 + [10.0]])
    rep = check_timed_schedule(order, entries, mode="timed")
    assert rep.codes() == ["SCHED004"]
    assert all(d.severity == "warning" for d in rep)
    assert not check_timed_schedule(order, entries, mode="timed",
                                    watchdog=StepWatchdog(tolerance=16.0))
    assert not check_timed_schedule(order, entries, mode="async")


def test_timed_check_takes_the_wired_watchdogs_window():
    """The replay is a fresh watchdog with the wired one's tolerance and
    window: a 12-segment comm chain outlasts an 8-sample window's span
    but not the default 32-sample one's."""
    order, entries = _fake_queue([[1.0] * 12, [1.0, 1.0]],
                                 kinds=["comm", "comp"])
    assert "SCHED003" not in check_timed_schedule(
        order, entries, mode="timed").codes()
    assert "SCHED003" in check_timed_schedule(
        order, entries, mode="timed",
        watchdog=StepWatchdog(window=8)).codes()
    durations = [1.0] * 8 + [3.0]
    assert replay_watchdog(durations) == [8]
    assert replay_watchdog(durations, StepWatchdog(tolerance=4.0)) == []


def test_sched003_timed_mode_starvation():
    order, entries = _fake_queue([[1.0] * 40, [1.0, 1.0]],
                                 kinds=["comm", "comp"])
    rep = check_timed_schedule(order, entries, mode="timed")
    assert "SCHED003" in rep.codes()
    order2, entries2 = _fake_queue([[1.0] * 8, [1.0, 1.0]],
                                   kinds=["comm", "comp"])
    assert "SCHED003" not in check_timed_schedule(
        order2, entries2, mode="timed").codes()
    order3, entries3 = _fake_queue([[1.0] * 40, [1.0, 1.0]],
                                   kinds=["comp", "comp"])
    assert "SCHED003" not in check_timed_schedule(
        order3, entries3, mode="timed").codes()


def test_sched003_pool_mode_steal_gate():
    chains = [[1.0] * 40, [0.5, 0.5], [1.0]]
    order, entries = _fake_queue(chains, kinds=["comm", "comp", "comp"],
                                 streams=[0, 0, 1])
    rep = check_timed_schedule(order, entries, mode="pool",
                               cost_model=CostModel(steal_overhead_s=10.0))
    assert "SCHED003" in rep.codes()
    assert not check_timed_schedule(order, entries, mode="pool",
                                    cost_model=CostModel())


# ---------------------------------------------------------------------------
# Differential sanitizer: SAN001
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["async", "pool", "timed"])
def test_sanitizer_clean_on_faithful_executor(mode):
    """sanitize=True on the real executor: the trace matches the model in
    every mode — launches in turn order, zero SAN001, results equal to the
    solo runs and the donated operand emptied."""
    mesh = _mesh()
    ex = PlanStreamExecutor(mode=mode, sanitize=True, verify="strict")
    queue = _three_entry_queue(mesh)
    refs = [plan(x.clone()) for plan, x, _ in queue]
    for plan, x, donate in queue:
        ex.submit(plan, x, donate=donate)
    with warnings.catch_warnings():
        warnings.simplefilter("error")         # any SAN001 warning -> fail
        outs = ex.run()
    assert len(ex.last_sanitize_report()) == 0
    trace = ex.last_trace()
    assert len(trace.events) == len(trace.buffers) > 0
    assert [e.turn for e in trace.events] == list(range(len(trace.events)))
    assert trace.launch_order() == [(s.entry, s.index)
                                    for s in ex.last_schedule]
    assert trace.mode == mode
    fates = {b.tag: (b.expect_deleted, b.deleted) for b in trace.buffers}
    assert fates["entry2/seg0"] == (True, True)
    assert fates["entry0/seg0"] == (False, False)
    assert released(queue[2][1]) and not released(queue[0][1])
    payload = ex.sanitize_json()
    json.dumps(payload)
    assert payload["diff"]["san001"] == 0
    if mode == "timed":
        assert all(e.wall_s > 0 for e in trace.events)
    for y, ref in zip(outs, refs):
        assert torch.equal(y, ref)


def test_san001_order_divergence_from_mismodeled_executor():
    findings = []
    ex = MisModeled(sanitize=True, verify_sink=findings.append)
    for plan, x, _ in _three_entry_queue(_mesh())[:2]:
        ex.submit(plan, x)
    ex.run()
    rep = ex.last_sanitize_report()
    assert "SAN001" in rep.codes()
    assert findings and "SAN001" in findings[-1].codes()
    assert ex.sanitize_json()["diff"]["san001"] >= 1


def test_san001_donation_divergence():
    findings = []
    ex = NoDonate(sanitize=True, verify_sink=findings.append)
    p = plan_fft(_mesh(), (8, 8))
    x = _cx(np.random.default_rng(11), (8, 8))
    ex.submit(p, x, donate=True, sharded_in=True)
    ex.run()
    assert not released(x)                     # the runtime really diverged
    rep = ex.last_sanitize_report()
    assert "SAN001" in rep.codes()
    assert any("donat" in d.message for d in rep if d.code == "SAN001")
    assert findings and "SAN001" in findings[-1].codes()


def test_sanitizer_holds_no_buffer_past_its_launch():
    """The trace keeps each buffer's fate, not the buffer: with interior
    segments not donating, a segment's input is freed once the next
    segment took its output, in the middle of a sanitized run."""
    import gc
    import weakref

    inputs, alive_at_last = [], []

    class Spy(PlanStreamExecutor):
        def _segment_exes(self, entry):
            fns = super()._segment_exes(entry)

            def watch(j, fn):
                def call(v):
                    if j == len(fns) - 1:
                        gc.collect()
                        alive_at_last.extend(r() is not None
                                             for r in inputs[1:])
                    inputs.append(weakref.ref(v))
                    return fn(v)
                return call
            return [watch(j, fn) for j, fn in enumerate(fns)]

    ex = Spy(sanitize=True, donate_intermediates=False)
    plan = plan_fft(_mesh(), (8, 8, 16))
    x = _cx(np.random.default_rng(13), (8, 8, 16))
    ex.submit(plan, x)
    y = ex.run()[0]
    assert torch.equal(y, plan(x))
    assert len(inputs) == 3 and alive_at_last == [False]
    assert [b.deleted for b in ex.last_trace().buffers] == [False] * 3
    assert len(ex.last_sanitize_report()) == 0


def test_diff_ranks_reports_every_other_order():
    same = [(0, 0), (1, 0), (0, 1)]
    assert not diff_ranks([same, same, same], 0)
    odd = [(1, 0), (0, 0), (0, 1)]
    rep0 = diff_ranks([same, odd, same], 0)
    assert _where(rep0) == [["SAN001", "ranks@0"]]
    rep1 = diff_ranks([same, odd, same], 1)
    assert len(rep1) == 2                      # against ranks 0 and 2
    short = diff_ranks([same, same[:2]], 0)
    assert _where(short) == [["SAN001", "ranks@2"]]


# ---------------------------------------------------------------------------
# 4 gloo ranks: sanitize in every mode, the ranks' order check, refusal
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("analysis"))
    out = run_ranks("analysis_body", 4, root, "cpu")
    recs = []
    for rank in range(4):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            recs.append(json.load(f))
    return recs


@pytest.mark.parametrize("mode", ["async", "pool", "timed"])
def test_sanitize_on_four_ranks(gloo, mode):
    """0 SAN001 (including the ranks' order check), no verify error,
    outputs bitwise equal to solo, the donated operand emptied as the
    donation table says, and every rank launched one order."""
    for rec in gloo:
        r = rec[mode]
        assert r["bitwise"] == [True] * 5
        assert r["sanitize"] == [] and r["san001"] == 0
        assert r["verify_errors"] == []
        assert r["donated_emptied"]
        assert r["turns"] == list(range(len(r["turns"])))
        assert all(want == got for _, want, got in r["fates"])
        assert r["order"] == gloo[0][mode]["order"]


def test_ranks_order_check_catches_one_skewed_rank(gloo):
    """Rank 1 reports its launches in another order: every rank's report
    names the difference (the all-gathered order check), rank 1 also
    diverges from its own model."""
    for rank, rec in enumerate(gloo):
        wheres = [w for code, w in rec["skewed"] if code == "SAN001"]
        assert any(w.startswith("ranks@") for w in wheres), rank
        assert rec["skewed_sink"] == [rec["skewed"]]
        own = [w for w in wheres if not w.startswith("ranks@")]
        assert bool(own) == (rank == 1), (rank, own)


def test_unserialized_pool_refused_on_four_ranks(gloo):
    for rec in gloo:
        u = rec["unserialized"]
        assert [c for c, _ in u["static"]] == ["SCHED001"]
        assert u["refused"] == u["static"]
        assert u["queued"] == 5 and all(u["outs"])


# ---------------------------------------------------------------------------
# Serving: verify findings as metrics counters; serve_fft --verify
# ---------------------------------------------------------------------------

@pytest.fixture
def no_calibration(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_CALIBRATE", "off")
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(tmp_path / "w.json"))


def test_service_strict_verify_smoke(no_calibration):
    from repro_torch.serving import FFTService
    svc = FFTService(_mesh(), bucket_edges=(8, 16), verify="strict")
    x = _cx(np.random.default_rng(5), (8, 8))
    rid = svc.submit(x)
    results = svc.drain()
    ref = np.fft.fftn(x.numpy())
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    assert float(np.max(np.abs(results[rid].y.numpy() - ref))) / scale \
        < 1e-4
    assert svc.executor.last_verify_report() is not None
    assert not len(svc.executor.last_verify_report())


def test_verify_findings_feed_serving_metrics(no_calibration):
    from repro_torch.serving import FFTService
    svc = FFTService(_mesh(), bucket_edges=(8, 16), verify="warn")
    assert svc.executor.verify_sink == svc.metrics.record_verify_findings
    svc.submit(_cx(np.random.default_rng(9), (8, 8)))
    svc.drain()
    assert svc.metrics.verify_findings == {}
    svc.executor.verify_sink(DiagnosticReport([
        Diagnostic(code="SCHED004", severity="warning", message="w1"),
        Diagnostic(code="ALIAS002", severity="error", message="e1")]))
    svc.executor.verify_sink(DiagnosticReport([
        Diagnostic(code="SCHED004", severity="warning", message="w2")]))
    assert svc.metrics.verify_findings == {"SCHED004": 2, "ALIAS002": 1}
    snap = svc.metrics.to_json()
    json.dumps(snap)
    assert snap["verify_warnings"] == {"SCHED004": 2, "ALIAS002": 1}
    assert FFTService(_mesh(), bucket_edges=(8, 16)).executor.verify_sink \
        is None


def test_serve_fft_driver_with_strict_verify(no_calibration, tmp_path):
    from repro_torch.launch.serve_fft import main, serve_fft
    snap = serve_fft(requests=8, round_size=4, device="cpu", check=True,
                     verify="strict", verbose=False)
    assert snap["verify_warnings"] == {}
    assert snap["driver"]["verify"] == "strict"
    out = tmp_path / "m.json"
    main(["--device", "cpu", "--requests", "4", "--round-size", "4",
          "--verify", "warn", "--json", str(out)])
    assert json.loads(out.read_text())["driver"]["verify"] == "warn"
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--verify", "loud"])


# ---------------------------------------------------------------------------
# The port's lint
# ---------------------------------------------------------------------------

def _codes(report):
    return [d.code for d in report]


def test_rep001_version_sensitive_torch_apis_outside_compat():
    from repro_torch.analysis.lint import lint_source
    src = ("from torch.distributed.device_mesh import init_device_mesh\n"
           "import torch\n"
           "import torch.distributed as dist\n"
           "a = torch._C._get_tracing_state()\n"
           "b = dist._functional_collectives\n"
           "from torch.distributed._tensor import DeviceMesh\n"
           "def f(prof):\n"
           "    return prof.self_cuda_time_total\n")
    path = "src/repro_torch/core/foo.py"
    assert _codes(lint_source(src, path)).count("REP001") == 5
    # the compat shim is the one allowed home
    assert "REP001" not in _codes(lint_source(
        src, "src/repro_torch/compat.py"))
    public = ("import torch\nimport torch.distributed as dist\n"
              "v = torch.__version__\n"
              "dist.all_to_all_single\n"
              "torch.cuda.Stream\n"
              "def f(prof):\n"
              "    return getattr(prof, 'self_device_time_total', 0)\n")
    assert "REP001" not in _codes(lint_source(public, path))


def test_rep002_wall_clock_requires_injectable_timer():
    from repro_torch.analysis.lint import lint_source
    bare = ("import time\n"
            "def measure():\n"
            "    t0 = time.perf_counter()\n"
            "    return time.perf_counter() - t0\n")
    assert _codes(lint_source(bare, "src/repro_torch/m.py")).count(
        "REP002") == 2
    injectable = ("import time\n"
                  "def measure(timer=time.perf_counter):\n"
                  "    t0 = time.perf_counter()\n"
                  "    return time.perf_counter() - t0\n")
    assert "REP002" not in _codes(lint_source(injectable,
                                              "src/repro_torch/m.py"))
    cls = ("import time\n"
           "class M:\n"
           "    def __init__(self, timer=time.perf_counter):\n"
           "        self.timer = timer\n"
           "    def measure(self):\n"
           "        return time.perf_counter()\n")
    assert "REP002" not in _codes(lint_source(cls, "src/repro_torch/m.py"))
    ts = "import time\ndef f():\n    return time.time()\n"
    assert "REP002" not in _codes(lint_source(ts, "src/repro_torch/m.py"))


def test_rep003_wisdom_write_outside_locked_path():
    from repro_torch.analysis.lint import lint_source
    src = ("def dump(d):\n"
           "    with open('wisdom.json', 'w') as f:\n"
           "        f.write(d)\n")
    assert "REP003" in _codes(lint_source(src, "src/repro_torch/core/x.py"))
    assert "REP003" not in _codes(lint_source(
        src, "src/repro_torch/core/plan.py"))
    rd = "def load():\n    return open('tuning.json').read()\n"
    assert "REP003" not in _codes(lint_source(rd,
                                              "src/repro_torch/core/x.py"))


def test_rep004_unbounded_module_cache():
    from repro_torch.analysis.lint import lint_source
    assert "REP004" in _codes(lint_source("_PLAN_CACHE = {}\n",
                                          "src/repro_torch/c.py"))
    evicting = ("_PLAN_CACHE = {}\n"
                "def put(k, v):\n"
                "    if len(_PLAN_CACHE) > 64:\n"
                "        _PLAN_CACHE.popitem()\n"
                "    _PLAN_CACHE[k] = v\n")
    assert "REP004" not in _codes(lint_source(evicting,
                                              "src/repro_torch/c.py"))
    assert "REP004" not in _codes(lint_source("_TABLE = {}\n",
                                              "src/repro_torch/c.py"))


def test_rep005_has_no_counterpart():
    """The port traces no shard_map body, so a side effect in a function
    handed to something called shard_map is not flagged: REP005 is not a
    rule of the port's lint."""
    from repro_torch.analysis.lint import RULES, lint_source
    src = ("def body(x):\n"
           "    print('once per call')\n"
           "    return x\n"
           "def run(shard_map, mesh, x):\n"
           "    return shard_map(body, mesh=mesh)(x)\n")
    assert _codes(lint_source(src, "src/repro_torch/k.py")) == []
    assert "REP005" not in RULES


def test_suppression_needs_a_reason():
    from repro_torch.analysis.lint import lint_source
    with_reason = ("import time\n"
                   "def f():\n"
                   "    return time.perf_counter()"
                   "  # repro-lint: disable=REP002 driver wall-clock\n")
    assert "REP002" not in _codes(lint_source(with_reason,
                                              "src/repro_torch/d.py"))
    bare = ("import time\n"
            "def f():\n"
            "    return time.perf_counter()  # repro-lint: disable=REP002\n")
    assert "REP002" in _codes(lint_source(bare, "src/repro_torch/d.py"))


def test_rep000_syntax_error_and_cli(tmp_path):
    from repro_torch.analysis.lint import lint_source, main
    assert "REP000" in _codes(lint_source("def f(:\n", "src/repro_torch/b.py"))
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\nx = torch._C\n")
    out = tmp_path / "diag.json"
    assert main([str(bad), "--json", str(out)]) == 1
    payload = json.loads(out.read_text())
    assert any(d["code"] == "REP001" for d in payload["diagnostics"])
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    assert main([str(clean)]) == 0
    assert main([str(tmp_path / "*.py"), "--select", "REP002"]) == 0


def test_port_lint_whole_port_is_clean():
    """``python -m repro_torch.analysis.lint`` over the port, its tests,
    their harness and chip_smoke.py: zero findings."""
    from repro_torch.analysis.lint import DEFAULT_PATHS, lint_paths
    root = os.path.join(os.path.dirname(__file__), "..")
    report = lint_paths([os.path.join(root, p) for p in DEFAULT_PATHS])
    assert len(report) == 0, "\n" + report.render()


def test_port_lint_cli_runs_as_a_module():
    import subprocess
    import sys
    root = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint"],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "0 finding(s)" in res.stderr
