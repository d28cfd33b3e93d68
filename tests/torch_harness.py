"""Helpers for the tests of the PyTorch port (``tests/test_torch_*.py``).

* seeded numpy inputs and a max-scaled closeness assertion;
* :func:`run_ranks` — spawn ``world`` gloo ranks (or NCCL ranks, one
  card each; file rendezvous in a temporary directory, never a fixed port,
  so parallel test workers do not collide), each running one of the rank
  bodies below; bodies save their results as ``.npy`` files for the test
  to read;
* :func:`run_reference` — run a JAX snippet with N fake XLA devices in a
  fresh process (``conftest.run_subprocess``);
* :func:`pallas_lines_c128` — the JAX package's Pallas FFT kernel on
  complex128 lines, in interpret mode under ``jax_enable_x64`` in such a
  process.

This module imports no JAX: the spawned ranks import it.
"""
from __future__ import annotations

import json
import os
import time
from typing import Sequence

import numpy as np
import torch

RANK_TIMEOUT_S = 300


def rough_sum(n: int) -> int:
    """The sum of the prime factors of ``n`` >= 1 past 13, each as often
    as it divides ``n``, by trial division."""
    total, p = 0, 2
    while p * p <= n:
        while n % p == 0:
            total, n = total + (p if p > 13 else 0), n // p
        p += 1
    return total + (n if n > 13 else 0)


def dense_keeps(n: int, cost: dict, margin: float,
                fold_sizes: tuple = (), itemsize: int = 8) -> bool:
    """The dense route's rule for an N up to its limit, restated from
    ``cost`` (``dense.GENERIC_COST[dtype]``): the sum of N's prime factors
    past 13 times the weight of N's parity plus that parity's base,
    times N, against ``margin`` times the chirp's cost: the least over
    the 13-smooth M from 2N - 1 to twice that of M times the chirp's cost
    per element, on the long-line route at ``fold_sizes``
    (``longline.FOLD_SIZES[dtype]``), else on the dense route's kernel
    (M's line fits one block there): a base for lines sharing a block (M
    up to 2048) or one a block, plus a weight per stage of M's chain (a
    stage per odd prime factor, a 4 or a 2 per two factors of 2) and one
    per share of a block's 232448 bytes that a line of ``itemsize``-byte
    elements fills."""
    s = rough_sum(n)
    if s == 0:
        return True
    base, weight = cost["odd"] if n % 2 == 1 else cost["even"]
    per_m = cost["chirp"]
    chirp = float("inf")
    for m in range(2 * n - 1, 4 * n - 1):
        if m in fold_sizes:
            chirp = min(chirp, m * per_m["long"])
        elif is_smooth(m):
            twos = (m & -m).bit_length() - 1
            stages = sum(1 for _ in _odd_factors(m)) + (twos + 1) // 2
            tile = per_m["share"] if m <= 2048 else per_m["line"]
            chirp = min(chirp, m * (tile + per_m["stage"] * stages
                                    + per_m["fill"] * m * itemsize / 232448))
    return (base + weight * s) * n <= margin * chirp


def _odd_factors(m: int):
    """The odd prime factors of a 13-smooth ``m``, each as often as it
    divides ``m``."""
    for p in (3, 5, 7, 11, 13):
        while m % p == 0:
            m //= p
            yield p


def is_smooth(m: int) -> bool:
    """Whether ``m`` >= 1 has no prime factor past 13."""
    for p in (2, 3, 5, 7, 11, 13):
        while m % p == 0:
            m //= p
    return m == 1


def cplx(shape, seed: int, dtype=np.complex64) -> np.ndarray:
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape) + 1j * r.standard_normal(shape)
            ).astype(dtype)


def scaled_err(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if ref.size == 0:
        return 0.0
    scale = max(float(np.max(np.abs(ref))), 1e-9)
    return float(np.max(np.abs(got - ref))) / scale


def assert_scaled_close(got, ref, atol: float) -> None:
    err = scaled_err(got, ref)
    assert err <= atol, f"max-scaled error {err:.3e} > {atol}"


def run_reference(code: str, devices: int = 4) -> str:
    """Run a JAX snippet in a fresh process with ``devices`` CPU devices."""
    from conftest import run_subprocess
    return run_subprocess(code, devices=devices)


X64_PALLAS = """
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np, jax.numpy as jnp
from repro.kernels.fft_matmul import fft1d_planes
data = np.load({path!r})
out = {{}}
for key in data.files:
    if not key.startswith("x_"):
        continue
    name = key[2:]
    x = data[key]
    inv, parts = bool(data["inv_" + name]), int(data["parts_" + name])
    tw = None
    if "tw_" + name in data.files:
        t = data["tw_" + name]
        tw = (jnp.asarray(t.real), jnp.asarray(t.imag))
    yr, yi = fft1d_planes(jnp.asarray(x.real), jnp.asarray(x.imag),
                          inverse=inv, twiddle=tw,
                          pack_parts=parts or None)
    out[name] = np.asarray(yr) + 1j * np.asarray(yi)
    print(name, yr.dtype)
np.savez({out!r}, **out)
"""


def pallas_lines_c128(cases: dict, root: str) -> dict:
    """The Pallas kernel's complex128 results, name -> output, for
    ``cases``, name -> (x, twiddle or None, inverse, pack_parts or None):
    ``fft1d_planes`` in interpret mode under ``jax_enable_x64``, all cases
    in one fresh process, with ``root`` holding its input and output."""
    arrays = {}
    for name, (x, t, inv, parts) in cases.items():
        arrays.update({"x_" + name: x, "inv_" + name: np.array(inv),
                       "parts_" + name: np.array(parts or 0)})
        if t is not None:
            arrays["tw_" + name] = t
    path, out = os.path.join(root, "in.npz"), os.path.join(root, "out.npz")
    np.savez(path, **arrays)
    log = run_reference(X64_PALLAS.format(path=path, out=out), devices=1)
    assert "float64" in log and "float32" not in log
    return dict(np.load(out))


# ---------------------------------------------------------------------------
# Multi-rank runs over gloo (CPU) or NCCL (one card per rank)
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, init_file: str, body: str,
               out_dir: str, args: tuple, backend: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        globals()[body](rank, out_dir, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(body: str, world: int, tmp_path, *args,
              timer=time.monotonic, backend: str = "gloo") -> str:
    """Run ``body(rank, out_dir, *args)`` on ``world`` spawned ranks of
    the ``backend`` process group (``"nccl"``: rank r on card r).

    Returns the output directory.  Raises if any rank fails or the run
    outlives ``RANK_TIMEOUT_S``.
    """
    import torch.multiprocessing as mp
    out_dir = os.path.join(str(tmp_path), f"ranks_{body}")
    os.makedirs(out_dir, exist_ok=True)
    init_file = os.path.join(str(tmp_path), f"rendezvous_{body}")
    ctx = mp.start_processes(_rank_main,
                             args=(world, init_file, body, out_dir, args,
                                   backend),
                             nprocs=world, join=False, start_method="spawn")
    deadline = timer() + RANK_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if timer() > deadline:
                raise TimeoutError(f"{body} ranks did not finish in "
                                   f"{RANK_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return out_dir


def _cpu_mesh(shape: Sequence[int]):
    from repro_torch.compat import make_mesh
    return make_mesh(tuple(shape), ("data", "model")[:len(shape)],
                     device="cpu")


def pipeline_body(rank: int, out_dir: str, x_path: str, grid,
                  mesh_shape, backends, decomps) -> None:
    """Forward, inverse and round trip of one plan per (decomp, backend);
    rank 0 saves the gathered global results, and every rank how often its
    stages stored a packed send buffer."""
    from repro_torch.compat import gather
    from repro_torch.core.api import plan_fft
    from repro_torch.kernels import ops
    mesh = _cpu_mesh(mesh_shape)
    x = torch.from_numpy(np.load(x_path))
    packs = {"n": 0}
    packed_fft1d = ops.packed_fft1d

    def counting(*a, **kw):
        packs["n"] += 1
        return packed_fft1d(*a, **kw)

    ops.packed_fft1d = counting
    stats = {}
    try:
        for decomp in decomps:
            for be in backends:
                packs["n"] = 0
                plan = plan_fft(mesh, grid, backend=be, decomp=decomp)
                y = plan.forward(x)
                fwd = gather(y, plan.out_struct.spec, mesh)
                rt = gather(plan.inverse(y, sharded_in=True),
                            plan.inv_out_struct.spec, mesh)
                inv = gather(plan.inverse(x), plan.inv_out_struct.spec, mesh)
                stats[f"{decomp}_{be}"] = {"packs": packs["n"],
                                           "local_out": list(y.shape)}
                if rank == 0:
                    for name, arr in (("fwd", fwd), ("inv", inv),
                                      ("rt", rt)):
                        np.save(os.path.join(
                            out_dir, f"{name}_{decomp}_{be}.npy"),
                            arr.numpy())
    finally:
        ops.packed_fft1d = packed_fft1d
    with open(os.path.join(out_dir, f"stats{rank}.json"), "w") as f:
        json.dump(stats, f)


def r2r_pipeline_body(rank: int, out_dir: str, x_path: str, grid, cases,
                      backends, decomps) -> None:
    """Forward and round trip of one plan per (named kinds case, decomp,
    backend) on a real operand; rank 0 saves the gathered global results,
    and every rank the dtype and shape of its forward output block."""
    from repro_torch.compat import gather
    from repro_torch.core.api import plan_fft
    mesh = _cpu_mesh((2, 2))
    x = torch.from_numpy(np.load(x_path))
    stats = {}
    for name, kinds in cases:
        for decomp in decomps:
            for be in backends:
                tag = f"{name}_{decomp}_{be}"
                plan = plan_fft(mesh, grid, kinds=kinds, backend=be,
                                decomp=decomp)
                y = plan.forward(x)
                back = plan.inverse(y, sharded_in=True)
                stats[tag] = {"out_dtype": str(y.dtype).removeprefix("torch."),
                              "local_out": list(y.shape)}
                fwd = gather(y, plan.out_struct.spec, mesh)
                rt = gather(back, plan.inv_out_struct.spec, mesh)
                if rank == 0:
                    np.save(os.path.join(out_dir, f"fwd_{tag}.npy"),
                            fwd.numpy())
                    np.save(os.path.join(out_dir, f"rt_{tag}.npy"),
                            rt.numpy())
    with open(os.path.join(out_dir, f"stats{rank}.json"), "w") as f:
        json.dump(stats, f)


def poisson_body(rank: int, out_dir: str, rhs_path: str, batch_path: str,
                 backends, topologies) -> None:
    """Pressure solves on a 2x2 mesh: one ``PoissonSolver`` per (topology,
    backend) on the 3-D rhs, and ``poisson_solve`` on the batched rhs and on
    each of its slices; rank 0 saves the gathered global results."""
    from repro_torch.compat import gather
    from repro_torch.core.api import PoissonSolver, poisson_solve
    mesh = _cpu_mesh((2, 2))
    rhs = torch.from_numpy(np.load(rhs_path))
    rhs_b = torch.from_numpy(np.load(batch_path))
    out = {}
    for be in backends:
        for name, topo in topologies:
            solver = PoissonSolver(mesh, rhs.shape, topology=topo,
                                   backend=be)
            spec = solver.plan.inv_out_struct.spec
            out[f"phi_{name}_{be}"] = gather(solver(rhs), spec, mesh)
            out[f"batched_{name}_{be}"] = gather(
                poisson_solve(rhs_b, mesh=mesh, topology=topo, backend=be),
                (None,) + spec, mesh)
            for i in range(rhs_b.shape[0]):
                out[f"slice{i}_{name}_{be}"] = gather(
                    poisson_solve(rhs_b[i], mesh=mesh, topology=topo,
                                  backend=be), spec, mesh)
    if rank == 0:
        for name, arr in out.items():
            np.save(os.path.join(out_dir, f"{name}.npy"), arr.numpy())


def redistribute_body(rank: int, out_dir: str, cases) -> None:
    """For each (decomp spec, grid, batch) case, replay every hop of the
    forward and inverse stage order on this rank's block and record whether
    each landed block equals the global array's block under the next
    stage's declared spec (also when the first move gets a packed send
    buffer), for a complex64 block and for a float32 one."""
    from repro_torch.compat import local_block
    from repro_torch.core.decomp import make_decomposition
    from repro_torch.core.redistribute import (PackedBlock, redistribute,
                                               send_buffer)
    mesh = _cpu_mesh((2, 2))
    results = []
    for i, (kind, axes, ndim, groups, grid, batch) in enumerate(cases):
        dec = make_decomposition(kind, tuple(axes), ndim,
                                 dim_groups=groups)
        x = torch.from_numpy(cplx(tuple(batch) + tuple(grid), 100 + i))
        off = len(batch)
        lead = (None,) * off
        for inverse in (False, True):
            stages = list(dec.stages)
            hops = list(dec.redists)
            if inverse:
                stages, hops = stages[::-1], [h.inverse() for h in hops[::-1]]
            for j, hop in enumerate(hops):
                src = local_block(x, lead + stages[j].spec, mesh)
                want = local_block(x, lead + stages[j + 1].spec, mesh)
                got = redistribute(src, hop, mesh=mesh, spatial_offset=off)
                ok = bool(torch.equal(got, want))
                mv = hop.moves[0]
                p = mesh.axis_sizes[mv.mesh_axis]
                split = mv.split_dim + off
                if p > 1:
                    packed = PackedBlock(send_buffer(src, split, p), split)
                    got2 = redistribute(packed, hop, mesh=mesh,
                                        spatial_offset=off)
                    ok = ok and bool(torch.equal(got2, want))
                # the same hop on the real part: float32 blocks
                got_r = redistribute(src.real.contiguous(), hop, mesh=mesh,
                                     spatial_offset=off)
                ok_real = (got_r.dtype == torch.float32
                           and bool(torch.equal(got_r, want.real)))
                results.append([i, inverse, j, ok, ok_real])
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)


def chunked_body(rank: int, out_dir: str, x_path: str, xr_path: str, grid,
                 cases) -> None:
    """For each (name, kinds, decomp, backend, n_chunks) case on a 2x2
    mesh: the chunked plan's forward and round trip and the bulk plan's
    forward, with the kernel's packed stores counted per direction; rank 0
    saves the gathered results.  Then a recorded run of one chunked hop:
    every exchange issue and every ``then`` call, in order."""
    import importlib
    import warnings
    from repro_torch.compat import gather, local_block
    from repro_torch.core.api import plan_fft
    from repro_torch.core.decomp import make_decomposition
    from repro_torch.kernels import ops
    tred = importlib.import_module("repro_torch.core.redistribute")
    mesh = _cpu_mesh((2, 2))
    xc = torch.from_numpy(np.load(x_path))
    xr = torch.from_numpy(np.load(xr_path))
    packs = {"n": 0}
    packed_fft1d = ops.packed_fft1d

    def counting(*a, **kw):
        packs["n"] += 1
        return packed_fft1d(*a, **kw)

    ops.packed_fft1d = counting
    stats = {}
    try:
        for name, kinds, decomp, backend, n_chunks in cases:
            x = xc if kinds == ("fft",) * len(grid) else xr
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                plan = plan_fft(mesh, grid, kinds=kinds, decomp=decomp,
                                backend=backend, n_chunks=n_chunks)
                bulk = plan_fft(mesh, grid, kinds=kinds, decomp=decomp,
                                backend=backend)
                packs["n"] = 0
                y = plan.forward(x)
                fwd_packs = packs["n"]
                packs["n"] = 0
                back = plan.inverse(y, sharded_in=True)
                inv_packs = packs["n"]
                yb = bulk.forward(x)
            stats[name] = {
                "fwd_schedule": list(plan.pipeline_spec().chunk_schedule),
                "inv_schedule": list(
                    plan.pipeline_spec(inverse=True).chunk_schedule),
                "fwd_packs": fwd_packs, "inv_packs": inv_packs,
                "warnings": [str(w.message) for w in caught]}
            out = {"fwd": gather(y, plan.out_struct.spec, mesh),
                   "rt": gather(back, plan.inv_out_struct.spec, mesh),
                   "bulk": gather(yb, bulk.out_struct.spec, mesh)}
            if rank == 0:
                for key, arr in out.items():
                    np.save(os.path.join(out_dir, f"{key}_{name}.npy"),
                            arr.numpy())
    finally:
        ops.packed_fft1d = packed_fft1d

    # The overlap order: chunk k+1's exchange is issued before `then` runs
    # on chunk k.
    events = []
    issue = tred._issue

    def recording_issue(x, *a, **kw):
        events.append("issue")
        return issue(x, *a, **kw)

    def then(t):
        events.append("then")
        return t * 2

    dec = make_decomposition("pencil", ("data", "model"), 3)
    full = torch.from_numpy(cplx(tuple(grid), 77))
    block = local_block(full, dec.stages[0].spec, mesh)
    tred._issue = recording_issue
    try:
        got = tred.redistribute(block, dec.redists[0], mesh=mesh, n_chunks=4,
                                then=then, avoid_dims=dec.stages[1].fft_dims,
                                hop_index=0)
    finally:
        tred._issue = issue
    want = local_block(full, dec.stages[1].spec, mesh) * 2
    stats["recorder"] = {"events": events,
                         "equal": bool(torch.equal(got, want))}
    with open(os.path.join(out_dir, f"stats{rank}.json"), "w") as f:
        json.dump(stats, f)


def tuner_body(rank: int, out_dir: str, x_path: str, grid,
               cache_path: str) -> None:
    """``tuning="auto"`` on a 2x2 mesh with one wisdom file: every rank
    saves the tuned plan and the profile it planned with, rank 0 the
    gathered forward; then a second plan on the same file, with the
    measurements counted."""
    from repro_torch.compat import gather
    from repro_torch.core import tuner
    from repro_torch.core.api import plan_fft
    from repro_torch.core.perfmodel import platform_name
    from repro_torch.core.plan import TuningCache
    mesh = _cpu_mesh((2, 2))
    x = torch.from_numpy(np.load(x_path))
    cache = TuningCache(cache_path)
    plan = plan_fft(mesh, grid, tuning="auto", tune_cache=cache)
    y = gather(plan.forward(x), plan.out_struct.spec, mesh)
    profile = tuner.resolve_profile(cache, mesh=mesh)
    calls = {"n": 0}
    measure = tuner.measure_candidate

    def counting(*a, **kw):
        calls["n"] += 1
        return measure(*a, **kw)

    tuner.measure_candidate = counting
    try:
        again = plan_fft(mesh, grid, tuning="auto",
                         tune_cache=TuningCache(cache_path))
    finally:
        tuner.measure_candidate = measure
    record = {"tuned": plan.tuned.to_json(), "again": again.tuned.to_json(),
              "profile": profile.to_json(), "second_measurements": calls["n"],
              "stored_profile": cache.get_machine(platform_name(mesh.device))
              is not None}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)
    if rank == 0:
        np.save(os.path.join(out_dir, "fwd.npy"), y.numpy())


def nccl_body(rank: int, out_dir: str, x_path: str, grid, cache_path: str,
              repeats: int, device=None) -> None:
    """On a 2x2 mesh of cards (``device=None``; ``"cpu"`` rehearses it
    over gloo): kernel and cufft plans, bulk and chunked (the exchanges of
    chunk k+1 in flight under chunk k's stage), forward and round trip,
    with the best-of-``repeats`` ms per forward (CUDA events on a card);
    then ``tuning="auto"`` on one wisdom file.  Rank 0 saves the gathered
    results."""
    import torch.distributed as dist
    from repro_torch.compat import gather, make_mesh
    from repro_torch.core import tuner
    from repro_torch.core.api import plan_fft
    from repro_torch.core.perfmodel import _time_best, platform_name
    from repro_torch.core.plan import TuningCache
    mesh = make_mesh((2, 2), ("data", "model"), device=device)
    x = torch.from_numpy(np.load(x_path)).to(mesh.device)
    record = {"cases": {}, "card": platform_name(mesh.device)}
    for backend in ("kernel", "cufft"):
        for n_chunks in (1, 2, (2, 4)):
            plan = plan_fft(mesh, grid, backend=backend, n_chunks=n_chunks)
            y = plan.forward(x)
            back = plan.inverse(y, sharded_in=True)
            name = f"{backend}_{n_chunks}".replace(" ", "")
            fwd = gather(y, plan.out_struct.spec, mesh)
            rt = gather(back, plan.inv_out_struct.spec, mesh)
            dist.barrier()
            record["cases"][name] = {
                "schedule": list(plan.pipeline_spec().chunk_schedule),
                "fwd_ms": 1e3 * _time_best(lambda: plan.forward(x), repeats,
                                           mesh.device)}
            if rank == 0:
                np.save(os.path.join(out_dir, f"fwd_{name}.npy"),
                        fwd.cpu().numpy())
                np.save(os.path.join(out_dir, f"rt_{name}.npy"),
                        rt.cpu().numpy())
    cache = TuningCache(cache_path)
    tuned = plan_fft(mesh, grid, tuning="auto", tune_cache=cache)
    y = gather(tuned.forward(x), tuned.out_struct.spec, mesh)
    record["tuned"] = tuned.tuned.to_json()
    record["profile"] = tuner.resolve_profile(cache, mesh=mesh).to_json()
    if rank == 0:
        np.save(os.path.join(out_dir, "fwd_tuned.npy"), y.cpu().numpy())
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)


def _entry_operand(plan, seed: int, inverse: bool = False) -> torch.Tensor:
    """A seeded global operand of a plan's forward (or inverse) input."""
    struct = plan.inv_in_struct if inverse else plan.in_struct
    if struct.dtype.is_complex:
        return torch.from_numpy(cplx(struct.shape, seed))
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.standard_normal(struct.shape).astype(
        np.float32 if struct.dtype == torch.float32 else np.float64))


def segments_body(rank: int, out_dir: str, cases) -> None:
    """For each (name, plan_fft kwargs) case on a 2x2 mesh: the fused
    forward and inverse and the chained segments of each direction (with
    and without donating interior buffers); every rank records whether its
    blocks are bitwise equal, rank 0 saves the gathered fused results."""
    import warnings
    from repro_torch.compat import gather
    from repro_torch.core.api import plan_fft
    mesh = _cpu_mesh((2, 2))
    record = {}
    warnings.simplefilter("ignore", RuntimeWarning)  # inverse-slab bulk
    for i, (name, kw) in enumerate(cases):
        kw = dict(kw)
        grid = kw.pop("grid")
        plan = plan_fft(mesh, grid, **kw)
        x = _entry_operand(plan, 300 + i)
        y = plan.forward(x)
        z = plan.inverse(y, sharded_in=True)
        ok = {}
        for donate in (False, True):
            for inverse, fused, src in ((False, y, x), (True, z, y)):
                v = (plan.prepare_input(src, inverse=inverse) if not inverse
                     else src.clone())
                for seg in plan.segments(inverse=inverse,
                                         donate_intermediates=donate):
                    v = seg(v)
                key = f"{'inv' if inverse else 'fwd'}_donate{int(donate)}"
                ok[key] = bool(torch.equal(v, fused))
        record[name] = {"bitwise": ok, "local_out": list(y.shape),
                        "n_segments": len(plan.segments())}
        fwd = gather(y, plan.out_struct.spec, mesh)
        inv = gather(z, plan.inv_out_struct.spec, mesh)
        if rank == 0:
            np.save(os.path.join(out_dir, f"x_{name}.npy"), x.numpy())
            np.save(os.path.join(out_dir, f"fwd_{name}.npy"), fwd.numpy())
            np.save(os.path.join(out_dir, f"inv_{name}.npy"), inv.numpy())
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)


def executor_body(rank: int, out_dir: str, device=None, grid3=(8, 8, 16),
                  batch2=(4, 8, 8), n_chunks=(4, 2), repeats: int = 0
                  ) -> None:
    """On a 2x2 mesh: a mixed queue (two batched 2-D entries, a chunked
    3-D forward on the kernel backend and its inverse) run solo and through
    the executor in every dispatch mode; then donation across three
    entries of one plan.  Every rank records whether its blocks are
    bitwise equal to the solo runs, and with ``repeats`` the best-of ms of
    the solo sum and of the interleaved queue.  ``device=None`` runs on
    the ranks' cards (NCCL), ``"cpu"`` over gloo."""
    import torch.distributed as dist
    from repro_torch.compat import gather, make_mesh
    from repro_torch.core.api import plan_fft
    from repro_torch.core.executor import PlanStreamExecutor, execute_many
    from repro_torch.core.perfmodel import _time_best
    from repro_torch.distributed.fault import StepWatchdog
    mesh = make_mesh((2, 2), ("data", "model"), device=device)
    dev = mesh.device
    p2d = plan_fft(mesh, batch2[1:], batch_shape=batch2[:1])
    p3d = plan_fft(mesh, grid3, n_chunks=n_chunks, backend="kernel")
    xa = torch.from_numpy(cplx(batch2, 21)).to(dev)
    xb = torch.from_numpy(cplx(batch2, 22)).to(dev)
    y3 = torch.from_numpy(cplx(grid3, 23)).to(dev)
    yk = gather(p3d.forward(y3), p3d.out_struct.spec, mesh)
    entries = [(p2d, xa), (p2d, xb), (p3d, y3), (p3d, yk, {"inverse": True})]
    solo_calls = [lambda: p2d.forward(xa), lambda: p2d.forward(xb),
                  lambda: p3d.forward(y3), lambda: p3d.inverse(yk)]
    solo = [call() for call in solo_calls]
    record = {}
    for mode, kw in (("async", {}), ("pool", {}),
                     ("timed", {"watchdog": StepWatchdog()})):
        outs = execute_many(entries, mode=mode, **kw)
        record[mode] = [bool(torch.equal(g, w)) for g, w in zip(outs, solo)]
    if repeats:
        def barrier():
            dist.barrier()

        record["solo_ms"] = [1e3 * _time_best(call, repeats, dev,
                                              before=barrier)
                             for call in solo_calls]
        for mode in ("async", "pool"):
            record[f"interleaved_{mode}_ms"] = 1e3 * _time_best(
                lambda m=mode: execute_many(entries, mode=m), repeats, dev,
                before=barrier)
    p = plan_fft(mesh, grid3)
    xs = [p.prepare_input(torch.from_numpy(cplx(grid3, 30 + i)).to(dev))
          .contiguous() for i in range(3)]
    solo = [p.forward(x, sharded_in=True) for x in xs]
    snap = [x.clone() for x in xs]
    ex = PlanStreamExecutor()
    ex.submit(p, xs[0], sharded_in=True)
    ex.submit(p, xs[1], sharded_in=True, donate=True)
    ex.submit(p, xs[2], sharded_in=True)
    outs = ex.run()
    record["donation"] = {
        "donated_emptied": xs[1].numel() == 0
        and xs[1].untyped_storage().size() == 0,
        "neighbours_intact": bool(torch.equal(xs[0], snap[0])
                                  and torch.equal(xs[2], snap[2])),
        "outputs_bitwise": all(bool(torch.equal(g, w))
                               for g, w in zip(outs, solo))}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)


def serve_body(rank: int, out_dir: str, kwargs: dict) -> None:
    """``serve_fft(**kwargs)`` on this rank (its metrics JSON saved), then
    a service on a fresh 2x2 mesh that loses one rank: whether the lost
    rank's ``submit`` and ``drain`` raise."""
    from repro_torch.compat import make_mesh
    from repro_torch.launch.serve_fft import serve_fft
    from repro_torch.serving import FFTService
    snap = serve_fft(**kwargs)
    mesh = make_mesh((2, 2), ("data", "model"), device=kwargs.get("device"))
    svc = FFTService(mesh, bucket_edges=(8, 16))
    svc.submit(torch.from_numpy(cplx((8, 8), 40)).to(mesh.device))
    shape = svc.lose_devices(1)
    raised = {}
    if svc.lost:
        for name, call in (("submit",
                            lambda: svc.submit(torch.zeros(8, 8))),
                           ("drain", svc.drain)):
            try:
                call()
                raised[name] = False
            except RuntimeError:
                raised[name] = True
    done = {} if svc.lost else svc.drain()
    snap["lose_check"] = {"lost": svc.lost, "raised": raised,
                          "shape": list(shape), "completed": len(done)}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(snap, f)


def analysis_body(rank: int, out_dir: str, device=None, grid3=(8, 8, 16),
                  batch2=(4, 8, 8), n_chunks=(4, 2)) -> None:
    """On a 2x2 mesh: the executor's mixed queue (two batched 2-D
    entries, a chunked 3-D kernel forward and its inverse) plus a donated
    2-D entry, run with ``verify="strict", sanitize=True`` in every
    dispatch mode; then an executor whose rank 1 records its launches in
    another order (the ranks' order check must see it on every rank), and
    an unserialized pool queue (flagged SCHED001, refused before any
    launch).  Every rank records its findings, its launch order and
    whether its blocks are bitwise equal to the solo runs."""
    from repro_torch.analysis import PlanVerificationError
    from repro_torch.compat import gather, make_mesh
    from repro_torch.core.api import plan_fft
    from repro_torch.core.executor import PlanStreamExecutor
    from repro_torch.distributed.fault import StepWatchdog
    mesh = make_mesh((2, 2), ("data", "model"), device=device)
    dev = mesh.device
    p2d = plan_fft(mesh, batch2[1:], batch_shape=batch2[:1])
    p3d = plan_fft(mesh, grid3, n_chunks=n_chunks, backend="kernel")
    xa = torch.from_numpy(cplx(batch2, 21)).to(dev)
    xb = torch.from_numpy(cplx(batch2, 22)).to(dev)
    y3 = torch.from_numpy(cplx(grid3, 23)).to(dev)
    yk = gather(p3d.forward(y3), p3d.out_struct.spec, mesh)
    xd = torch.from_numpy(cplx(batch2, 24)).to(dev)
    solo = [p2d.forward(xa), p2d.forward(xb), p3d.forward(y3),
            p3d.inverse(yk), p2d.forward(xd)]

    def queue(ex):
        ex.submit(p2d, xa)
        ex.submit(p2d, xb)
        ex.submit(p3d, y3)
        ex.submit(p3d, yk, inverse=True)
        operand = xd.clone()
        ex.submit(p2d, operand, donate=True)
        return operand

    def where(report):
        return sorted([d.code, d.where()] for d in report)

    record = {}
    for mode, kw in (("async", {}), ("pool", {}),
                     ("timed", {"watchdog": StepWatchdog()})):
        sink = []
        ex = PlanStreamExecutor(mode=mode, verify="strict", sanitize=True,
                                verify_sink=sink.append, **kw)
        operand = queue(ex)
        outs = ex.run()
        trace = ex.last_trace()
        record[mode] = {
            "bitwise": [bool(torch.equal(g, w)) for g, w in zip(outs, solo)],
            "verify_errors": where(ex.last_verify_report().errors),
            "sanitize": where(ex.last_sanitize_report()),
            "san001": ex.sanitize_json()["diff"]["san001"],
            "order": trace.launch_order(),
            "turns": [e.turn for e in trace.events],
            "fates": [[b.tag, b.expect_deleted, b.deleted]
                      for b in trace.buffers],
            "donated_emptied": operand.numel() == 0}

    class SkewedRecorder(PlanStreamExecutor):
        """Rank 1 reports its launches in reverse order."""

        def _finish_sanitize(self, entries):
            if rank == 1:
                self._trace.events.reverse()
            super()._finish_sanitize(entries)

    sink = []
    ex = SkewedRecorder(sanitize=True, verify_sink=sink.append)
    queue(ex)
    ex.run()
    record["skewed"] = where(ex.last_sanitize_report())
    record["skewed_sink"] = [where(r) for r in sink]

    ex = PlanStreamExecutor(mode="pool", serialize_dispatch=False,
                            verify="strict")
    queue(ex)
    static = where(ex.verify_schedule())
    try:
        ex.run()
        refused = []
    except PlanVerificationError as err:
        refused = where(err.report.errors)
    record["unserialized"] = {
        "static": static, "refused": refused, "queued": len(ex),
        "outs": [e.out is None for e in ex._queue]}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)


def f32_smoke_config(name: str):
    """The port's smoke config with float32 activations (greedy tokens
    compare exactly there; bfloat16 logits tie)."""
    import dataclasses

    from repro_torch.configs import smoke_config
    return dataclasses.replace(smoke_config(name), dtype="float32")


def lm_mesh_body(rank: int, out_dir: str) -> None:
    """``launch.mesh.make_host_mesh`` under the process group, and the
    tokens ``launch.serve.serve`` gives on the multi-rank mesh (the
    float32 smoke config)."""
    import repro_torch.launch.serve as serve_mod
    from repro_torch.launch.mesh import make_host_mesh
    serve_mod.smoke_config = f32_smoke_config
    mesh = make_host_mesh(device="cpu")
    rec = {"shape": list(mesh.shape), "names": list(mesh.axis_names),
           "coords": list(mesh.coords), "device": str(mesh.device)}
    rec["tokens"] = serve_mod.serve("qwen3-8b", requests=1, mesh=mesh,
                                    device="cpu")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


# ---------------------------------------------------------------------------
# the LM sharded over a ("data", "model") mesh
# ---------------------------------------------------------------------------

def load_tree(path: str) -> dict:
    """A ``{"a/b": array}`` ``.npz`` as the nested tree it flattens."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return tree


def lm_config(arch: str, extra: dict):
    """The float32 smoke config of ``arch`` with ``extra`` fields."""
    import dataclasses
    return dataclasses.replace(f32_smoke_config(arch), **extra)


def patch_lm_drivers(tree: dict, extra: dict, set_attr=setattr) -> None:
    """``launch.serve``/``launch.train`` on the float32 config with the
    reference's parameters ``tree`` (each rank its blocks), and every
    ``fft_conv`` mixer on the kernel backend (the kernel's plain version
    on the CPU) unless its caller names one; ``set_attr`` sets each
    patched attribute."""
    import functools

    import repro_torch.launch.serve as serve_mod
    import repro_torch.launch.train as train_mod
    from repro_torch.models import ssm
    from repro_torch.models.convert import params_from_reference

    def build(cfg, *, seed=0, device=None, mesh=None):
        return params_from_reference(tree, cfg, device=device or "cpu",
                                     mesh=mesh)
    for mod in (serve_mod, train_mod):
        set_attr(mod, "smoke_config", lambda name: lm_config(name, extra))
        set_attr(mod, "build_params", build)
    forward = vars(ssm.FFTConv)["forward"]
    if isinstance(forward, functools.partialmethod):
        forward = forward.func
    set_attr(ssm.FFTConv, "forward",
             functools.partialmethod(forward, fft_backend="kernel"))


def lm_sharded_body(rank: int, out_dir: str, cases, meshes, serve_kw,
                    train_kw) -> None:
    """For each ``(name, arch, extra, what, tree .npz)`` of ``cases`` and
    each mesh shape, with the reference's parameters: ``serve`` (``"serve"
    in what``), ``train`` and one step's gradients gathered whole (rank 0
    saves them; ``"train" in what``)."""
    import repro_torch.launch.serve as serve_mod
    import repro_torch.launch.train as train_mod
    from repro_torch.compat import gather, make_mesh
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.sharding import MeshRules
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.convert import param_leaves
    rec = {}
    for name, arch, extra, what, tree_path in cases:
        tree = load_tree(tree_path)
        patch_lm_drivers(tree, extra)
        for shape in meshes:
            mesh = make_mesh(tuple(shape), ("data", "model"), device="cpu")
            tag = f"{name}-{shape[0]}x{shape[1]}"
            rec[tag] = {}
            if "serve" in what:
                rec[tag]["tokens"] = serve_mod.serve(
                    arch, mesh=mesh, device="cpu", **serve_kw)
            if "train" not in what:
                continue
            rec[tag]["losses"] = train_mod.train(
                arch, mesh=mesh, device="cpu", log_every=99,
                **train_kw)["losses"]
            cfg = lm_config(arch, extra)
            model = train_mod.build_params(cfg, mesh=mesh)
            rules = MeshRules.for_mesh(mesh)
            data = SyntheticLM(cfg, ShapeConfig(
                "t", "train", train_kw["seq_len"], train_kw["global_batch"]))
            _, _, grads = loss_and_grads(model, cfg, rules,
                                         data.sharded_batch(0, mesh, rules))
            leaves = param_leaves(model)
            whole = {f"{k[0]}|{k[1]}": gather(g, leaves[k].spec, mesh)
                     .numpy() for k, g in grads.items()}
            if rank == 0:
                np.savez(os.path.join(out_dir, f"grads-{tag}.npz"), **whole)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


# ---------------------------------------------------------------------------
# the LM on 4 cards over NCCL (tests/test_torch_cuda.py, ``four_cards``)
# ---------------------------------------------------------------------------

def lm_mesh_one_card_body(rank: int, out_dir: str) -> None:
    """On an NCCL group of one with an explicit (1, 1) mesh, ``serve`` and
    two ``train`` steps against the same runs with ``mesh=None``."""
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import train
    mesh = make_lm_mesh((1, 1))
    kw = dict(requests=2, batch=2, max_new=4)
    rec = {"serve": [serve("qwen3-8b", mesh=mesh, **kw),
                     serve("qwen3-8b", device=mesh.device, **kw)]}
    kw = dict(steps=2, seq_len=64, global_batch=2, log_every=9)
    rec["train"] = [train("qwen3-8b", mesh=mesh, **kw)["losses"],
                    train("qwen3-8b", device=mesh.device, **kw)["losses"]]
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def card_name() -> str:
    """The card's ``nvidia-smi`` name and power limit."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def greedy_trace(model, cfg, rules, prompts: torch.Tensor, max_new: int,
                 device) -> dict:
    """Serve's prefill + greedy decode loop (``launch/serve.py``) on one
    batch of ``prompts`` (this rank's rows): the tokens, each step's
    top-2 logit margin, the prefill's last logits (float32, on the CPU)
    and the decode steps' CUDA-event ms."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import pad_caches
    prefill = make_prefill_step(cfg, rules, device=device)
    decode = make_decode_step(cfg, rules, device=device)
    plen = prompts.shape[1]
    logits, caches = prefill(model, {"tokens": prompts.to(device)})
    caches = pad_caches(caches, cfg, max_seq=plen + max_new)
    first = logits.float().cpu()
    toks, margins, ms = [], [], []
    cur_logits = logits
    for i in range(max_new):
        top2 = torch.topk(cur_logits.float(), 2, dim=-1).values
        margins.append((top2[:, 0] - top2[:, 1]).cpu())
        cur = torch.argmax(cur_logits, dim=-1)[:, None]
        toks.append(cur.cpu())
        if i == max_new - 1:
            break
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        _, cur_logits, caches = decode(model, caches, cur, plen + i)
        ev[1].record()
        ms.append(ev)
    torch.cuda.synchronize(device)
    return {"tokens": torch.cat(toks, 1).tolist(),
            "margins": torch.stack(margins, 1).tolist(),
            "prefill_logits": first,
            "decode_ms": [a.elapsed_time(z) for a, z in ms]}


def lm_serve_cards_body(rank: int, out_dir: str, prompts_path: str,
                        max_new: int) -> None:
    """qwen3-8b at full width and depth served on ``make_host_mesh()``'s
    (1, 4): ``launch.serve.serve`` with the CLI's defaults, and the greedy
    trace of the first batch (rank 0 saves the prefill logits)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import MeshRules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import build_params
    mesh = make_host_mesh()
    cfg = get_config("qwen3-8b")
    rules = MeshRules.for_mesh(mesh)
    tokens = serve("qwen3-8b", smoke=False, mesh=mesh)
    torch.cuda.reset_peak_memory_stats(mesh.device)
    model = build_params(cfg, seed=0, mesh=mesh)
    trace = greedy_trace(model, cfg, rules,
                         torch.as_tensor(np.load(prompts_path)), max_new,
                         mesh.device)
    rec = {"shape": list(mesh.shape), "serve_tokens": tokens,
           "tokens": trace["tokens"], "margins": trace["margins"],
           "decode_ms": trace["decode_ms"],
           "peak_bytes": torch.cuda.max_memory_allocated(mesh.device),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in model.parameters()),
           "card": card_name()}
    if rank == 0:
        np.save(os.path.join(out_dir, "prefill_logits.npy"),
                trace["prefill_logits"].numpy())
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def _collective_share(fn, device) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the card's kernel time
    and the NCCL kernels' part of it (kernel events only)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    total = nccl = 0.0
    kernels = 0
    for a in prof.key_averages():
        us = getattr(a, "self_device_time_total",
                     getattr(a, "self_cuda_time_total", 0.0))
        if not str(a.device_type).endswith("CUDA") or us <= 0:
            continue
        total += us
        kernels += a.count
        if "nccl" in a.key.lower():
            nccl += us
    return {"kernel_ms": total / 1e3, "nccl_ms": nccl / 1e3,
            "kernels": kernels}


#: the leaves ``(path, super-block)`` the full-width gradient check
#: compares (a vocabulary block of the vocabulary-sized ones)
GRAD_LEAVES = (("decoder/layer0/attn/wq", 0), ("decoder/layer0/attn/wk", 0),
               ("decoder/layer0/attn/wo", 1),
               ("decoder/layer0/attn/q_norm/scale", 0),
               ("decoder/layer0/mlp/w_down", 1),
               ("decoder/layer0/norm2/scale", 1), ("final_norm/scale", None),
               ("embed", None), ("lm_head", None))


def full_width_grads(cfg, rules, batch, mesh=None, device=None) -> dict:
    """One float32 step's loss and the :data:`GRAD_LEAVES` gradients of
    ``cfg`` (qwen3-8b's widths), gathered whole on a mesh; the
    vocabulary-sized ones cut to their first 4096 vocabulary entries."""
    from repro_torch.compat import gather
    from repro_torch.launch.steps import build_params, loss_and_grads
    from repro_torch.models.convert import param_leaves
    model = build_params(cfg, seed=0, device=device, mesh=mesh)
    loss, _, grads = loss_and_grads(model, cfg, rules, batch)
    leaves = param_leaves(model)
    out = {"loss": float(loss)}
    for (path, r), g in grads.items():
        if (path, r) not in GRAD_LEAVES:
            continue
        if mesh is not None:
            g = gather(g.contiguous(), leaves[(path, r)].spec, mesh)
        if path == "embed":
            g = g[:4096]
        elif path == "lm_head":
            g = g[:, :4096]
        out[f"{path}|{r}"] = g.float().cpu().numpy()
    return out


def lm_check_cards_body(rank: int, out_dir: str, steps: int,
                        seq: int = 4096) -> None:
    """qwen3-8b's widths on ``make_host_mesh()``'s (1, 4): one float32
    step's loss and gradients at 2 layers (rank 0 saves them), and
    ``steps`` bf16 training steps at 8 layers, B=1, S=4096 (``[train]``'s
    setup)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed.sharding import MeshRules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.config import SHAPES
    mesh = make_host_mesh()
    rules = MeshRules.for_mesh(mesh)
    full = get_config("qwen3-8b")
    cut = dataclasses.replace(full, n_layers=2, dtype="float32")
    host = SyntheticLM(cut, SHAPES["train_4k"], seed=0, batch_override=1,
                       seq_override=256).batch_for_step(0)
    batch = {k: v.to(mesh.device)
             for k, v in SyntheticLM.to_device(host, "cpu").items()}
    got = full_width_grads(cut, rules, batch, mesh=mesh)
    if rank == 0:
        np.savez(os.path.join(out_dir, "grads.npz"), **got)
    torch.cuda.empty_cache()
    rec = train_losses(dataclasses.replace(full, n_layers=8), steps,
                       mesh=mesh, seq=seq)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def train_losses(cfg, steps: int, mesh=None, device=None,
                 seq: int = 4096) -> dict:
    """``steps`` train steps (``[train]``'s: B=1, S=4096, remat, bf16
    gradients, ``AdamWConfig()``, ``SyntheticLM`` from seed 0): their
    ``losses``, and each training batch's loss before the first update
    and after the last (``held_before``, ``held_after``:
    :func:`held_losses`)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed.sharding import MeshRules
    from repro_torch.launch.steps import build_params, make_train_step
    from repro_torch.models.config import SHAPES
    from repro_torch.models.convert import param_leaves
    from repro_torch.optim import AdamWConfig, adamw_init
    rules = MeshRules.for_mesh(mesh)
    opt = AdamWConfig()
    data = SyntheticLM(cfg, SHAPES["train_4k"], seed=0, batch_override=1,
                       seq_override=seq)
    step_fn = make_train_step(cfg, rules, opt, remat=True,
                              grad_compress=True, device=device)
    model = build_params(cfg, seed=0, device=device, mesh=mesh)
    state = adamw_init(param_leaves(model), opt)
    held = [data.sharded_batch(i, mesh, rules) if mesh is not None
            else data.device_batch(i, device) for i in range(steps)]
    before = held_losses(model, cfg, rules, held)
    losses = []
    for b in held:
        _, _, metrics = step_fn(model, state, b)
        losses.append(float(metrics["loss"]))
    return {"losses": losses, "held_before": before,
            "held_after": held_losses(model, cfg, rules, held)}


def held_losses(model, cfg, rules, batches) -> list:
    """The whole batch's loss (the reference's ``loss_fn``, no router aux)
    on each of ``batches`` (this rank's rows), forward only: the model
    is not updated."""
    from repro_torch.distributed.sharding import batch_mean
    from repro_torch.launch.steps import loss_fn
    out = []
    with torch.no_grad():
        for b in batches:
            _, (loss, _) = loss_fn(model, cfg, rules, b, remat=False)
            out.append(float(batch_mean(loss, rules)))
    return out


def lm_train_cards_body(rank: int, out_dir: str, shape, batch: int,
                        seq: int, steps: int) -> None:
    """qwen3-8b at full width and all 36 layers trained ``steps`` steps on a
    ``shape`` mesh over NCCL (``(1, 4)`` is ``make_host_mesh()``'s): remat,
    bf16 gradients, ``AdamWConfig()``, ``SyntheticLM`` from seed 0, twice
    from one seed; per step CUDA-event ms, peak memory, one more step
    under the profiler (the NCCL kernels' share); in the first run the
    loss of each of the ``steps`` training batches before the first update
    and after the last (:func:`held_losses`) and each step's learning
    rate."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed.sharding import MeshRules
    from repro_torch.launch.mesh import make_host_mesh, make_lm_mesh
    from repro_torch.launch.steps import build_params, make_train_step
    from repro_torch.models.config import SHAPES
    from repro_torch.models.convert import param_leaves
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import cosine_schedule
    shape = tuple(shape)
    mesh = make_host_mesh() if shape == (1, 4) else make_lm_mesh(shape)
    assert tuple(mesh.shape) == shape
    cfg = get_config("qwen3-8b")
    rules = MeshRules.for_mesh(mesh)
    opt = AdamWConfig()
    data = SyntheticLM(cfg, SHAPES["train_4k"], seed=0,
                       batch_override=batch, seq_override=seq)
    step_fn = make_train_step(cfg, rules, opt, remat=True,
                              grad_compress=True)
    dev = mesh.device
    runs = []
    for again in range(2):
        torch.cuda.reset_peak_memory_stats(dev)
        model = build_params(cfg, seed=0, mesh=mesh)
        state = adamw_init(param_leaves(model), opt)
        held = [data.sharded_batch(i, mesh, rules) for i in range(steps)]
        if again == 0:
            before = held_losses(model, cfg, rules, held)
        losses, events = [], []
        for i in range(steps):
            b = data.sharded_batch(i, mesh, rules)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            _, _, metrics = step_fn(model, state, b)
            ev[1].record()
            events.append(ev)
            losses.append(metrics["loss"])
        torch.cuda.synchronize(dev)
        rec = {"losses": [float(v) for v in losses],
               "step_ms": [a.elapsed_time(z) for a, z in events],
               "peak_bytes": torch.cuda.max_memory_allocated(dev),
               "param_bytes": sum(p.numel() * p.element_size()
                                  for p in model.parameters())}
        if again == 0:
            rec["held"] = {"before": before,
                           "after": held_losses(model, cfg, rules, held),
                           "lr": [float(cosine_schedule(opt, i))
                                  for i in range(steps)]}
            b = data.sharded_batch(steps, mesh, rules)
            rec["profile"] = _collective_share(
                lambda: step_fn(model, state, b), dev)
        del held
        runs.append(rec)
        del model, state
        torch.cuda.empty_cache()
    out = {"shape": list(shape), "batch": batch, "seq": seq,
           "layers": cfg.n_layers, "runs": runs, "card": card_name()}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def fft_conv_cards_body(rank: int, out_dir: str, b: int, s: int) -> None:
    """``ssm.fft_conv`` at jamba-v0.1-52b's mixer width (8192 channels),
    float32, forward and backward through the mesh path on
    ``make_host_mesh()``'s (1, 4) (2048 channels per card) on the kernel
    backend, against the same mixer whole on this card: B1's launches per
    rank, the gathered gradients' max-scaled errors, CUDA-event ms."""
    import dataclasses

    from repro_torch.compat import gather
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import MeshRules, ParamBuilder
    from repro_torch.kernels import ops
    from repro_torch.kernels.fft_matmul import (fft_fourstep,
                                                reset_launch_counts)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import ssm
    mesh = make_host_mesh()
    dev = mesh.device
    rules = MeshRules.for_mesh(mesh)
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"),
                              ssm_impl="fft_conv", dtype="float32")
    whole = ssm.init_fft_conv(ParamBuilder(0, device=dev), "ssm", cfg)
    local = ssm.init_fft_conv(ParamBuilder(0, device=dev, rules=rules),
                              "ssm", cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
    r = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)

    def fwd_bwd(params, rules_, backend):
        params.requires_grad_(True)
        for p in params.parameters():
            p.grad = None
        xx = x.detach().requires_grad_(True)
        y, _ = params(xx, rules=rules_, fft_backend=backend)
        (y * r).sum().backward()
        return y, {**{k: p.grad for k, p in params.named_parameters()},
                   "x": xx.grad}

    _, ref = fwd_bwd(whole, None, "kernel")
    torch.cuda.synchronize(dev)
    reset_launch_counts()
    ops.copies["lines"] = 0
    y, got = fwd_bwd(local, rules, "kernel")
    torch.cuda.synchronize(dev)
    from repro_torch.kernels.radix import kernel_path
    path = kernel_path(2 * s, torch.complex64)   # lines of 2S
    counts = {"launches": fft_fourstep.launches,
              path: fft_fourstep.path_launches[path],
              "lines": fft_fourstep.layout_launches["lines"],
              "copies": ops.copies["lines"]}
    specs = dict(local.named_parameters())
    errs = {}
    for k, g in got.items():
        g = g if k == "x" else gather(g.contiguous(), specs[k].spec, mesh)
        errs[k] = float((g - ref[k]).abs().max()
                        / ref[k].abs().max().clamp_min(1e-30))

    def timed(fn, iters=5):
        fn()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(iters):
            fn()
        ev[1].record()
        torch.cuda.synchronize(dev)
        return ev[0].elapsed_time(ev[1]) / iters
    rec = {"counts": counts, "grad_errs": errs,
           "channels_per_card": local.basis_w.shape[0],
           "sharded_ms": timed(lambda: fwd_bwd(local, rules, "kernel")),
           "one_card_ms": timed(lambda: fwd_bwd(whole, None, "kernel")),
           "card": card_name()}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def _whole_state(model, opt_state, mesh) -> dict:
    """The model's and AdamW's state gathered whole, ``{"params/..",
    "opt/m/..", ...}`` as numpy, from this rank's blocks."""
    from repro_torch.compat import gather
    from repro_torch.launch.train import state_pspecs, train_state
    state, specs = train_state(model, opt_state), state_pspecs(model)

    def walk(node, spec, pre, out):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, spec[k], f"{pre}{k}/", out)
            else:
                t = v if mesh is None else gather(v.contiguous(), spec[k],
                                                  mesh)
                out[pre + k] = t.detach().cpu().numpy()
        return out
    return walk(state, specs, "", {})


def _restored(ckpt_dir: str, cfg, mesh) -> dict:
    """A checkpoint restored onto ``mesh`` (None: one process) into a
    fresh model and AdamW state, gathered whole."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.steps import build_params
    from repro_torch.launch.train import state_pspecs
    from repro_torch.models.convert import load_params, \
        opt_state_from_reference
    model = build_params(cfg, seed=1, device="cpu", mesh=mesh)
    _, state = CheckpointManager(ckpt_dir).restore(
        device="cpu", mesh=mesh, pspecs=state_pspecs(model))
    load_params(model, state["params"])
    opt = opt_state_from_reference(state["opt"], model)
    return _whole_state(model, opt, mesh)


def lm_ckpt_body(rank: int, out_dir: str, arch: str, ref_ckpt: str) -> None:
    """Elastic checkpoints of ``train`` (float32 smoke ``arch``): saved on
    (2, 2), restored on (1, 4) and on one process, resumed on (2, 2) and
    (1, 4) beside an uninterrupted (2, 2) run; and the reference's
    checkpoint ``ref_ckpt`` restored onto (1, 4)."""
    import shutil

    import torch.distributed as dist
    import repro_torch.launch.train as train_mod
    from repro_torch.compat import make_mesh
    train_mod.smoke_config = f32_smoke_config
    cfg = f32_smoke_config(arch)
    m22 = make_mesh((2, 2), ("data", "model"), device="cpu")
    m14 = make_mesh((1, 4), ("data", "model"), device="cpu")
    kw = dict(steps=4, seq_len=16, global_batch=2, ckpt_every=2,
              log_every=99)
    d = {k: os.path.join(out_dir, k) for k in ("whole", "part", "copy")}
    rec = {"whole": train_mod.train(arch, mesh=m22, ckpt_dir=d["whole"],
                                    **kw)["losses"],
           "part": train_mod.train(arch, mesh=m22, ckpt_dir=d["part"],
                                   stop_after=2, **kw)["losses"]}
    if rank == 0:   # the step-2 checkpoint, before the resume adds more
        shutil.copytree(d["part"], d["copy"])
    dist.barrier()
    rec["resumed22"] = train_mod.train(arch, mesh=m22, ckpt_dir=d["part"],
                                       **kw)["losses"]
    saved = _restored(d["copy"], cfg, m22)
    on14 = _restored(d["copy"], cfg, m14)
    one = _restored(d["copy"], cfg, None)
    rec["restore_bitwise"] = {
        "1x4": sorted(saved) == sorted(on14) and all(
            np.array_equal(saved[k], on14[k]) for k in saved),
        "one": sorted(saved) == sorted(one) and all(
            np.array_equal(saved[k], one[k]) for k in saved)}
    copy14 = os.path.join(out_dir, "copy14")
    if rank == 0:
        shutil.copytree(d["copy"], copy14)
    dist.barrier()
    rec["resumed14"] = train_mod.train(arch, mesh=m14, ckpt_dir=copy14,
                                       **kw)["losses"]
    ref = _restored(ref_ckpt, cfg, m14)
    if rank == 0:
        np.savez(os.path.join(out_dir, "from_reference.npz"), **ref)
        with open(os.path.join(d["copy"], "step_0000000002",
                               "manifest.json")) as f:
            rec["manifest_pspecs"] = json.load(f)["pspecs"]
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
