"""Helpers for the tests of the PyTorch port (``tests/test_torch_*.py``).

* seeded numpy inputs and a max-scaled closeness assertion;
* :func:`run_ranks` — spawn ``world`` gloo ranks (file rendezvous in a
  temporary directory, never a fixed port, so parallel test workers do not
  collide), each running one of the rank bodies below; bodies save their
  results as ``.npy`` files for the test to read;
* :func:`run_reference` — run a JAX snippet with N fake XLA devices in a
  fresh process (``conftest.run_subprocess``).

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


# ---------------------------------------------------------------------------
# Multi-rank runs over gloo
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, init_file: str, body: str,
               out_dir: str, args: tuple) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        globals()[body](rank, out_dir, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(body: str, world: int, tmp_path, *args,
              timer=time.monotonic) -> str:
    """Run ``body(rank, out_dir, *args)`` on ``world`` spawned gloo ranks.

    Returns the output directory.  Raises if any rank fails or the run
    outlives ``RANK_TIMEOUT_S``.
    """
    import torch.multiprocessing as mp
    out_dir = os.path.join(str(tmp_path), f"ranks_{body}")
    os.makedirs(out_dir, exist_ok=True)
    init_file = os.path.join(str(tmp_path), f"rendezvous_{body}")
    ctx = mp.start_processes(_rank_main,
                             args=(world, init_file, body, out_dir, args),
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
