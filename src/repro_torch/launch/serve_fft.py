"""Spectral serving driver: a warmed, bucketed, loss-tolerant FFT service.

The port's counterpart of the JAX package's ``launch/serve_fft.py``.
From the root of a checkout, with ``PYTHONPATH=src``:

    python -m repro_torch.launch.serve_fft --smoke --check       # one GPU
    python -m repro_torch.launch.serve_fft --smoke --check --device cpu \\
        --ranks 4                            # 4 gloo ranks, one of them lost
    python -m repro_torch.launch.serve_fft --check --primary 1024,1024 \\
        --secondary 1024,2048 --odd 1000,1000 960,1024 1024,1000 \\
        --edges 256,512,1024,2048 --max-batch 8 --requests 48 \\
        --round-size 16 --json metrics.json                    # card size
    python -m repro_torch.launch.serve_fft --smoke --check --verify strict

It runs on CUDA unless ``--device cpu`` is given, and raises without a
GPU.  ``--ranks N`` spawns N processes (NCCL, one card each, or gloo on
the CPU) that play one service in SPMD (``serving/service.py``).  One
service lifetime:

1. seed a wisdom file (a measured tune of the primary grid over
   ``--backends``, by default the hand-written kernel: it stands in for
   yesterday's serving day) and **warm-start** the
   :class:`~repro_torch.serving.FFTService` from it (``ensure=`` covers
   the secondary grid, known but untuned);
2. rounds of seeded mixed-shape traffic (bucket-exact, odd shapes that
   pad, a second family) through submit/drain; the first drain's plan
   builds (``GLOBAL_PLAN_CACHE`` misses) and kernel library loads
   (``kernels.build.counts``) are counted: a warmed service has none;
3. with more than one rank, mid-stream, with a round already queued,
   **lose ``--lose`` ranks**: the survivors re-shape through
   ``choose_fft_mesh_shape``, re-plan every family, and the pending round
   completes degraded;
4. check every result against ``torch.fft.fftn`` at 1e-4 relative (a
   padded request against the padded transform, cropped), and the
   post-loss stream **bitwise** against a fresh service on an identical
   survivors-only mesh;
5. write the metrics JSON; ``--check`` exits non-zero unless the hit rate
   reaches ``--hit-rate-min``, the warmed first drain built nothing and
   the parity holds.

``--verify warn|strict`` runs the services with the executor's static
verifier on every drain (``FFTService(verify=)``); its findings are the
JSON's ``verify_warnings`` counters, and strict refuses a drain whose
planned order has errors.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..compat import make_mesh, resolve_device
from ..core.plan import GLOBAL_PLAN_CACHE, TuningCache
from ..core.tuner import tune
from ..distributed.fault import choose_fft_mesh_shape
from ..kernels import build, ops
from ..kernels.fft_matmul import launch_counts
from ..serving import FFTService

NAMES = ("data", "model")
# Smoke traffic: two C2C families and odd shapes that pad into the first.
PRIMARY_GRID = (16, 16)
SECONDARY_GRID = (16, 32)
ODD_GRIDS = ((14, 15), (13, 16), (15, 10))
SMOKE_EDGES = (8, 16, 32, 64)
REL_TOL = 1e-4


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def serving_mesh(device, dims: Sequence[int]):
    """The (data, model) mesh of all the world's ranks, shaped so that
    both axis sizes divide every served dim."""
    _, world = _world()
    shape = choose_fft_mesh_shape(world, grid=dims)
    if shape[0] * shape[1] != world:
        raise ValueError(f"{world} ranks form no mesh whose axis sizes "
                         f"divide every served dim {tuple(dims)}")
    return make_mesh(shape, NAMES, device=device)


def gen_traffic(rng, n: int, primary, secondary, odd):
    """Deterministic mixed-shape request stream (grid tuples)."""
    pool = [primary] * 5 + [secondary] * 2 + list(odd)
    return [tuple(pool[int(rng.integers(0, len(pool)))]) for _ in range(n)]


def operand(seed: int, k: int, grid, device) -> torch.Tensor:
    """Request ``k``'s operand, drawn on ``device`` (the same on every
    rank of one device type)."""
    gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + k)
    return torch.randn(tuple(grid), dtype=torch.complex64, device=device,
                       generator=gen)


def rel_error(x: torch.Tensor, res) -> float:
    """Max error over max |reference| for this request's semantic."""
    if res.padded:
        xp = torch.zeros(res.bucket_grid, dtype=x.dtype, device=x.device)
        crop = tuple(slice(0, n) for n in x.shape)
        xp[crop] = x
        ref = torch.fft.fftn(xp)[crop]
    else:
        ref = torch.fft.fftn(x)
    scale = max(float(ref.abs().max()), 1e-30)
    return float((res.y - ref).abs().max()) / scale


def kernel_counts() -> dict:
    """The kernel's launch counters and the line copies, flat."""
    counts = launch_counts()
    counts["copies"] = ops.copies["lines"]
    return counts


def serve_fft(*, requests: int = 24, round_size: int = 8, lose: int = 1,
              seed: int = 0, device=None, wisdom: Optional[str] = None,
              json_path: Optional[str] = None, check: bool = False,
              hit_rate_min: float = 0.8, primary=PRIMARY_GRID,
              secondary=SECONDARY_GRID, odd=ODD_GRIDS,
              bucket_edges=SMOKE_EDGES, max_batch: int = 4,
              backends: Sequence[str] = ("kernel",),
              verify: str = "off", verbose: bool = True,
              timer: Callable[[], float] = time.perf_counter) -> dict:
    """One service lifetime (module docstring); returns the metrics JSON
    with a ``"driver"`` section.  Every rank of the world calls it.
    ``timer`` is the clock of the driver's wall times."""
    rank, world = _world()
    say = verbose and rank == 0
    primary, secondary = tuple(primary), tuple(secondary)
    odd = tuple(tuple(g) for g in odd)
    rng = np.random.default_rng(seed)
    mesh = serving_mesh(device, primary + secondary)
    dev = mesh.device
    lose = min(int(lose), mesh.size - 1)
    # In memory unless a path is given; on several ranks the file must be
    # one all of them read (rank 0 writes it).
    cache = TuningCache(wisdom)
    # Yesterday's serving day: the dominant grid, tuned and persisted
    # (a search over some backends under a wisdom key of its own).
    tune(primary, mesh, mode="auto", cache=cache, backends=backends)
    svc = FFTService(mesh, tune_cache=cache, bucket_edges=bucket_edges,
                     max_batch=max_batch, backends=backends, verify=verify)
    rep = svc.warm(ensure=[(secondary, ("fft",) * len(secondary))])
    if say:
        print(f"[serve_fft] mesh={mesh.shape} on {mesh.device} "
              f"warm: {rep.describe()}", flush=True)

    grids = gen_traffic(rng, requests, primary, secondary, odd)
    inputs = {}                    # id -> operand
    post_loss = []                 # (id, operand) drained after the loss
    lose_at = max(1, (requests // round_size) // 2) if lose else -1
    errors, first_drain, shape = [], None, tuple(mesh.shape)
    # Kernel launches and routed batches of the traffic drains alone (the
    # tune and warm-up above launch too).
    traffic = dict.fromkeys(kernel_counts(), 0)
    batches, by_grid = 0, {}
    # Where the traffic loop's wall time goes (host clock; drain() and the
    # checks end in a synchronization).
    seconds = {"submit": 0.0, "drain": 0.0, "check": 0.0}
    t0 = timer()
    for r, lo in enumerate(range(0, len(grids), round_size)):
        if svc.lost:
            break
        tic = timer()
        for k, g in enumerate(grids[lo:lo + round_size], start=lo):
            x = operand(seed, k, g, dev)
            rid = svc.submit(x)
            inputs[rid] = x
            if r >= lose_at >= 0:
                post_loss.append((rid, x))
        if r == lose_at:
            # Mid-stream loss: this round's requests are queued.
            depth = svc.queue_depth
            shape = svc.lose_devices(lose)
            if say:
                print(f"[serve_fft] lost {lose} of {world} ranks with "
                      f"{depth} requests in flight -> degraded mesh "
                      f"{shape}", flush=True)
            if svc.lost:
                break
        before = (GLOBAL_PLAN_CACHE.stats()["misses"],
                  build.counts["loads"])
        counts, dispatched = kernel_counts(), svc.metrics.batches_dispatched
        grids_before = dict(svc.metrics.batches_by_grid)
        seconds["submit"] += timer() - tic
        tic = timer()
        results = svc.drain()
        seconds["drain"] += timer() - tic
        tic = timer()
        for k, n in kernel_counts().items():
            traffic[k] += n - counts[k]
        batches += svc.metrics.batches_dispatched - dispatched
        for g, n in svc.metrics.batches_by_grid.items():
            if n > grids_before.get(g, 0):
                by_grid[g] = by_grid.get(g, 0) + n - grids_before.get(g, 0)
        if first_drain is None:
            first_drain = {
                "plan_builds": GLOBAL_PLAN_CACHE.stats()["misses"]
                - before[0],
                "kernel_loads": build.counts["loads"] - before[1]}
        for rid, res in results.items():
            err = rel_error(inputs[rid], res)
            errors.append(err)
            if err > REL_TOL:
                raise SystemExit(f"[serve_fft] FAIL req {rid}: "
                                 f"rel_err={err:.3e}")
        seconds["check"] += timer() - tic
        if say:
            lat = svc.metrics.latency_percentiles()
            print(f"[serve_fft] round {r}: {len(results)} done "
                  f"(hit_rate={svc.metrics.plan_hit_rate:.2f}, "
                  f"p50={lat['p50_s'] * 1e3:.3f}ms, "
                  f"degraded={svc.degraded})", flush=True)
    wall = timer() - t0
    served = svc.metrics.requests_completed

    # Fresh-mesh reference: a service booted on an identical
    # survivors-only mesh reproduces the recovered service's post-loss
    # outputs bit for bit (same knobs, same ranks, same batching).
    # Building its mesh is collective, so every rank takes part.
    bitwise_ok = True
    if svc.degraded:
        ref_mesh = make_mesh(shape, NAMES,
                             ranks=range(shape[0] * shape[1]),
                             device="cpu" if dev.type == "cpu" else None)
        if ref_mesh is not None and post_loss:
            ref = FFTService(ref_mesh, tune_cache=cache,
                             bucket_edges=bucket_edges,
                             max_batch=max_batch, backends=backends,
                             verify=verify)
            for fam in svc.router.families.values():
                ref.router.resolve_family(fam.grid, fam.kinds, fam.dtype)
            id_map = {ref.submit(x): rid for rid, x in post_loss}
            ref_by_orig = {id_map[k]: v for k, v in ref.drain().items()}
            # The same stream through the recovered service once more,
            # so both sides compare the same batched executions.
            again_ids = {svc.submit(x): rid for rid, x in post_loss}
            again = svc.drain()
            for new_id, orig in again_ids.items():
                a, b = again[new_id].y, ref_by_orig[orig].y
                if not torch.equal(a, b):
                    bitwise_ok = False
                    print(f"[serve_fft] BITWISE MISMATCH req {orig}: "
                          f"max|d|={float((a - b).abs().max()):.3e}",
                          flush=True)
            if say:
                print(f"[serve_fft] fresh-mesh bitwise parity over "
                      f"{len(post_loss)} post-loss requests: "
                      f"{'OK' if bitwise_ok else 'FAIL'}", flush=True)

    snap = svc.metrics.to_json()
    snap["driver"] = {
        "wall_s": wall, "requests": requests, "lost_devices": lose,
        "world": world, "rank": rank, "lost": svc.lost,
        "device": str(dev), "backends": list(backends), "verify": verify,
        "max_rel_err": max(errors) if errors else 0.0,
        "fresh_mesh_bitwise_ok": bitwise_ok,
        "mesh": list(mesh.shape), "degraded_mesh": list(shape),
        "first_drain": first_drain,
        "families": {"x".join(map(str, f.grid)): {
            "source": f.source, "backend": f.tuned.backend,
            "decomp": f.tuned.decomp}
            for f in svc.router.families.values()},
        "rps": served / wall if wall > 0 else 0.0,
        "seconds": seconds,
        # the service's own rate: requests per second spent in drain()
        "drain_rps": (served / seconds["drain"] if seconds["drain"] > 0
                      else 0.0),
        # the traffic's rate: submits (operands drawn) and drains, without
        # the result checks
        "loop_rps": (served / (seconds["submit"] + seconds["drain"])
                     if seconds["submit"] + seconds["drain"] > 0 else 0.0),
        "traffic_launches": traffic, "traffic_batches": batches,
        "traffic_batches_by_grid": by_grid,
    }
    if json_path and rank == 0:
        os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
            f.write("\n")
    hr = svc.metrics.plan_hit_rate
    if say:
        lat = svc.metrics.latency_percentiles()
        print(f"[serve_fft] done: {served} requests in {wall:.3f}s "
              f"({snap['driver']['rps']:.1f}/s), hit_rate={hr:.2f}, "
              f"p50={lat['p50_s'] * 1e3:.3f}ms "
              f"p99={lat['p99_s'] * 1e3:.3f}ms, first drain {first_drain}, "
              f"degraded_rps={svc.metrics.degraded_throughput_rps():.1f}",
              flush=True)
    if check and not svc.lost:
        if hr < hit_rate_min:
            raise SystemExit(f"[serve_fft] CHECK FAIL: hit_rate {hr:.2f} "
                             f"< {hit_rate_min}")
        if first_drain != {"plan_builds": 0, "kernel_loads": 0}:
            raise SystemExit(f"[serve_fft] CHECK FAIL: the warmed first "
                             f"drain built {first_drain}")
        if not bitwise_ok:
            raise SystemExit("[serve_fft] CHECK FAIL: fresh-mesh parity")
        if say:
            print(f"[serve_fft] CHECK OK (hit_rate={hr:.2f} >= "
                  f"{hit_rate_min}, warmed first drain built nothing, "
                  f"bitwise parity holds)", flush=True)
    return snap


def _rank_main(rank: int, world: int, init_file: str, backend: str,
               kwargs: dict) -> None:
    if backend == "nccl":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        serve_fft(**kwargs)
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, **kwargs) -> None:
    """``serve_fft(**kwargs)`` on ``world`` spawned ranks: NCCL on one card
    each, or gloo with ``device="cpu"``."""
    import torch.multiprocessing as mp
    backend = "gloo" if str(kwargs.get("device")) == "cpu" else "nccl"
    if backend == "nccl":
        resolve_device(None)     # raises without a GPU
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main,
                           args=(world, os.path.join(tmp, "rendezvous"),
                                 backend, kwargs),
                           nprocs=world, join=True, start_method="spawn")


def _grid(text: str) -> Tuple[int, ...]:
    return tuple(int(v) for v in text.split(","))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="the small default traffic (the default)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: CUDA)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="processes to spawn (NCCL, or gloo with --device "
                         "cpu)")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--round-size", type=int, default=8)
    ap.add_argument("--lose", type=int, default=1,
                    help="ranks to drop mid-stream (0 disables; needs "
                         "more than one rank)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--primary", type=_grid, default=PRIMARY_GRID)
    ap.add_argument("--secondary", type=_grid, default=SECONDARY_GRID)
    ap.add_argument("--odd", type=_grid, nargs="*", default=ODD_GRIDS)
    ap.add_argument("--edges", type=_grid, default=SMOKE_EDGES,
                    help="bucket edges, comma-separated")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--backends", type=lambda s: tuple(s.split(",")),
                    default=("kernel",),
                    help="local backends the tuner may choose from")
    ap.add_argument("--wisdom", default=None,
                    help="wisdom-file path (default: in memory)")
    ap.add_argument("--json", default=None,
                    help="write the metrics snapshot here")
    ap.add_argument("--check", action="store_true",
                    help="gate on hit rate, zero builds in the warmed first "
                         "drain and bitwise parity; exit non-zero")
    ap.add_argument("--hit-rate-min", type=float, default=0.8)
    ap.add_argument("--verify", choices=("off", "warn", "strict"),
                    default="off",
                    help="run the executor's static verifier on every "
                         "drain (findings: the JSON's verify_warnings)")
    args = ap.parse_args(argv)
    kwargs = dict(requests=args.requests, round_size=args.round_size,
                  lose=args.lose, seed=args.seed, device=args.device,
                  wisdom=args.wisdom, json_path=args.json, check=args.check,
                  hit_rate_min=args.hit_rate_min, primary=args.primary,
                  secondary=args.secondary, odd=args.odd,
                  bucket_edges=args.edges, max_batch=args.max_batch,
                  backends=args.backends, verify=args.verify)
    if args.ranks > 1:
        run_ranks(args.ranks, **kwargs)
    else:
        serve_fft(**kwargs)


if __name__ == "__main__":
    main()
