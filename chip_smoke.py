#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero without printing
its result line):

1. build the CUDA kernel from ``src/repro_torch/csrc`` and print the build
   time, ``ptxas``'s registers, spills and stack frame per kernel
   instantiation (a radix instantiation that spills or keeps a stack frame
   fails the run) and the card's ``nvidia-smi`` name and power limit;
2. hold the four-step kernel against its plain PyTorch version on the card
   over the shapes of ``tests/test_kernels.py`` (both directions, prime N,
   empty batch, ragged tiles, ``pack_parts``, the twiddle, complex128,
   lazily conjugated operands and twiddles), every radix-path length of
   both dtypes, and strided ``(outer, N, inner)`` blocks through
   ``fft_fourstep_strided`` (inner of one tile, 512, ragged 1000, 262144);
3. the main path: ``plan_fft`` of a 512^3 complex64 grid on a (1, 1)
   ``("data", "model")`` mesh with ``backend="kernel"``, forward and
   inverse for 3 rounds, checked against ``torch.fft.fftn`` and the round
   trip, with exactly 3 kernel launches per direction, all on the radix
   path and 2 of them strided, no line copy (``ops.copies``) and a
   contiguous result; then CUDA-event times of the plan, of a
   ``cufft``-backend plan, of ``torch.fft``, of one stage's kernel on
   contiguous lines and of the strided stages in place, and of the
   movedim+contiguous copy the strided stages no longer pay;
4. the ``pack_parts`` epilogue at the local shapes of a 2x2 mesh: stage 0
   of the 512^3 pencil packs for the first hop, matches the plain version,
   and the hop's send buffer is the kernel's output (same ``data_ptr``);
5. the Poisson path: a ``PoissonSolver`` of the (periodic, periodic,
   bounded) topology at 512^3 float32 on ``backend="kernel"``, 3 solves
   with exactly 2 ``twiddle`` + 2 ``fourstep`` launches per forward and 4
   ``fourstep`` per inverse, all on the radix path; its forward against
   ``torch.fft`` on dims 0 and 1 and a mirrored length-2N DCT-II along
   dim 2, its solve against a float64 ``cufft``-backend solve (whose
   Neumann residual is checked); CUDA-event times of both backends' solves
   and of the DCT stages;
6. the twiddle epilogue at the DCT-II stage's shape, timed;
7. an R2C plan, ``kinds=("rfft", "fft", "fft")`` at 512^3 on the kernel
   backend: 3 launches per direction, forward against
   ``torch.fft.fftn(x)[:257]``, and the round trip;
8. a ``kernels`` JSON line (one entry per kernel variant, with the path
   it ran), then the result line.

Measurements also go to ``chiprun_out/chip_smoke.json``.  Exits non-zero
when CUDA is not available.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

GRID = (512, 512, 512)
SEED = 0
# Max-scaled error of the kernel against its plain version: the f32 bound
# is tests/test_kernels.py's 5e-6; f64 keeps 1e-12.
TOL = {"complex64": 5e-6, "complex128": 1e-12}
# The 3-D plan against torch.fft.fftn, as tests/test_pallas_backend.py.
PATH_TOL = 2e-4
ROUNDTRIP_TOL = 1e-4
# Published peaks of one H100 SXM: float32 on the CUDA cores, and HBM
# bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
KERNEL_SOURCE = "src/repro_torch/csrc/fft_fourstep.cu"
RADIX_SOURCE = "src/repro_torch/csrc/fft_radix.cuh"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def scaled_err(got, ref) -> float:
    scale = max(float(ref.abs().max()), 1e-30) if ref.numel() else 1.0
    if got.numel() == 0:
        return 0.0
    return float((got - ref).abs().max()) / scale


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def fft_bound_ms(b: int, n: int, itemsize: int,
                 epilogue_flops: int = 0) -> tuple:
    """Least time for a batched length-n DFT of b lines on the card: the
    bytes (each line read once, written once) over HBM bandwidth, and the
    function's 5*n*log2(n) flops per line, plus ``epilogue_flops`` per
    element, over the fp32 peak.  The dense four-step does 8*n*(n1+n2)
    flops per line instead; that is a cost of the algorithm, not of the
    function, so it stays out of the bound."""
    nbytes = 2 * b * n * itemsize
    flops = b * n * (5 * math.log2(n) + epilogue_flops) if n > 1 else 0
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def randc(shape, dtype, device, seed):
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, dtype=dtype, device=device, generator=gen)


def ptxas_report(log: str) -> list:
    """Per kernel instantiation: registers, spill stores/loads and stack
    frame bytes, from ``nvcc -Xptxas -v``; radix instantiations named by
    dtype and (N1, N2)."""
    import re
    entries, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            r = re.search(r"radix_kernelI([fd])Li(\d+)ELi(\d+)E", name)
            if r:
                dt = "complex64" if r.group(1) == "f" else "complex128"
                name = f"radix {dt} N1={r.group(2)} N2={r.group(3)}"
            elif "fourstep_kernel" in name:
                name = ("dense " + ("complex64" if "fourstep_kernelIfE" in name
                                    else "complex128"))
            cur = {"kernel": name}
            entries.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return entries


def phase_build() -> dict:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.build()
    seconds = time.perf_counter() - t0
    print(f"[build] {lib.name}.cu built and loaded in {seconds:.2f} s "
          f"(nvcc {lib.seconds:.2f} s)")
    report = ptxas_report(lib.log)
    for e in report:
        print(f"[build] {e['kernel']}: {e.get('registers')} registers, "
              f"{e.get('spill_stores')}/{e.get('spill_loads')} bytes spill "
              f"stores/loads, {e.get('stack')} bytes stack frame")
    radix_entries = [e for e in report if e["kernel"].startswith("radix")]
    if lib.log:   # an earlier build reused from disk prints no report
        check(len(radix_entries) == 21, f"{len(radix_entries)} radix "
              f"instantiations in the ptxas report, expected 21")
    for e in radix_entries:
        check(e.get("spill_stores", 0) == 0 and e.get("stack", 0) == 0,
              f"{e['kernel']} spills or keeps a stack frame: {e}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    return {"build_s": seconds, "nvcc_s": lib.seconds, "card": card,
            "ptxas": report}


def kernel_cases():
    """(b, n, inverse, pack_parts, twiddle, dtype name, conj) over
    test_kernels.py; ``conj`` names the operand passed as a lazily
    conjugated view ("x" or "twiddle"), or is empty."""
    c64, c128 = "complex64", "complex128"
    cases = []
    for b, n in [(1, 16), (4, 64), (8, 128), (3, 96), (130, 512), (2, 33),
                 (5, 1024)]:
        for inv in (False, True):
            cases.append((b, n, inv, None, False, c64))
    for n in (13, 17, 31):
        for inv in (False, True):
            cases.append((4, n, inv, None, False, c64))
    for b in (1, 127, 129, 300):
        cases.append((b, 64, False, None, False, c64))
    for parts in (2, 4, 8):
        for inv in (False, True):
            cases.append((5, 32, inv, parts, False, c64))
    cases.append((129, 512, False, 2, False, c64))
    for inv in (False, True):
        cases.append((6, 24, inv, None, True, c64))
        cases.append((5, 48, inv, None, False, c128))
    cases.append((130, 512, False, 4, True, c128))
    # W2 streamed from global memory (prime N) and a large balanced N.
    cases.append((7, 521, False, None, False, c64))
    cases.append((3, 4096, True, None, False, c64))
    cases.append((0, 16, False, None, False, c64))
    cases.append((0, 16, False, 4, False, c64))
    cases = [c + ("",) for c in cases]
    cases.append((130, 512, False, None, False, c64, "x"))
    cases.append((130, 512, False, None, True, c64, "twiddle"))
    cases.append((5, 48, True, None, True, c128, "x"))
    # the radix path: every power of two of complex64, both directions at
    # the ends, and every complex128 instantiation (N = 2 runs dense)
    for k in range(1, 13):
        cases.append((67, 2 ** k, k % 2 == 1, None, k % 3 == 0, c64, ""))
    for n in (2, 4096):
        cases.append((3, n, False, None, False, c64, ""))
    for k in range(1, 11):
        cases.append((33, 2 ** k, k % 2 == 0, 2 if k > 1 else None,
                      k % 3 == 1, c128, ""))
    cases.append((33, 256, False, None, True, c128, "x"))
    return cases


def strided_cases():
    """(outer, n, inner, inverse, twiddle, dtype name, conj) of the strided
    entry: inner of one tile, of the main path's middle stage, ragged, and
    the main path's outer stage at a small outer."""
    c64, c128 = "complex64", "complex128"
    return [(8, 512, 16, False, False, c64, ""),
            (8, 512, 512, True, False, c64, ""),
            (3, 512, 1000, False, True, c64, ""),
            (1, 64, 262144, True, False, c64, ""),
            (5, 1024, 48, False, False, c64, ""),
            (4, 2, 300, True, True, c64, ""),
            (6, 128, 40, False, True, c64, "x"),
            (6, 128, 40, False, True, c64, "twiddle"),
            (3, 512, 1000, True, True, c128, ""),
            (4, 32, 17, False, False, c128, "x")]


def phase_kernel_vs_plain(device) -> dict:
    import torch
    from repro_torch.kernels.fft_matmul import fft_fourstep, fft_fourstep_plain
    worst = {"complex64": 0.0, "complex128": 0.0}
    for i, (b, n, inv, parts, tw, dt, conj) in enumerate(kernel_cases()):
        dtype = getattr(torch, dt)
        x = randc((b, n), dtype, device, SEED + i)
        twiddle = None
        if tw:
            k = torch.arange(n, dtype=torch.float64, device=device)
            twiddle = torch.exp(-1j * math.pi * k / (2 * n)).to(dtype)
        if conj == "x":
            x = x.conj()
        elif conj == "twiddle":
            twiddle = twiddle.conj()
        got = fft_fourstep(x, inverse=inv, twiddle=twiddle, pack_parts=parts)
        ref = fft_fourstep_plain(x, inverse=inv, twiddle=twiddle,
                                 pack_parts=parts)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        check(got.shape == ref.shape and got.dtype == ref.dtype,
              f"case {i}: shape/dtype {tuple(got.shape)} {got.dtype} vs "
              f"{tuple(ref.shape)} {ref.dtype}")
        if parts is not None and b:
            buf = got.transpose(0, 1)
            check(buf.is_contiguous(), f"case {i}: pack buffer not "
                  f"destination-major")
        if conj:
            # the plain version honours the conjugate bit; so must the kernel
            want = torch.fft.ifft(x) if inv else torch.fft.fft(x)
            want = want * twiddle if twiddle is not None else want
            check(scaled_err(got, want) <= TOL[dt], f"case {i}: conj "
                  f"{conj} against torch.fft: scaled error "
                  f"{scaled_err(got, want):.3e}")
        err = scaled_err(got, ref)
        worst[dt] = max(worst[dt], err)
        check(err <= TOL[dt], f"case {i} (B={b}, N={n}, inverse={inv}, "
              f"pack={parts}, twiddle={tw}, {dt}, conj={conj!r}): scaled "
              f"error {err:.3e} > {TOL[dt]}")
    from repro_torch.kernels.fft_matmul import (fft_fourstep_strided,
                                                fft_fourstep_strided_plain)
    for i, (outer, n, inner, inv, tw, dt, conj) in enumerate(strided_cases()):
        dtype = getattr(torch, dt)
        x = randc((outer, n, inner), dtype, device, SEED + 500 + i)
        twiddle = None
        if tw:
            k = torch.arange(n, dtype=torch.float64, device=device)
            twiddle = torch.exp(-1j * math.pi * k / (2 * n)).to(dtype)
        if conj == "x":
            x = x.conj()
        elif conj == "twiddle":
            twiddle = twiddle.conj()
        got = fft_fourstep_strided(x, inverse=inv, twiddle=twiddle)
        ref = fft_fourstep_strided_plain(x, inverse=inv, twiddle=twiddle)
        if conj:
            want = (torch.fft.ifft if inv else torch.fft.fft)(x, dim=1)
            if twiddle is not None:
                want = want * twiddle[:, None]
            check(scaled_err(got, want) <= TOL[dt], f"strided case {i}: conj "
                  f"{conj} against torch.fft: scaled error "
                  f"{scaled_err(got, want):.3e}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        check(got.shape == ref.shape and got.is_contiguous(),
              f"strided case {i}: {tuple(got.shape)} vs {tuple(ref.shape)}")
        err = scaled_err(got, ref)
        worst[dt] = max(worst[dt], err)
        check(err <= TOL[dt], f"strided case {i} ((outer, N, inner)="
              f"{(outer, n, inner)}, inverse={inv}, twiddle={tw}, {dt}, "
              f"conj={conj!r}): scaled error {err:.3e} > {TOL[dt]}")
        del x, got, ref
    n_cases = len(kernel_cases()) + len(strided_cases())
    print(f"[kernel] {n_cases} cases match the plain version: worst scaled "
          f"error {worst['complex64']:.3e} (complex64, bound "
          f"{TOL['complex64']}), {worst['complex128']:.3e} (complex128, "
          f"bound {TOL['complex128']})")
    return {"cases": n_cases, "worst_scaled_err": worst}


def phase_main_path(device, grid=GRID, rounds: int = 3, iters: int = 10):
    import torch
    from repro_torch import make_mesh, plan_fft
    from repro_torch.kernels.fft_matmul import (fft_fourstep,
                                                fft_fourstep_plain,
                                                reset_launch_counts)
    mesh = make_mesh((1, 1), ("data", "model"),
                     device=None if device.type == "cuda" else device)
    plan = plan_fft(mesh, grid, backend="kernel")
    print(f"[main] {plan.describe().splitlines()[2].strip()} on "
          f"{mesh.device}")
    x = randc(grid, torch.complex64, device, SEED)

    from repro_torch.kernels import ops

    def counts():
        return (fft_fourstep.launches, fft_fourstep.path_launches["radix"],
                fft_fourstep.layout_launches["strided"], ops.copies["lines"])

    reset_launch_counts()
    for r in range(rounds):
        for name in ("forward", "inverse"):
            before = counts()
            if name == "forward":
                y = plan.forward(x)
                out = y
            else:
                xr = plan.inverse(y, sharded_in=True)
                out = xr
            launches, radix_n, strided_n, copies = (
                a - b for a, b in zip(counts(), before))
            check(copies == 0, f"round {r} {name}: {copies} line copies "
                  f"(movedim+contiguous) on the main path, expected 0")
            check(out.is_contiguous(), f"round {r} {name}: the result is "
                  f"not contiguous")
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                check(launches == 3 and radix_n == 3 and strided_n == 2,
                      f"round {r} {name}: {launches} kernel launches, "
                      f"{radix_n} on the radix path, {strided_n} strided; "
                      f"expected 3, 3 and 2")
    launches = fft_fourstep.launches
    variants = dict(fft_fourstep.variant_launches)
    paths = dict(fft_fourstep.path_launches)
    layouts = dict(fft_fourstep.layout_launches)

    check(tuple(y.shape) == tuple(grid) and y.dtype == torch.complex64,
          f"forward output {tuple(y.shape)} {y.dtype}")
    check(bool(torch.isfinite(torch.view_as_real(y)).all()),
          "forward output has non-finite values")
    ref = torch.fft.fftn(x)
    err_fwd = scaled_err(y, ref)
    del ref
    err_rt = scaled_err(xr, x)
    check(err_fwd <= PATH_TOL, f"forward vs torch.fft.fftn: scaled error "
          f"{err_fwd:.3e} > {PATH_TOL}")
    check(err_rt <= ROUNDTRIP_TOL, f"round trip: scaled error {err_rt:.3e} "
          f"> {ROUNDTRIP_TOL}")
    print(f"[main] {rounds} rounds: forward vs torch.fft.fftn scaled error "
          f"{err_fwd:.3e} (bound {PATH_TOL}), round trip {err_rt:.3e} "
          f"(bound {ROUNDTRIP_TOL}); kernel launches {launches} "
          f"(3 per direction per round), paths {paths}, layouts {layouts}, "
          f"no line copies, results contiguous")
    out = {"grid": list(grid), "rounds": rounds, "launches": launches,
           "variant_launches": variants, "path_launches": paths,
           "layout_launches": layouts, "err_fwd": err_fwd,
           "err_roundtrip": err_rt}
    del xr
    if device.type != "cuda":
        return out

    cplan = plan_fft(mesh, grid, backend="cufft")
    times = {
        "kernel_fwd_ms": time_ms(lambda: plan.forward(x), iters),
        "kernel_inv_ms": time_ms(lambda: plan.inverse(y, sharded_in=True),
                                 iters),
        "cufft_fwd_ms": time_ms(lambda: cplan.forward(x), iters),
        "cufft_inv_ms": time_ms(lambda: cplan.inverse(y, sharded_in=True),
                                iters),
        "fftn_ms": time_ms(lambda: torch.fft.fftn(x), iters),
        "ifftn_ms": time_ms(lambda: torch.fft.ifftn(y), iters),
        # Where a direction's time goes: one stage's kernel on contiguous
        # lines, and the movedim+contiguous copy a strided stage pays.
        "copy_strided_ms": time_ms(
            lambda: x.movedim(0, -1).contiguous(), iters),
    }
    n = grid[-1]
    lines = x.reshape(-1, n)
    got = fft_fourstep(lines)
    ref = fft_fourstep_plain(lines)
    max_abs = float((got - ref).abs().max())
    stage_err = scaled_err(got, ref)
    del got, ref
    check(stage_err <= TOL["complex64"], f"stage kernel at "
          f"{tuple(lines.shape)}: scaled error {stage_err:.3e} > "
          f"{TOL['complex64']}")
    times["stage_kernel_ms"] = time_ms(lambda: fft_fourstep(lines), iters)
    # The strided stages in place: dim 1 ((512, 512, 512), inner 512) and
    # dim 0 ((1, 512, 262144)), against torch.fft.fft along the same dim.
    from repro_torch.kernels.fft_matmul import (fft_fourstep_strided,
                                                fft_fourstep_strided_plain)
    for key, blk, dim in (("strided_mid", x, 1),
                          ("strided_outer", x.reshape(1, n, -1), 0)):
        got = fft_fourstep_strided(blk)
        ref = fft_fourstep_strided_plain(blk)
        err = scaled_err(got, ref)
        times[f"{key}_max_abs_err"] = float((got - ref).abs().max())
        times[f"{key}_scaled_err"] = err
        del got, ref
        check(err <= TOL["complex64"], f"{key} stage kernel at "
              f"{tuple(blk.shape)}: scaled error {err:.3e}")
        times[f"{key}_ms"] = time_ms(lambda: fft_fourstep_strided(blk), iters)
        times[f"{key}_library_ms"] = time_ms(
            lambda: torch.fft.fft(x, dim=dim), iters)
    times["strided_mid_plain_ms"] = time_ms(
        lambda: fft_fourstep_strided_plain(x), 3, 1)
    times["stage_plain_ms"] = time_ms(lambda: fft_fourstep_plain(lines), 3, 1)
    times["stage_library_ms"] = time_ms(lambda: torch.fft.fft(lines), iters)
    bound, by = fft_bound_ms(lines.shape[0], n, lines.element_size())
    times["stage_bound_ms"] = bound
    times["stage_bound_by"] = by
    times["stage_max_abs_err"] = max_abs
    times["stage_scaled_err"] = stage_err
    out.update(times)
    print("[main] times (ms, CUDA events): " + ", ".join(
        f"{k}={v:.3e}" if k.endswith("_err") else
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in times.items()))
    return out


def phase_pack(device, grid=GRID, mesh_shape=(2, 2), iters: int = 10):
    """Stage 0 of the pencil on a 2x2 mesh, at one rank's block shape."""
    import torch
    from repro_torch.compat import Mesh
    from repro_torch.core import make_spec, pencil_nd
    from repro_torch.core.pipeline import _stage_transform, stage_local_shapes
    from repro_torch.core.redistribute import PackedBlock, send_buffer
    from repro_torch.kernels.fft_matmul import (fft_fourstep,
                                                fft_fourstep_plain,
                                                reset_launch_counts)
    names = ("data", "model")
    # One rank's view of a 2x2 mesh: stage transforms read only the axis
    # sizes, so no process group is needed to run stage 0 on one card.
    rank_view = Mesh(names, tuple(mesh_shape), (0, 0), device,
                     {n: None for n in names})
    dec = pencil_nd(names, 3)
    spec = make_spec(rank_view, grid, dec, ("fft",) * 3, backend="kernel")
    block_shape = stage_local_shapes(spec, rank_view)[0]
    xb = randc(block_shape, torch.complex64, device, SEED + 1)
    stage0 = _stage_transform(spec, dec.stages[0], next_hop=dec.redists[0],
                              axis_sizes=rank_view.axis_sizes)
    reset_launch_counts()
    packed = stage0(xb)
    launches = fft_fourstep.variant_launches["pack"]
    check(isinstance(packed, PackedBlock), "stage 0 did not pack")
    parts = rank_view.axis_sizes[dec.redists[0].moves[0].mesh_axis]
    send = send_buffer(packed, dec.redists[0].moves[0].split_dim, parts)
    check(send.data_ptr() == packed.send.data_ptr(),
          "the hop's send buffer is a copy of the kernel output")
    n = block_shape[0]
    lines = xb.movedim(0, -1).reshape(-1, n).contiguous()
    ref = fft_fourstep_plain(lines, pack_parts=parts).transpose(0, 1)
    got = send.reshape(ref.shape)
    err = scaled_err(got, ref)
    check(err <= TOL["complex64"], f"packed stage 0: scaled error {err:.3e}")
    if device.type == "cuda":
        check(launches == 1, f"stage 0 made {launches} pack launches")
    print(f"[pack] block {block_shape} of {grid} on a {mesh_shape} mesh: "
          f"B={lines.shape[0]}, N={n}, p={parts}; matches the plain version "
          f"(scaled error {err:.3e}); send buffer shares the kernel output "
          f"(data_ptr {send.data_ptr():#x})")
    out = {"block": list(block_shape), "parts": parts, "launches": launches,
           "scaled_err": err,
           "max_abs_err": float((got - ref).abs().max())}
    if device.type != "cuda":
        return out
    out["ms"] = time_ms(lambda: fft_fourstep(lines, pack_parts=parts), iters)
    out["plain_ms"] = time_ms(
        lambda: fft_fourstep_plain(lines, pack_parts=parts), 3, 1)
    out["bound_ms"], out["bound_by"] = fft_bound_ms(
        lines.shape[0], n, lines.element_size())
    return out


PPB = ("periodic", "periodic", "bounded")


def dct2_mirrored(x, dim: int = -1):
    """Unnormalized DCT-II along ``dim`` by the mirrored length-2N identity,
    dct2(x)[k] = exp(-i*pi*k/(2N)) * fft(cat(x, flip(x)))[k] for k < N,
    which is linear over the reals, so complex x transforms plane by
    plane.  Shares no code with the port's even/odd reorder."""
    import torch
    xm = x.movedim(dim, -1)
    n = xm.shape[-1]
    k = torch.arange(n, dtype=torch.float64, device=x.device)
    phase = torch.exp(-1j * math.pi * k / (2 * n)).to(torch.complex64)
    full = torch.fft.fft(torch.cat([xm, xm.flip(-1)], dim=-1))
    return (phase * full[..., :n]).movedim(-1, dim)


def neumann_residual(phi, rhs) -> float:
    """Max-scaled residual of the discrete Laplacian on a box of sides 2*pi
    (periodic on dims 0 and 1, Neumann ghost cells on dim 2), as
    tests/test_distributed_fft.py checks the PPB solve."""
    import torch
    dx2 = [(2 * math.pi / n) ** 2 for n in phi.shape]
    pz = torch.cat([phi[:, :, :1], phi, phi[:, :, -1:]], dim=2)
    lap = ((phi.roll(1, 0) + phi.roll(-1, 0) - 2 * phi) / dx2[0]
           + (phi.roll(1, 1) + phi.roll(-1, 1) - 2 * phi) / dx2[1]
           + (pz[:, :, 2:] + pz[:, :, :-2] - 2 * phi) / dx2[2])
    return float((lap - rhs).abs().max() / rhs.abs().max())


def phase_poisson(device, grid=GRID, solves: int = 3, iters: int = 5):
    """The PPB pressure solve on the kernel backend: launches per solve,
    the forward against an independent DCT reference, the solve against a
    float64 solve on the cufft backend, and CUDA-event times."""
    import torch
    from repro_torch import PoissonSolver, make_mesh
    from repro_torch.core.transforms import apply_1d
    from repro_torch.kernels.fft_matmul import (fft_fourstep,
                                                reset_launch_counts)
    cuda = device.type == "cuda"
    mesh = make_mesh((1, 1), ("data", "model"),
                     device=None if cuda else device)
    solver = PoissonSolver(mesh, grid, topology=PPB, backend="kernel")
    print(f"[poisson] {solver.describe().splitlines()[0]}; "
          f"{solver.plan.describe().splitlines()[2].strip()}")
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    rhs = torch.randn(grid, dtype=torch.float32, device=device,
                      generator=gen)
    rhs -= rhs.mean()

    reset_launch_counts()
    for i in range(solves):
        before = dict(fft_fourstep.variant_launches)
        phi = solver(rhs)
        if cuda:
            torch.cuda.synchronize(device)
        got = {k: fft_fourstep.variant_launches[k] - before[k]
               for k in before}
        if cuda:
            check(got == {"fourstep": 6, "pack": 0, "twiddle": 2},
                  f"solve {i}: launches {got}, expected 6 fourstep (2 "
                  f"forward, 4 inverse) and 2 twiddle (forward)")
            check(fft_fourstep.path_launches == {"radix": 8 * (i + 1),
                                                 "dense": 0},
                  f"solve {i}: paths {fft_fourstep.path_launches}, expected "
                  f"every launch on the radix path")
    launches = dict(fft_fourstep.variant_launches)

    before = dict(fft_fourstep.variant_launches)
    yk = solver.plan.forward(rhs)
    fwd = {k: fft_fourstep.variant_launches[k] - before[k] for k in before}
    if cuda:
        torch.cuda.synchronize(device)
        check(fwd == {"fourstep": 2, "pack": 0, "twiddle": 2},
              f"PPB forward: launches {fwd}, expected 2 fourstep and 2 "
              f"twiddle")
    check(tuple(yk.shape) == tuple(grid) and yk.dtype == torch.complex64,
          f"PPB forward output {tuple(yk.shape)} {yk.dtype}")
    check(bool(torch.isfinite(torch.view_as_real(yk)).all()),
          "PPB forward output has non-finite values")
    ref = dct2_mirrored(torch.fft.fft2(rhs, dim=(0, 1)), 2)
    err_fwd = scaled_err(yk, ref)
    del ref
    check(err_fwd <= PATH_TOL, f"PPB forward vs fft2 + mirrored DCT-II: "
          f"scaled error {err_fwd:.3e} > {PATH_TOL}")

    check(tuple(phi.shape) == tuple(grid) and phi.dtype == torch.float32,
          f"solve output {tuple(phi.shape)} {phi.dtype}")
    solver64 = PoissonSolver(mesh, grid, topology=PPB, dtype=torch.float64,
                             backend="cufft")
    phi64 = solver64(rhs.double())
    err_solve = scaled_err(phi.double(), phi64)
    check(err_solve <= PATH_TOL, f"PPB solve vs the float64 solve: scaled "
          f"error {err_solve:.3e} > {PATH_TOL}")
    res64 = neumann_residual(phi64, rhs.double())
    check(res64 <= 1e-3, f"float64 PPB solve: Neumann residual "
          f"{res64:.3e} > 1e-3")
    del phi64, solver64
    print(f"[poisson] {solves} solves: launches {launches} (2 twiddle + 2 "
          f"fourstep per forward, 4 fourstep per inverse); forward vs fft2 "
          f"+ mirrored DCT-II scaled error {err_fwd:.3e} (bound {PATH_TOL}), "
          f"solve vs float64 solve {err_solve:.3e} (bound {PATH_TOL}), "
          f"float64 Neumann residual {res64:.3e} (bound 1e-3)")
    out = {"grid": list(grid), "solves": solves, "launches": launches,
           "forward_launches": fwd, "err_fwd": err_fwd,
           "err_solve": err_solve, "float64_neumann_residual": res64}
    if not cuda:
        return out

    csolver = PoissonSolver(mesh, grid, topology=PPB, backend="cufft")
    y01 = torch.fft.fft2(rhs, dim=(0, 1))
    times = {
        "solve_kernel_ms": time_ms(lambda: solver(rhs), iters),
        "solve_cufft_ms": time_ms(lambda: csolver(rhs), iters),
        "fwd_kernel_ms": time_ms(lambda: solver.plan.forward(rhs), iters),
        "inv_kernel_ms": time_ms(
            lambda: solver.plan.inverse(yk, sharded_in=True), iters),
        # The bounded dim alone: planes split, even/odd reorder, one
        # launch per plane (twiddle forward, fourstep inverse), recombine.
        "dct2_stage_ms": time_ms(
            lambda: apply_1d(y01, 2, "dct2", backend="kernel"), iters),
        "dct3_stage_ms": time_ms(
            lambda: apply_1d(yk, 2, "dct3", backend="kernel"), iters),
        "dct2_stage_cufft_ms": time_ms(
            lambda: apply_1d(y01, 2, "dct2", backend="cufft"), iters),
    }
    out.update(times)
    print("[poisson] times (ms, CUDA events): " + ", ".join(
        f"{k}={v:.4f}" for k, v in times.items()))
    return out


def phase_r2c(device, grid=GRID):
    """``kinds=("rfft", "fft", "fft")`` on the kernel backend: launches per
    direction, forward against torch.fft.fftn, round trip."""
    import torch
    from repro_torch import make_mesh, plan_fft
    from repro_torch.kernels.fft_matmul import (fft_fourstep,
                                                reset_launch_counts)
    cuda = device.type == "cuda"
    mesh = make_mesh((1, 1), ("data", "model"),
                     device=None if cuda else device)
    plan = plan_fft(mesh, grid, kinds=("rfft", "fft", "fft"),
                    backend="kernel")
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    x = torch.randn(grid, dtype=torch.float32, device=device, generator=gen)
    reset_launch_counts()
    y = plan.forward(x)
    per_fwd = fft_fourstep.launches
    xr = plan.inverse(y, sharded_in=True)
    per_inv = fft_fourstep.launches - per_fwd
    if cuda:
        torch.cuda.synchronize(device)
        check(per_fwd == 3 and per_inv == 3, f"R2C: {per_fwd} forward and "
              f"{per_inv} inverse launches, expected 3 each")
    nfreq = grid[0] // 2 + 1
    check(tuple(y.shape) == (nfreq,) + tuple(grid[1:])
          and y.dtype == torch.complex64, f"R2C forward output "
          f"{tuple(y.shape)} {y.dtype}")
    check(xr.dtype == torch.float32, f"R2C inverse output {xr.dtype}")
    err_fwd = scaled_err(y, torch.fft.fftn(x)[:nfreq])
    err_rt = scaled_err(xr, x)
    check(err_fwd <= PATH_TOL, f"R2C forward vs torch.fft.fftn: scaled "
          f"error {err_fwd:.3e} > {PATH_TOL}")
    check(err_rt <= ROUNDTRIP_TOL, f"R2C round trip: scaled error "
          f"{err_rt:.3e} > {ROUNDTRIP_TOL}")
    print(f"[r2c] {tuple(grid)} -> {tuple(y.shape)}: forward vs "
          f"torch.fft.fftn[:{nfreq}] scaled error {err_fwd:.3e} (bound "
          f"{PATH_TOL}), round trip {err_rt:.3e} (bound {ROUNDTRIP_TOL}); "
          f"launches {per_fwd} forward, {per_inv} inverse")
    return {"grid": list(grid), "launches_fwd": per_fwd,
            "launches_inv": per_inv, "err_fwd": err_fwd,
            "err_roundtrip": err_rt}


def phase_twiddle_timing(device, b: int = 262144, n: int = 512,
                         iters: int = 10) -> dict:
    """The twiddle epilogue at the PPB solve's DCT-II stage shape: the
    512^2 lines of length 512 of one plane."""
    import torch
    from repro_torch.kernels.fft_matmul import fft_fourstep, fft_fourstep_plain
    lines = randc((b, n), torch.complex64, device, SEED + 2)
    k = torch.arange(n, dtype=torch.float64, device=device)
    tw = torch.exp(-1j * math.pi * k / (2 * n)).to(torch.complex64)
    got = fft_fourstep(lines, twiddle=tw)
    ref = fft_fourstep_plain(lines, twiddle=tw)
    out = {"max_abs_err": float((got - ref).abs().max()),
           "scaled_err": scaled_err(got, ref)}
    del got, ref
    check(out["scaled_err"] <= TOL["complex64"], f"twiddle epilogue at "
          f"({b}, {n}): scaled error {out['scaled_err']:.3e}")
    out["ms"] = time_ms(lambda: fft_fourstep(lines, twiddle=tw), iters)
    out["plain_ms"] = time_ms(lambda: fft_fourstep_plain(lines, twiddle=tw),
                              3, 1)
    # the twiddle is one more complex product (6 flops) per element
    out["bound_ms"], out["bound_by"] = fft_bound_ms(
        b, n, lines.element_size(), epilogue_flops=6)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the port "
              "on a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version: fp32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t0 = time.perf_counter()
    report = {"build": phase_build()}
    report["kernel_vs_plain"] = phase_kernel_vs_plain(device)
    report["main"] = main_run = phase_main_path(device)
    torch.cuda.empty_cache()
    report["pack"] = pack = phase_pack(device)
    torch.cuda.empty_cache()
    report["poisson"] = poisson = phase_poisson(device)
    torch.cuda.empty_cache()
    report["twiddle"] = tw = phase_twiddle_timing(device)
    torch.cuda.empty_cache()
    report["r2c"] = phase_r2c(device)
    kernels = [
        {"name": "fft_fourstep", "route": "cuda", "source": RADIX_SOURCE,
         "path": "radix",
         "replaces": "src/repro/kernels/fft_matmul.py:216",
         "launches": main_run["launches"],
         "max_abs_err": main_run["stage_max_abs_err"],
         "scaled_err": main_run["stage_scaled_err"],
         "ms": main_run["stage_kernel_ms"],
         "plain_ms": main_run["stage_plain_ms"],
         "bound_ms": main_run["stage_bound_ms"],
         "bound_by": main_run["stage_bound_by"],
         "library_ms": main_run["stage_library_ms"]},
        {"name": "fft_fourstep_strided", "route": "cuda",
         "source": RADIX_SOURCE, "path": "radix",
         "replaces": "src/repro/kernels/fft_matmul.py:216",
         "launches": main_run["layout_launches"]["strided"],
         "max_abs_err": main_run["strided_mid_max_abs_err"],
         "scaled_err": main_run["strided_mid_scaled_err"],
         "ms": main_run["strided_mid_ms"],
         "plain_ms": main_run["strided_mid_plain_ms"],
         "bound_ms": main_run["stage_bound_ms"],
         "bound_by": main_run["stage_bound_by"],
         "library_ms": main_run["strided_mid_library_ms"]},
        {"name": "fft_fourstep_pack", "route": "cuda",
         "source": RADIX_SOURCE, "path": "radix",
         "replaces": "src/repro/kernels/fft_matmul.py:134",
         "launches": pack["launches"], "max_abs_err": pack["max_abs_err"],
         "scaled_err": pack["scaled_err"],
         "ms": pack["ms"], "plain_ms": pack["plain_ms"],
         "bound_ms": pack["bound_ms"], "bound_by": pack["bound_by"],
         "library_ms": None},
        {"name": "fft_fourstep_twiddle", "route": "cuda",
         "source": RADIX_SOURCE, "path": "radix",
         "replaces": "src/repro/kernels/fft_matmul.py:126",
         "launches": poisson["launches"]["twiddle"],
         "max_abs_err": tw["max_abs_err"], "scaled_err": tw["scaled_err"],
         "ms": tw["ms"], "plain_ms": tw["plain_ms"],
         "bound_ms": tw["bound_ms"], "bound_by": tw["bound_by"],
         "library_ms": None},
    ]
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t0
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print("[twiddle] the DCT-II stage's kernel at (262144, 512): "
          + json.dumps(tw))
    print(f"[done] {report['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
