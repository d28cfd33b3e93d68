#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero without printing
its result line):

1. build the CUDA kernel from ``src/repro_torch/csrc`` (its translation
   units compiled at once, ``kernels/build.py``) and print the build
   time, ``ptxas``'s registers, spills and stack frame per kernel
   instantiation (a radix, long-line, wide or dense instantiation, the
   split route's passes included, that spills or keeps a stack frame
   fails the run; one wide instantiation per length of
   ``longline.WIDE``)
   and the card's ``nvidia-smi`` name and power limit;
2. hold the four-step kernel against its plain PyTorch version on the card
   over the shapes of ``tests/test_kernels.py`` (both directions, prime N,
   empty batch, ragged tiles, ``pack_parts``, the twiddle, complex128,
   lazily conjugated operands and twiddles), every radix-path, long-line
   and split length of both dtypes (the long and split ones, powers of two
   and mixed lengths, a second mixed factor R2 included, with both
   epilogues, also against ``torch.fft``),
   every mixed radix length of
   both dtypes (r*2^k, r in ``radix.RADIX_ODD``, 3 to 1701, 17 and 19
   included, where both factors fit a codelet: both directions, both
   epilogues, a ``pack_parts`` segment that is not a power of two, also
   against ``torch.fft``; the wide lines among them, and the powers of
   two 2048 and 4096 (complex64) and 512 and 1024 (complex128), on the
   long route's wide kernel, batches ragged against its tile), the dense route's families (odd 13-smooth
   N, the even ones no codelets hold, the spill lengths, N with a prime
   factor past 13 that ``dense.GENERIC_COST`` keeps and such primes, the
   13-smooth lengths past the old one-block limit; both dtypes,
   directions and epilogues, ragged batches, also against ``torch.fft``),
   chirp lengths of both routes of its M (the dense route's kernel and a
   split plan), and
   strided ``(outer, N, inner)`` blocks through ``fft_fourstep_strided``
   (inner of one tile, 512, ragged 1000, 262144; every mixed length whose
   strided tile fits one block, against ``torch.fft`` too);
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
8. ``[chunked]``: the 512^3 C2C kernel plan with ``n_chunks=2`` and the
   per-hop ``(4, 2)``: launches per direction (one per chunk of each hop's
   next stage, all radix), the chunk dim per hop, ``ops.copies["lines"]``
   per direction, forward and inverse against the bulk plan (5e-6 scaled,
   and whether bitwise equal) and forward against ``torch.fft.fftn``
   (2e-4), and CUDA-event ms per direction beside the bulk plan's;
9. ``[calibrate]``: ``perfmodel.calibrate`` on the card (after the build,
   so no build lands in a timing): ``backend_flops`` per backend,
   ``mem_bw``, ``net_calibrated`` and the seconds it took;
10. ``[tune]``: ``tuning="heuristic"`` for C2C 512^3 (winner, predicted
    and measured ms); ``tuning="auto"`` with a wisdom file in a temporary
    directory (winner no slower than the default candidate in the tuner's
    own record, output against ``fftn``, a second plan reading the file
    without a measurement); ``PoissonSolver(tuning="auto")`` for the PPB
    512^3 solve (winner, ms per solve beside phase 5's, solve against the
    float64 solve).  Kernel launches are counted over each tuning run;
11. ``[segments]``: the 512^3 C2C kernel plan's chained stage segments,
    forward and inverse, bitwise equal to ``plan.forward`` and
    ``plan.inverse``, with the plan's launch counts (3 per direction, all
    radix, 2 strided, no line copy);
12. ``[executor]``: three batched (16, 1024, 1024) 2-D entries, a 512^3
    forward and its inverse, all on the kernel backend, through the
    plan-stream executor in the async, pool and timed modes, each output
    bitwise equal to its solo run; the solo sum, the interleaved time and
    the overlap beside ``report()["predicted"]``, the timed run's
    per-segment ms, the peak memory beside two boundary buffers per
    entry, and a donated operand read back as emptied;
13. ``[analysis]``: the ``[executor]`` queue under the static verifier and
    the sanitizer (``repro_torch.analysis``): every mode with
    ``verify="strict", sanitize=True`` gives no verify error and 0 SAN001,
    outputs bitwise equal to solo and the same 12 launches; pool mode
    without turns is flagged SCHED001 and refused with no launch; a
    donated operand is emptied as the donation table says;
    ``plan.verify()`` is clean on the 512^3 plan; the host ms of
    ``verify_schedule()``, of the check inside ``run()``, of
    ``sanitize_json()`` and of a verified enqueue beside the plain one;
14. ``[serve]``: ``launch/serve_fft.py`` on the card (grids (1024, 1024)
    and (1024, 2048), odd grids that pad into the first, 48 requests in
    rounds of 16, the tuner pinned to the kernel, a wisdom file in a
    temporary directory): every result within 1e-4 of ``torch.fft.fftn``,
    hit rate >= 0.8, a warmed first drain that builds no plan and no
    kernel, and the traffic drains' launches exactly 2 per routed batch
    (one on lines, one strided, all radix, no line copy); three such
    service lifetimes, each with its p50/p99 latency and requests per
    second, and a fourth with ``verify="strict"`` whose
    ``verify_warnings`` stay empty; the metrics JSON in
    ``chiprun_out/serve_fft_metrics_<w>.json``;
15. ``[lm]``: the LM substrate's ``launch/serve.py`` at qwen3-8b's full
    width and depth (36 layers, float32 masters, bfloat16 activations; 8
    requests in batches of 4, 32-token prompts, 16 new tokens), twice from
    one seed: every request gets 16 tokens in ``[0, padded_vocab)``, the
    same both times, and no kernel launch (this path has none).  Then
    finite prefill logits, one decode step against a full forward (rel
    < 0.15), the card against the CPU on the same weights cut to 2 layers
    in float32 (1e-4), CUDA-event ms of prefill and per decode step,
    tokens/s, peak memory, parameter bytes, the decode step's HBM bound,
    and one decode and one prefill step under ``torch.profiler`` (busy
    share, busiest kernels);
16. ``[lm_archs]``: the 10 smoke configs through prefill and 3 decode
    steps on the card against the CPU (float32 within 1e-4 with equal
    greedy tokens, bfloat16 within 5e-2);
17. ``[long]``: the long-line kernel at the mixer's (8192, 8192)
    complex64 lines against its plain version and ``torch.fft``, timed
    beside its bound; the other long lengths of both dtypes at 512 MB; the
    radix route at (262144, 544 = 17*32), the dense route's generic
    17-stage before the radix-17 codelet; the dense route at (262144, 816
    = 3*17*16), a length no other route takes (a generic 17-stage); each
    reached once through
    ``ops.fft1d`` (one launch on its path); then ``[split]``: the split route (lines beyond one block,
    N = P*Q in two launches through HBM, three with rows on the
    long-line route) at complex64 N = 2^15, 2^16, 2^20, 2^24 and
    complex128 2^14, 2^16, 2^22, about 512 MB of lines each, through
    ``ops.fft1d``/``ops.ifft1d`` (1 split call per call), against its
    plain version and ``torch.fft``, both epilogues, timed beside
    ``torch.fft`` and the bound;
    ``[split_plan]``: a ``plan_fft`` C2C plan of (64, 64, 32768)
    complex64 on the kernel against ``fftn``, launches per path and line
    copies recorded; ``[mixed]``: the radix route at mixed lengths,
    (262144, 384), (262144, 448), (262144, 416), (262144, 672), (262144,
    360) and (262144, 600) complex64, one length per odd part 3 to 63
    and dtype and, for the odd parts from 65, complex64 1000, 1800, 2400
    and 3600 and complex128 300 and 900, and the longest 17*2^k, 19*2^k
    and 23*2^k of each dtype, at 512 MB, each once through
    ``ops.fft1d`` (one launch: on the radix route, or on the long route's
    wide kernel for the wide lines of ``longline.WIDE``, such as
    complex64 2944 and 3600 and complex128 864 and 900), against its
    plain version and ``torch.fft``, timed beside ``torch.fft`` and the
    bound;
    ``[mixed_plan]``: ``plan_fft`` C2C at 384^3, 448^3, 416^3, 360^3 and
    600^3 complex64 on
    the kernel, 3 radix launches per direction (2 strided), 0 dense, 0
    chirp, 0 line copies, against ``fftn`` and the round trip, ms per
    direction beside ``fftn``, a ``cufft`` plan and the bound; the PPB
    solve at 384^3 against the ``cufft`` backend's, 8 radix launches;
    ``[long_mixed]``: the long-line route at every mixed length of both
    dtypes (complex64 4352-15360, complex128 1088-7680; an odd R1 for
    17*2^k, 19*2^k, 21*2^k, 23*2^k, 25*2^k and 27*2^k), 512 MB each, once
    through
    ``ops.fft1d``
    (one "long" launch), against its plain version and ``torch.fft``,
    timed beside ``torch.fft`` and the bound, then 14 lengths with a
    second mixed factor R2 (complex64 4480 to 11520, complex128 1056 to
    5760) that left the dense kernel or the chirp route, at 256 MB beside
    their time there;
    ``[split_mixed]``: the split route at mixed lengths (complex64 24576,
    49152, 98304, 3*2^21, 15*2^19 and the shortest and longest 7*2^k,
    11*2^k, 13*2^k, 17*2^k, 19*2^k, 21*2^k, 23*2^k, 25*2^k and 27*2^k;
    complex128 12288, 24576, 9*2^15 and likewise) and at lengths of its
    rule (complex64 33792 = 256 x 132, 1982464 = 512 x 3872 and 33*2^18
    = 1024 x 8448), 512 MB each, likewise (one split call);
    ``[split_general]``: the split route's general plans (pass B on the
    dense route's launch, pass C for any P and Q; pass A on the radix
    route or the dense kernel's column form) at complex64 29106, 30976,
    33075, 44100, 96000, 10^6, 13^6, complex128 14406 (256 MB) and
    complex64 10^7, 3^15, complex128 2278125, 4084223 (512 MB; they raised
    before), and past the split route's old limit its nested plans (rows
    on their own route) at complex64 3^16, 2^25 and complex128 2^23 (512
    MB; they raised before), likewise (one split call of 3 launches, more
    where a nested plan's rows run on the split route), within 2e-4 of
    ``torch.fft``, the inverse with both epilogues against the plain
    version, and one gradient through ``LineTransform``; ``[mixed_long_plan]``:
    ``plan_fft`` C2C of (128, 128, 6144) complex64 on the kernel against
    ``fftn`` and the round trip, the 6144 axis on the long-line route, no
    dense or chirp launch, no copy, ms beside ``fftn`` and a ``cufft``
    plan; then likewise one face of the LLC4320 ocean grid, (4320, 4320)
    complex64 (4320 = 30 x 9 x 16): 2 long launches per direction, no
    dense or chirp launch, 2 line copies forward and 1 inverse;
    ``[chirp]``: the chirp route (Bluestein over two transforms of M,
    the cheapest 13-smooth length from 2N - 1, on the dense route's
    kernel, the long-line route or a split plan, the input's chirp in the
    first one's load and the first N kept by the second one's store) at
    lengths no other route
    takes, complex64 7424, 10007, 20011, the prime 4831 and complex128
    3001, 3712 and 4099 (M on the long-line, dense or split route, each
    checked), 256 MB each, and past the chirp's old limit complex64
    8388617, 2^24 + 1 and complex128 2^21 + 1, 512 MB each, once through
    ``ops.fft1d`` (one chirp call, its launches on "chirp", 2 where M is
    on the dense route's kernel or the long-line route), against its
    plain version and within
    2e-4 of ``torch.fft``, the inverse with both epilogues (no line copy),
    timed beside ``torch.fft`` and the bound;
    ``[gaps]``: likewise on the dense route at the lengths it had with
    the widest gaps (complex64 2730, 3430, 4050 and the odd 4725,
    complex128 990), the 13-smooth lengths it took from the chirp
    (complex64 16896, 23040, complex128 8448) and its generic stage
    (complex64 3264 = 3*17*64, complex128 1824 = 3*19*32), and complex64
    1616 = 101*16, on the chirp since the refit, 256 MB each, one dense
    launch each (two chirp launches at 1616); then
    ``[lm_fftconv]``: the FFT long-convolution mixer at jamba-v0.1-52b's
    width (8192 channels), B=1, S=2048, 3072, 3584, 4096, 8192, 12288,
    16384 and 32768: ``fft_backend="kernel"`` within 1e-4 of ``"cufft"``
    in float32 with the launches of 3 transforms of lines of 2S per call
    on their path (long, long, long, long, long, split, split, split, the
    first on the wide kernel: a
    split transform
    is 2 launches, one strided), none on another path (no chirp call), and
    no line copy; the
    mixer's and its 3 transforms' ms on both backends beside the
    transforms' bound, the peak memory at S=32768;
18. ``[train_fftconv]``: the same mixer's forward and backward at S=2048,
    3072, 4096 and 16384 in float32 on ``fft_backend="kernel"`` (the line
    transforms' autograd Function) against ``"cufft"``: every gradient
    within 1e-4, the launches of 6 transforms of lines of 2S on their
    path (long: the wide kernel, long, long, split) and no line copy,
    CUDA-event ms on both
    backends beside the 6 transforms' bound;
19. ``[train]``: the LM train step at qwen3-8b's full width with the
    depth cut to 8 of 36 layers (float32 masters and AdamW moments,
    bfloat16 activations, remat, bfloat16 gradients), B=1, S=4096, 5
    steps of ``SyntheticLM`` data, twice from one seed: losses finite and
    falling, the two runs within 1e-3; the card against the CPU at 2
    layers in float32 (loss and gradient leaves within 1e-4); ms per
    step, tokens/s, the FLOP and byte bounds, peak memory and one
    profiled step;
20. ``[train_ckpt]``: ``launch/train.py``'s ``train`` at the smoke
    config in a temporary directory, preempted at step 10 and resumed,
    against 20 uninterrupted steps (losses within 1e-3), the checkpoint
    restored onto the CPU equal to its restore onto the card;
21. ``[lm_sharded]``: the LM's mesh path on an NCCL group of one with an
    explicit (1, 1) ``("data", "model")`` mesh: ``serve`` (2 requests of
    8 new tokens) and two ``train`` steps (B=1, S=4096) at qwen3-8b's
    full width cut to 2 layers, each bitwise equal to the same run with
    ``mesh=None``; then ``fft_conv`` at 8192 channels, S=2048, float32,
    forward and backward through the mesh path (``rules`` of that mesh)
    on the kernel: exactly 6 launches on lines on the wide kernel's
    route (lines of 4096) and no line copy,
    every gradient within 1e-4 of ``cufft``'s;
22. a ``kernels`` JSON line (one entry per kernel variant, with the path
    it ran and, for B1 and B4, the launches on the segments, executor,
    analysis, serve and lm paths;
    the serve counts are the first lifetime's traffic drains; the
    long-line entry's launches are the mixer's at S=4096, the dense
    entry's its ``[long]`` call at (262144, 816), the split entry's the
    mixer's at
    S=16384, with S=32768's and ``[train_fftconv]``'s at S=16384 beside
    them, the mixed entry's the 384^3 plan's forward, the chirp entry's
    ``[chirp]``'s calls, the long_mixed entry's the mixer's at S=3072 and
    the split_mixed entry's the mixer's at S=12288, the wide entry's the
    mixer's at S=2048, with ``[train_fftconv]``'s and ``[lm_sharded]``'s
    at S=2048 and ``[mixed]``'s wide lines beside them; every entry
    launched on its main path), then the result line.

Measurements also go to ``chiprun_out/chip_smoke.json``.  Exits non-zero
when CUDA is not available.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
DENSE_SOURCE = "src/repro_torch/csrc/fft_dense.cuh"
RADIX_SOURCE = "src/repro_torch/csrc/fft_radix.cuh"
LONG_SOURCE = "src/repro_torch/csrc/fft_long.cuh"
WIDE_SOURCE = "src/repro_torch/csrc/fft_wide.cuh"
SPLIT_SOURCE = "src/repro_torch/kernels/split.py"
CHIRP_SOURCE = "src/repro_torch/kernels/chirp.py"
#: The source of the kernel that runs the chirp's transforms, by M's route
#: (``chirp.chirp_plan``): on a split plan pass A, the dense kernel's
#: columns.
CHIRP_ROUTE_SOURCE = {"dense": DENSE_SOURCE, "long": LONG_SOURCE,
                      "split": DENSE_SOURCE}
#: The routes of B1, as ``radix.kernel_path`` names them and
#: ``fft_fourstep.path_launches`` counts their launches.
KERNEL_PATHS = ("radix", "dense", "long", "split", "chirp")


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
    element, over the fp32 peak.  A generic stage of the dense route
    does 8*n*p flops per line instead; that is a cost of the algorithm,
    not of the function, so it stays out of the bound."""
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
    dtype, (N1, N2) and mode (the split route's passes: "split A", "split
    B"), long-line ones by dtype, R1xR2xR3 and ring depth (a mixed
    length's: "mixed"), the split route's pass C ("split transpose any",
    "split transpose keep") by dtype, its pass B with pass C folded in
    ("fold dense" by dtype and "keep", "fold long" by
    dtype and R1xR2xR3), the dense route's by dtype."""
    import re
    modes = {"0": "", "1": " split A", "2": " split B"}
    entries, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            r = re.search(r"radix_kernelI([fd])Li(\d+)ELi(\d+)ELi(\d)E",
                          name)
            lg = re.search(r"long_kernelI([fd])Li(\d+)ELi(\d+)ELi(\d+)E"
                           r"Li(\d+)E", name)
            lm = re.search(r"long_mixed_kernelI([fd])Li(\d+)ELi(\d+)E"
                           r"Li(\d+)E", name)
            tr = re.search(r"split_transpose(_mixed|_any|_keep)?_kernelI"
                           r"([fd])E", name)
            fd = re.search(r"split_fold_dense_kernelILb([01])E([fd])E",
                           name)
            fl = re.search(r"split_fold_(long|mixed)_kernelI([fd])"
                           r"Li(\d+)ELi(\d+)ELi(\d+)E", name)
            ds = re.search(r"dense_column(_chirp)?_kernelI([fd])E", name)
            dc = re.search(r"dense_chirp_kernelI([fd])E", name)
            lc = re.search(r"long_chirp_kernelI([fd])Li(\d+)ELi(\d+)E"
                           r"Li(\d+)ELi(\d+)ELi(\d)E", name)
            wd = re.search(r"wide_kernelI([fd])((?:Li\d+E){5})", name)
            if r:
                dt = "complex64" if r.group(1) == "f" else "complex128"
                name = (f"radix {dt} N1={r.group(2)} N2={r.group(3)}"
                        f"{modes[r.group(4)]}")
            elif fd:
                dt = "complex64" if fd.group(2) == "f" else "complex128"
                name = (f"fold dense {dt}"
                        + (" keep" if fd.group(1) == "1" else ""))
            elif fl:
                dt = "complex64" if fl.group(2) == "f" else "complex128"
                name = (f"fold long {dt} {fl.group(3)}x{fl.group(4)}x"
                        f"{fl.group(5)}"
                        + (" mixed" if fl.group(1) == "mixed" else ""))
            elif wd:
                dt = "complex64" if wd.group(1) == "f" else "complex128"
                r1, r2, r3, lt, blocks = re.findall(r"Li(\d+)E",
                                                    wd.group(2))
                name = f"wide {dt} {r1}x{r2}x{r3} tile {lt} blocks {blocks}"
            elif lc:
                dt = "complex64" if lc.group(1) == "f" else "complex128"
                name = (f"chirp long {dt} {lc.group(2)}x{lc.group(3)}x"
                        f"{lc.group(4)} ring {lc.group(5)} fold "
                        f"{'in' if lc.group(6) == '1' else 'out'}")
            elif lg:
                dt = "complex64" if lg.group(1) == "f" else "complex128"
                name = (f"long {dt} {lg.group(2)}x{lg.group(3)}x"
                        f"{lg.group(4)} ring {lg.group(5)}")
            elif lm:
                dt = "complex64" if lm.group(1) == "f" else "complex128"
                name = (f"long {dt} {lm.group(2)}x{lm.group(3)}x"
                        f"{lm.group(4)} mixed")
            elif tr:
                name = ("split transpose "
                        + ("complex64" if tr.group(2) == "f"
                           else "complex128")
                        + (" " + tr.group(1)[1:] if tr.group(1) else ""))
            elif ds:
                name = ("dense columns "
                        + ("complex64" if ds.group(2) == "f"
                           else "complex128")
                        + (" chirp" if ds.group(1) else ""))
            elif dc:
                name = ("dense chirp "
                        + ("complex64" if dc.group(1) == "f"
                           else "complex128"))
            elif "dense_kernel" in name:
                name = ("dense " + ("complex64" if "dense_kernelIfE" in name
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


def phase_build(timer=time.perf_counter) -> dict:
    from repro_torch.kernels import build
    t0 = timer()
    lib = build.build()
    seconds = timer() - t0
    print(f"[build] {lib.name}.cu built and loaded in {seconds:.2f} s "
          f"(nvcc {lib.seconds:.2f} s, {build.PARTS + 1} units at once)")
    report = ptxas_report(lib.log)
    for e in report:
        print(f"[build] {e['kernel']}: {e.get('registers')} registers, "
              f"{e.get('spill_stores')}/{e.get('spill_loads')} bytes spill "
              f"stores/loads, {e.get('stack')} bytes stack frame")
    radix_entries = [e for e in report if e["kernel"].startswith("radix")]
    long_entries = [e for e in report if e["kernel"].startswith("long")]
    split_entries = [e for e in report if e["kernel"].startswith("split")]
    dense_entries = [e for e in report if e["kernel"].startswith("dense")]
    chirp_entries = [e for e in report if e["kernel"].startswith("chirp")]
    wide_entries = [e for e in report if e["kernel"].startswith("wide")]
    fold_entries = [e for e in report if e["kernel"].startswith("fold")]
    if lib.log:   # an earlier build reused from disk prints no report
        from repro_torch.kernels import longline, radix, split
        plain = sum(len(sizes) for sizes in radix.RADIX_SIZES.values())
        want = plain + sum(len(split.COLUMN_SIZES[d]) + len(split.ROW_SIZES[d])
                           for d in split.COLUMN_SIZES)
        check(len(radix_entries) == want, f"{len(radix_entries)} radix "
              f"instantiations in the ptxas report, expected {want} "
              f"({plain} plain: 21 powers of two and the mixed lengths; "
              f"the split route's passes A and B)")
        want = sum(len(sizes) for sizes in longline.FACTORS.values())
        check(len(long_entries) == want, f"{len(long_entries)} long-line "
              f"instantiations in the ptxas report, expected {want} (5 "
              f"powers of two, the rest mixed lengths)")
        check(len(split_entries) == 4, f"{len(split_entries)} split "
              f"transpose instantiations in the ptxas report, expected 4 "
              f"(per dtype: pass C of any P and Q, and the chirp's that "
              f"keeps the first N)")
        want = 4 + sum(len(qs) for qs in split.FOLD_LONG_ROWS.values())
        check(len(fold_entries) == want, f"{len(fold_entries)} "
              f"instantiations of pass B with pass C folded in, expected "
              f"{want} (per dtype the dense rows' with and without the "
              f"chirp's keep, and one per long row of "
              f"split.FOLD_LONG_ROWS)")
        want = 2 * sum(len(sizes) for sizes in longline.FOLD_SIZES.values())
        check(len(chirp_entries) == want, f"{len(chirp_entries)} long-line "
              f"instantiations of the chirp's folded load and store, "
              f"expected {want} (two per length of longline.FOLD_SIZES)")
        want = sum(len(plans) for plans in longline.WIDE.values())
        check(len(wide_entries) == want, f"{len(wide_entries)} wide "
              f"instantiations in the ptxas report, expected {want} (one "
              f"per length of longline.WIDE)")
        check(len(dense_entries) == 8, f"{len(dense_entries)} dense "
              f"instantiations in the ptxas report, expected 8 (per "
              f"dtype, for every length: the dense route's, the split "
              f"route's columns, and each with the chirp's folded load "
              f"and store)")
    for e in (radix_entries + long_entries + split_entries + dense_entries
              + chirp_entries + wide_entries + fold_entries):
        check(e.get("spill_stores", 0) == 0 and e.get("stack", 0) == 0,
              f"{e['kernel']} spills or keeps a stack frame: {e}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    return {"build_s": seconds, "nvcc_s": lib.seconds, "card": card,
            "ptxas": report, "fold_functions": len(fold_entries)}


#: (b, N, inverse, pack_parts, twiddle, dtype name, M's route) of the
#: chirp route in ``kernel_cases``: M (``chirp.chirp_plan``) on each route
#: in both dtypes, both directions and epilogues.  The dense route's
#: kernel: the primes c64 101 (M = 208), 521 (1183) and 10007 (20449),
#: c128 101 (208) and 4099 (8281); the long-line route's powers of two:
#: c64 7424 = 29*2^8 and 4831 (16384), c128 3001 and 3712 (8192) and 1021
#: (2048); a split plan: c64 20011 (40040 = 385 x 104), c128 8009 (16038
#: = 198 x 81).  ``phase_kernel_vs_plain`` checks each route.
CHIRP_CASES = ((2, 7424, False, None, True, "complex64", "long"),
               (3, 7424, True, 2, False, "complex64", "long"),
               (2, 4831, True, None, True, "complex64", "long"),
               (5, 101, False, None, True, "complex64", "dense"),
               (5, 521, False, None, True, "complex64", "dense"),
               (1, 10007, True, None, True, "complex64", "dense"),
               (1, 20011, False, None, True, "complex64", "split"),
               (2, 3001, False, None, True, "complex128", "long"),
               (1, 3712, True, 29, False, "complex128", "long"),
               (3, 1021, False, None, True, "complex128", "long"),
               (3, 101, True, None, True, "complex128", "dense"),
               (2, 4099, True, None, True, "complex128", "dense"),
               (1, 8009, False, None, True, "complex128", "split"))


def kernel_cases():
    """(b, n, inverse, pack_parts, twiddle, dtype name, conj) over
    test_kernels.py; ``conj`` names the operand passed as a lazily
    conjugated view ("x" or "twiddle"), or is empty."""
    import torch
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
    # a prime N (the chirp route, M = 2048 on the radix route) and a
    # large balanced N.
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
    # the long-line path: every length of both dtypes, both directions,
    # the twiddle and pack epilogues, batches ragged against the grid
    # (segments of N/2 where 4 does not divide N: complex128 882 = 2*441)
    from repro_torch.kernels import longline
    for dtype, sizes in longline.FACTORS.items():
        dt = str(dtype).removeprefix("torch.")
        for n in sizes:
            cases += [(5, n, False, None, False, dt, ""),
                      (3, n, True, None, True, dt, ""),
                      (7, n, False, 2, False, dt, ""),
                      (301, n, True, 4 if n % 4 == 0 else 2, True, dt, "")]
    cases.append((3, 8192, False, None, True, c64, "x"))
    cases.append((3, 4096, True, None, True, c128, "x"))
    # the split route: every length of the measured table of both dtypes,
    # both directions, each epilogue, a line or two; of the rule's lengths
    # (split.rule_factors) the shortest of each Q, so every pass-B
    # instantiation and every long-line row runs once each way
    from repro_torch.kernels import split
    for dtype, sizes in split.FACTORS.items():
        dt = str(dtype).removeprefix("torch.")
        rows = set()
        for i, n in enumerate(sorted(sizes)):
            q = sizes[n][1]
            if n not in split._TABLE[dtype]:
                if q in rows:
                    continue
                rows.add(q)
            b = 2 if n <= 1 << 20 else 1
            cases += [(b, n, i % 2 == 1, None, True, dt, ""),
                      (b, n, i % 2 == 0, 4, False, dt, "")]
    cases.append((2, 1 << 15, False, None, True, c64, "x"))
    # the mixed radix lengths: every one of both dtypes, both directions,
    # each epilogue (a pack_parts segment that is not a power of two where
    # 3 divides N); r = 7, 11 and 13 included
    from repro_torch.kernels import radix
    for dtype, sizes in radix.RADIX_SIZES.items():
        dt = str(dtype).removeprefix("torch.")
        for n in sizes:
            if radix.is_pow2(n):
                continue
            cases += [(37, n, False, None, False, dt, ""),
                      (5, n, True, 3 if n % 3 == 0 else 2, True, dt, "")]
    cases.append((37, 384, True, None, True, c64, "x"))
    # the wide kernel's ring: more than twice the tiles of the largest
    # grid (132 SMs), so every block wraps its ring of two tiles with the
    # inverse, the twiddle and pack_parts, and a ragged last tile where LT
    # > 1 (complex64 1000 and 2944 mixed, 4096 radix-2 codelets, complex128
    # 864 and 384)
    for dt, n in ((c64, 1000), (c64, 2944), (c64, 4096), (c128, 864),
                  (c128, 384)):
        plan = longline.long_plan(n, getattr(torch, dt))
        per_sm = min(16, 233472 // (plan.smem_bytes + 1024))
        cases.append((3 * per_sm * 132 * plan.lt + 1, n, True,
                      3 if n % 3 == 0 else 2, True, dt, ""))
    # the dense route: a length per family of both dtypes, both
    # directions, each epilogue, batches ragged against its tile
    cases += dense_cases()
    # the chirp route (``CHIRP_CASES``), then the split route's general
    # plans (a dense pass A of odd and even P, a radix pass A with dense
    # rows, a column tile of 4), segments of any length
    cases += [case[:6] + ("",) for case in CHIRP_CASES]
    for b, n, inv, parts, tw, dt in ((3, 29106, False, 3, True, c64),
                                     (2, 33075, True, 5, True, c64),
                                     (2, 30976, True, 11, False, c64),
                                     (2, 44100, False, 7, True, c64),
                                     (2, 14406, True, 7, True, c128),
                                     (1, 4084223, False, 11, False, c128)):
        cases.append((b, n, inv, parts, tw, dt, ""))
    return cases


#: (dtype name, N) per family of the dense route: odd 13-smooth N, the
#: even ones no codelets of the radix or long-line route hold, the spill
#: lengths, N with a prime factor past 13 that ``dense.GENERIC_COST``
#: keeps (one and two generic stages, 3264 = 3*17*64) and such primes,
#: and the 13-smooth
#: lengths past the old one-block limit that left the chirp route (to the
#: longest line of each dtype).
DENSE_FAMILIES = (("complex64", 9), ("complex64", 75), ("complex64", 4725),
                  ("complex128", 225), ("complex128", 1575),
                  ("complex64", 2730), ("complex64", 3430),
                  ("complex64", 4050), ("complex128", 990),
                  ("complex128", 1014), ("complex64", 208),
                  ("complex64", 504), ("complex128", 2),
                  ("complex128", 22), ("complex64", 816),
                  ("complex128", 578), ("complex64", 323),
                  ("complex64", 4199), ("complex64", 17),
                  ("complex128", 19), ("complex64", 3264),
                  ("complex64", 1), ("complex64", 5460),
                  ("complex64", 16896), ("complex64", 23040),
                  ("complex64", 28431), ("complex128", 2420),
                  ("complex128", 8448), ("complex128", 14196))


def dense_cases():
    """The dense route's cases: per ``DENSE_FAMILIES`` length both
    directions, the twiddle and ``pack_parts`` (a segment that is not a
    power of two where 3 divides N), and a batch ragged against the
    block's tile of lines."""
    import torch
    from repro_torch.kernels import dense
    cases = []
    for dt, n in DENSE_FAMILIES:
        lines = dense.dense_plan(n, getattr(torch, dt)).lines
        parts = 3 if n % 3 == 0 else 2 if n % 2 == 0 else None
        cases += [(2 * lines + 1, n, False, None, True, dt, ""),
                  (3, n, True, parts, False, dt, ""),
                  (1, n, False, parts, True, dt, ""),
                  (lines + 3, n, True, None, True, dt, "")]
    return [c for c in cases if c[0] * c[1] <= 1 << 22]


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
            (4, 32, 17, False, False, c128, "x")] + mixed_strided_cases()


def mixed_strided_cases():
    """The strided entry at every mixed radix length whose strided tile
    fits one block: a ragged last group of inner indices, both
    directions and the twiddle by turns."""
    from repro_torch.kernels import fft_matmul, radix
    out = []
    for dtype, sizes in radix.RADIX_SIZES.items():
        dt = str(dtype).removeprefix("torch.")
        for i, n in enumerate(sizes):
            if not radix.is_pow2(n) and fft_matmul.strided_supported(
                    n, dtype, True):
                out.append((3, n, 40, i % 2 == 1, i % 3 != 0, dt, ""))
    return out


def phase_kernel_vs_plain(device) -> dict:
    import torch
    from repro_torch.kernels import radix
    from repro_torch.kernels.fft_matmul import fft_fourstep, fft_fourstep_plain
    from repro_torch.kernels.radix import kernel_path
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
        if conj or (b and (kernel_path(n, dtype) in ("long", "split",
                                                    "chirp")
                           or not radix.is_pow2(n))):
            # the plain version honours the conjugate bit; so must the
            # kernel.  On the long, split and chirp paths the plain
            # version mirrors the kernel's index maps, and the mixed
            # radix lengths are new: torch.fft, with the epilogue, is the
            # independent yardstick.
            want = torch.fft.ifft(x) if inv else torch.fft.fft(x)
            want = want * twiddle if twiddle is not None else want
            if parts is not None:
                want = want.reshape(b, parts, n // parts)
            check(scaled_err(got, want) <= TOL[dt], f"case {i}: conj "
                  f"{conj!r}, N={n} {dt} against torch.fft: scaled error "
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
        if conj or not radix.is_pow2(n):
            want = (torch.fft.ifft if inv else torch.fft.fft)(x, dim=1)
            if twiddle is not None:
                want = want * twiddle[:, None]
            check(scaled_err(got, want) <= TOL[dt], f"strided case {i} "
                  f"(N={n}, {dt}): conj {conj!r} against torch.fft: scaled "
                  f"error {scaled_err(got, want):.3e}")
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
    from repro_torch.kernels import chirp
    for b, n, inv, parts, tw, dt, route in CHIRP_CASES:
        dtype = getattr(torch, dt)
        got = (kernel_path(n, dtype), chirp.chirp_plan(n, dtype).route)
        check(got == ("chirp", route), f"[kernel] {dt} {n}: route and M's "
              f"route {got}, expected ('chirp', {route!r})")
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
                                                 "dense": 0, "long": 0,
                                                 "split": 0, "chirp": 0},
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


def chunk_dims(spec, mesh) -> list:
    """The chunk dim each executed hop of ``spec`` uses (None: bulk)."""
    from repro_torch.core.pipeline import chunk_sites
    return [d if k > 1 else None for (d, _), k
            in zip(chunk_sites(spec, mesh.axis_sizes), spec.chunk_schedule)]


def phase_chunked(device, grid=GRID, iters: int = 5) -> dict:
    """Chunked hops on the main path: the C2C kernel plan at ``n_chunks=2``
    and ``(4, 2)`` against the bulk plan and torch.fft.fftn."""
    import torch
    from repro_torch import make_mesh, plan_fft
    from repro_torch.kernels import ops
    from repro_torch.kernels.fft_matmul import (fft_fourstep,
                                                reset_launch_counts)
    cuda = device.type == "cuda"
    mesh = make_mesh((1, 1), ("data", "model"),
                     device=None if cuda else device)
    bulk = plan_fft(mesh, grid, backend="kernel")
    x = randc(grid, torch.complex64, device, SEED + 5)
    yb = bulk.forward(x)
    xb = bulk.inverse(yb, sharded_in=True)
    ref = torch.fft.fftn(x)
    out = {"grid": list(grid), "cases": {}}
    if cuda:
        out["bulk_fwd_ms"] = time_ms(lambda: bulk.forward(x), iters)
        out["bulk_inv_ms"] = time_ms(lambda: bulk.inverse(yb,
                                                          sharded_in=True),
                                     iters)
    for n_chunks in (2, (4, 2)):
        plan = plan_fft(mesh, grid, backend="kernel", n_chunks=n_chunks)
        fwd_spec = plan.pipeline_spec()
        inv_spec = plan.pipeline_spec(inverse=True)
        case = {"fwd_schedule": list(fwd_spec.chunk_schedule),
                "inv_schedule": list(inv_spec.chunk_schedule),
                "fwd_chunk_dims": chunk_dims(fwd_spec, mesh),
                "inv_chunk_dims": chunk_dims(inv_spec, mesh)}
        results = {}
        for name in ("forward", "inverse"):
            reset_launch_counts()
            ops.copies["lines"] = 0
            if name == "forward":
                results[name] = plan.forward(x)
            else:
                results[name] = plan.inverse(yb, sharded_in=True)
            if cuda:
                torch.cuda.synchronize(device)
            case[f"{name}_launches"] = fft_fourstep.launches
            case[f"{name}_paths"] = dict(fft_fourstep.path_launches)
            case[f"{name}_layouts"] = dict(fft_fourstep.layout_launches)
            case[f"{name}_copies"] = ops.copies["lines"]
        stages = [1 + sum(s.chunk_schedule) for s in (fwd_spec, inv_spec)]
        if cuda:
            for name, want in zip(("forward", "inverse"), stages):
                check(case[f"{name}_launches"] == want
                      and case[f"{name}_paths"]["radix"] == want,
                      f"chunked {n_chunks} {name}: {case[f'{name}_launches']}"
                      f" launches ({case[f'{name}_paths']}), expected {want} "
                      f"on the radix path (one per chunk of each hop)")
        y, xi = results["forward"], results["inverse"]
        case["err_fwd_vs_bulk"] = scaled_err(y, yb)
        case["err_inv_vs_bulk"] = scaled_err(xi, xb)
        case["err_fwd_vs_fftn"] = scaled_err(y, ref)
        case["bitwise_fwd"] = bool(torch.equal(y, yb))
        case["bitwise_inv"] = bool(torch.equal(xi, xb))
        check(bool(torch.isfinite(torch.view_as_real(y)).all()),
              f"chunked {n_chunks}: non-finite forward output")
        check(case["err_fwd_vs_bulk"] <= TOL["complex64"]
              and case["err_inv_vs_bulk"] <= TOL["complex64"],
              f"chunked {n_chunks} vs bulk: scaled errors "
              f"{case['err_fwd_vs_bulk']:.3e} (forward), "
              f"{case['err_inv_vs_bulk']:.3e} (inverse) > {TOL['complex64']}")
        check(case["err_fwd_vs_fftn"] <= PATH_TOL,
              f"chunked {n_chunks} vs torch.fft.fftn: scaled error "
              f"{case['err_fwd_vs_fftn']:.3e} > {PATH_TOL}")
        del results, y, xi
        if cuda:
            case["fwd_ms"] = time_ms(lambda: plan.forward(x), iters)
            case["inv_ms"] = time_ms(lambda: plan.inverse(yb,
                                                          sharded_in=True),
                                     iters)
        key = ",".join(map(str, n_chunks)) if isinstance(n_chunks, tuple) \
            else str(n_chunks)
        out["cases"][key] = case
        print(f"[chunked] n_chunks={key}: schedule forward "
              f"{case['fwd_schedule']} (chunk dims {case['fwd_chunk_dims']}),"
              f" inverse {case['inv_schedule']} (chunk dims "
              f"{case['inv_chunk_dims']}); launches {case['forward_launches']}"
              f" forward / {case['inverse_launches']} inverse, paths "
              f"{case['forward_paths']} / {case['inverse_paths']}; line "
              f"copies {case['forward_copies']} / {case['inverse_copies']}; "
              f"vs bulk {case['err_fwd_vs_bulk']:.3e} / "
              f"{case['err_inv_vs_bulk']:.3e} (bound {TOL['complex64']}, "
              f"bitwise {case['bitwise_fwd']} / {case['bitwise_inv']}), "
              f"vs fftn {case['err_fwd_vs_fftn']:.3e} (bound {PATH_TOL})"
              + (f"; ms {case['fwd_ms']:.4f} / {case['inv_ms']:.4f} beside "
                 f"bulk {out['bulk_fwd_ms']:.4f} / {out['bulk_inv_ms']:.4f}"
                 if cuda else ""))
    return out


def phase_calibrate(device, cache, timer=time.perf_counter) -> dict:
    """``perfmodel.calibrate`` on the card; the profile is stored in the
    wisdom ``cache`` the tune phase uses."""
    from repro_torch import make_mesh
    from repro_torch.core.perfmodel import calibrate
    from repro_torch.kernels.fft_matmul import (fft_fourstep,
                                                reset_launch_counts)
    mesh = make_mesh((1, 1), ("data", "model"),
                     device=None if device.type == "cuda" else device)
    reset_launch_counts()
    t0 = timer()
    prof = calibrate(mesh)
    seconds = timer() - t0
    launches = fft_fourstep.launches
    check(prof.calibrated and not prof.net_calibrated,
          f"calibration flags: calibrated={prof.calibrated}, "
          f"net_calibrated={prof.net_calibrated} (one card: expected True, "
          f"False)")
    if device.type == "cuda":
        check(launches > 0, "calibration launched no kernel")
    cache.put_machine(prof.platform, prof.to_json())
    flops = dict(prof.backend_flops)
    print(f"[calibrate] {prof.platform}: backend_flops " + ", ".join(
        f"{k}={v:.4e}" for k, v in flops.items())
        + f" FLOP/s; mem_bw {prof.mem_bw:.4e} B/s; kind_scale "
        f"{dict(prof.kind_scale)}; net_calibrated {prof.net_calibrated}; "
        f"{seconds:.2f} s; {launches} kernel launches")
    return {"profile": prof.to_json(), "seconds": seconds,
            "launches": launches}


def phase_tune(device, cache, poisson: dict, grid=GRID,
               iters: int = 5) -> dict:
    """The tuner on the card: heuristic and auto for C2C 512^3, then the
    PPB solve tuned jointly, each run's kernel launches counted."""
    import torch
    from repro_torch import PoissonSolver, make_mesh, plan_fft
    from repro_torch.core import tuner
    from repro_torch.core.plan import TuningCache
    from repro_torch.kernels.fft_matmul import (fft_fourstep,
                                                reset_launch_counts)
    cuda = device.type == "cuda"
    mesh = make_mesh((1, 1), ("data", "model"),
                     device=None if cuda else device)
    x = randc(grid, torch.complex64, device, SEED + 6)
    measured = []
    measure = tuner.measure_candidate

    def recording(cand, *a, **kw):
        measured.append(cand)
        return measure(cand, *a, **kw)

    tuner.measure_candidate = recording
    out = {}
    try:
        reset_launch_counts()
        heur = plan_fft(mesh, grid, tuning="heuristic", tune_cache=cache)
        check(not measured, "heuristic tuning measured a candidate")
        out["heuristic"] = {
            "winner": heur.tuned.describe(),
            "predicted_ms": heur.tuned.predicted_s * 1e3,
            "measured_ms": time_ms(lambda: heur.forward(x), iters)
            if cuda else None}
        print(f"[tune] heuristic C2C {tuple(grid)}: {heur.tuned.describe()}; "
              f"measured {out['heuristic']['measured_ms']} ms")

        reset_launch_counts()
        auto = plan_fft(mesh, grid, tuning="auto", tune_cache=cache)
        rec = auto.tuned
        launches = fft_fourstep.launches
        n_measured = len(measured)
        kernel_measured = any(c.backend == "kernel" for c in measured)
        check(rec.source == "measured" and rec.measured_s <= rec.baseline_s,
              f"auto winner {rec.describe()} is slower than the default")
        if cuda:
            check((launches > 0) == kernel_measured,
                  f"auto tuning: {launches} kernel launches, kernel "
                  f"candidates measured: {kernel_measured}")
        err = scaled_err(auto.forward(x), torch.fft.fftn(x))
        check(err <= PATH_TOL, f"auto plan vs torch.fft.fftn: scaled error "
              f"{err:.3e} > {PATH_TOL}")
        measured.clear()
        again = plan_fft(mesh, grid, tuning="auto",
                         tune_cache=TuningCache(cache.path))
        check(not measured and again.tuned == rec,
              f"second plan on the wisdom file measured {len(measured)} "
              f"candidates")
        out["auto"] = {"winner": rec.describe(), "to_json": rec.to_json(),
                       "measured_candidates": n_measured,
                       "kernel_measured": kernel_measured,
                       "launches": launches, "err_vs_fftn": err,
                       "second_plan_measurements": len(measured)}
        print(f"[tune] auto C2C {tuple(grid)}: {rec.describe()}; "
              f"{n_measured} candidates measured (kernel among them: "
              f"{kernel_measured}), {launches} kernel launches; vs fftn "
              f"{err:.3e} (bound {PATH_TOL}); a second plan read the wisdom "
              f"file with {len(measured)} measurements")

        measured.clear()
        reset_launch_counts()
        solver = PoissonSolver(mesh, grid, topology=PPB, tuning="auto",
                               tune_cache=cache)
        prec = solver.plan.tuned
        launches = fft_fourstep.launches
        kernel_measured = any(c.backend == "kernel" for c in measured)
        if cuda:
            check((launches > 0) == kernel_measured,
                  f"PPB auto tuning: {launches} kernel launches, kernel "
                  f"candidates measured: {kernel_measured}")
        gen = torch.Generator(device=device).manual_seed(SEED + 3)
        rhs = torch.randn(grid, dtype=torch.float32, device=device,
                          generator=gen)
        rhs -= rhs.mean()
        phi = solver(rhs)
        solver64 = PoissonSolver(mesh, grid, topology=PPB,
                                 dtype=torch.float64, backend="cufft")
        err = scaled_err(phi.double(), solver64(rhs.double()))
        del solver64
        check(err <= PATH_TOL, f"tuned PPB solve vs the float64 solve: "
              f"scaled error {err:.3e} > {PATH_TOL}")
        out["poisson_auto"] = {
            "winner": prec.describe(), "to_json": prec.to_json(),
            "measured_candidates": len(measured),
            "kernel_measured": kernel_measured, "launches": launches,
            "err_solve": err,
            "solve_ms": time_ms(lambda: solver(rhs), iters) if cuda else None,
            "phase5_solve_kernel_ms": poisson.get("solve_kernel_ms"),
            "phase5_solve_cufft_ms": poisson.get("solve_cufft_ms")}
        p = out["poisson_auto"]
        print(f"[tune] PoissonSolver(tuning='auto') PPB {tuple(grid)}: "
              f"{prec.describe()}; {p['measured_candidates']} candidates "
              f"measured (kernel among them: {kernel_measured}), {launches} "
              f"kernel launches; solve vs float64 {err:.3e} (bound "
              f"{PATH_TOL}); {p['solve_ms']} ms per solve beside phase 5's "
              f"kernel {p['phase5_solve_kernel_ms']} ms and cufft "
              f"{p['phase5_solve_cufft_ms']} ms")
    finally:
        tuner.measure_candidate = measure
    return out


def path_counts() -> dict:
    """The launch counters a path is read by: B1 on lines, B4 strided,
    both by path, and the line copies."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fft_matmul import fft_fourstep
    return {"launches": fft_fourstep.launches,
            "lines": fft_fourstep.layout_launches["lines"],
            "strided": fft_fourstep.layout_launches["strided"],
            **{p: fft_fourstep.path_launches[p] for p in KERNEL_PATHS},
            "split_calls": fft_fourstep.split_calls,
            "fold_dense": fft_fourstep.fold_launches["dense"],
            "fold_long": fft_fourstep.fold_launches["long"],
            "chirp_calls": fft_fourstep.chirp_calls,
            "copies": ops.copies["lines"]}


def expected_counts(n: int, calls: int, dtype=None) -> dict:
    """``path_counts()`` after ``calls`` transforms of contiguous lines of
    length ``n``: one launch each on the path ``radix.kernel_path``
    names, or on the split route one split call of two launches on
    "split" (pass A strided, pass B on lines: on radix rows, or on the
    long-line or dense route's stages with pass C folded in, counted on
    "fold_long" or "fold_dense" too), or, on a nested plan whose rows
    take another route, pass A, the rows' own launches and pass C; or on
    the chirp route one chirp call of two transforms of M (one launch
    each on the dense or the long-line route, a split plan's launches),
    all counted on "chirp"; nothing on any other path, no line copy."""
    import torch
    from repro_torch.kernels import chirp, radix, split
    dtype = dtype or torch.complex64
    path = radix.kernel_path(n, dtype)
    want = {p: 0 for p in KERNEL_PATHS}
    want.update(copies=0, split_calls=0, chirp_calls=0)
    if path == "chirp":
        cplan = chirp.chirp_plan(n, dtype)
        if cplan.route in ("dense", "long"):
            launches, lines, strided, folds = 2, 2, 0, {}
        else:
            launches, lines, strided, folds = _any_plan_counts(cplan.split,
                                                               dtype)
            launches, lines, strided = 2 * launches, 2 * lines, 2 * strided
            folds = {k: 2 * v for k, v in folds.items()}
        want.update(launches=launches * calls, lines=lines * calls,
                    strided=strided * calls, chirp=launches * calls,
                    chirp_calls=calls)
    elif path == "split":
        launches, lines, strided, folds = _any_plan_counts(
            split.split_plan(n, dtype), dtype)
        want.update(launches=launches * calls, lines=lines * calls,
                    strided=strided * calls, split=launches * calls,
                    split_calls=calls)
    else:
        want.update(launches=calls, lines=calls, strided=0)
        want[path] = calls
        folds = {}
    want.update(fold_dense=folds.get("dense", 0) * calls,
                fold_long=folds.get("long", 0) * calls)
    return want


def _any_plan_counts(plan, dtype) -> tuple:
    """(launches, on lines, strided, {folded kernel: launches}) of one
    call of a split plan: pass A (strided) and pass B (lines; on the
    long-line or dense route's stages with pass C folded in), or where a
    plan's rows keep pass C (a nested plan's rows on another route, dense
    rows too long for the folded kernel), pass A, the rows' launches and
    pass C (lines)."""
    from repro_torch.kernels import split
    layout = split.fold_layout(plan, dtype)
    if plan.row_path == "radix" or layout is not None:
        return 2, 1, 1, ({layout.rows: 1} if layout is not None else {})
    rows = expected_counts(plan.q, 1, dtype)
    return (rows["launches"] + 2, rows["lines"] + 1, rows["strided"] + 1,
            {k: rows["fold_" + k] for k in ("dense", "long")})


def counts_match(counts: dict, want: dict) -> bool:
    return all(counts[k] == v for k, v in want.items())


def reset_counts() -> None:
    from repro_torch.kernels import ops
    from repro_torch.kernels.fft_matmul import reset_launch_counts
    reset_launch_counts()
    ops.copies["lines"] = 0


def profile_run(fn, device, timer=time.perf_counter, top: int = 0) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the host window, the
    card's kernel time (kernel events only: an operator's device time
    repeats its kernels') and busy share, the kernels launched, the
    ``cudaMalloc`` calls the caching allocator made, and the ``top``
    kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = timer()
        fn()
        torch.cuda.synchronize(device)
        window = (timer() - t0) * 1e3
    avgs = prof.key_averages()

    def device_us(a):
        return getattr(a, "self_device_time_total",
                       getattr(a, "self_cuda_time_total", 0.0))

    kernels = sorted((a for a in avgs if str(a.device_type).endswith("CUDA")
                      and device_us(a) > 0), key=device_us, reverse=True)
    busy = sum(device_us(a) for a in kernels) * 1e-3
    out = {"window_ms": window, "kernel_ms": busy,
           "busy_share": busy / window,
           "kernels": sum(a.count for a in kernels),
           "cudaMalloc": sum(a.count for a in avgs if a.key == "cudaMalloc")}
    if top:
        out["top"] = [{"name": a.key[:80], "count": a.count,
                       "ms": device_us(a) * 1e-3} for a in kernels[:top]]
    return out


def phase_segments(device, grid=GRID, iters: int = 5) -> dict:
    """``[segments]``: the 512^3 C2C kernel plan's chained stage segments
    against ``plan.forward``/``plan.inverse``, bitwise, with the plan's own
    launch counts per direction."""
    import torch
    from repro_torch import make_mesh, plan_fft
    cuda = device.type == "cuda"
    mesh = make_mesh((1, 1), ("data", "model"),
                     device=None if cuda else device)
    plan = plan_fft(mesh, grid, backend="kernel")
    x = randc(grid, torch.complex64, device, SEED + 11)
    y = plan.forward(x)
    z = plan.inverse(y, sharded_in=True)

    def chain(inverse: bool):
        v = plan.prepare_input(y if inverse else x, inverse=inverse,
                               sharded_in=inverse)
        for seg in plan.segments(inverse=inverse):
            v = seg(v)
        return v

    out = {"grid": list(grid), "n_segments": len(plan.segments())}
    for name, inverse, fused in (("forward", False, y), ("inverse", True, z)):
        reset_counts()
        v = chain(inverse)
        if cuda:
            torch.cuda.synchronize(device)
        counts = path_counts()
        out[name] = {"bitwise": bool(torch.equal(v, fused)), **counts}
        check(out[name]["bitwise"], f"[segments] chained {name} segments "
              f"differ from the fused plan: max |d| "
              f"{float((v - fused).abs().max()):.3e}")
        check(counts["copies"] == 0, f"[segments] {name}: "
              f"{counts['copies']} line copies, expected 0")
        if cuda:
            check(counts["launches"] == 3 and counts["radix"] == 3
                  and counts["strided"] == 2,
                  f"[segments] {name}: {counts}, expected 3 launches, all "
                  f"radix, 2 strided (the plan's own counts)")
        del v
    if cuda:
        out["chained_fwd_ms"] = time_ms(lambda: chain(False), iters)
        out["fused_fwd_ms"] = time_ms(lambda: plan.forward(x), iters)
    print(f"[segments] {out['n_segments']} segments per direction; chained "
          f"forward and inverse bitwise equal to the fused plan; launches "
          f"forward {out['forward']}, inverse {out['inverse']}"
          + (f"; chained forward {out['chained_fwd_ms']:.4f} ms beside the "
             f"fused {out['fused_fwd_ms']:.4f} ms" if cuda else ""))
    return out


def executor_queue(device, grid=GRID, batch2=(16, 1024, 1024)):
    """The mixed queue of ``[executor]`` and ``[analysis]``: three batched
    2-D entries, one 3-D forward and the inverse of that forward, all on
    ``backend="kernel"``.  Returns the plans, the 2-D operands, the
    entries (``execute_many`` form) and a solo call per entry."""
    import torch
    from repro_torch import make_mesh, plan_fft
    mesh = make_mesh((1, 1), ("data", "model"),
                     device=None if device.type == "cuda" else device)
    p2d = plan_fft(mesh, batch2[1:], batch_shape=batch2[:1],
                   backend="kernel")
    p3d = plan_fft(mesh, grid, backend="kernel")
    xs = [randc(batch2, torch.complex64, device, SEED + 20 + i)
          for i in range(3)]
    x3 = randc(grid, torch.complex64, device, SEED + 23)
    y3 = p3d.forward(x3)
    entries = [(p2d, xs[0]), (p2d, xs[1]), (p2d, xs[2]), (p3d, x3),
               (p3d, y3, {"inverse": True})]

    def solo_call(i):
        plan, v = entries[i][:2]
        if len(entries[i]) == 3:
            return plan.inverse(v)
        return plan.forward(v)

    return p2d, p3d, xs, entries, solo_call


def submit_queue(ex, entries) -> None:
    for e in entries:
        ex.submit(e[0], e[1], **(e[2] if len(e) == 3 else {}))


def check_queue_counts(counts, phase: str, cuda: bool) -> None:
    """The mixed queue's launches: 2 per 2-D entry and 3 per 512^3
    direction, all radix, 7 strided, no line copy."""
    want = 3 * 2 + 2 * 3
    check(counts["copies"] == 0, f"[{phase}] {counts['copies']} line "
          f"copies, expected 0")
    if cuda:
        check(counts["launches"] == want and counts["radix"] == want
              and counts["strided"] == 3 * 1 + 2 * 2,
              f"[{phase}] launches {counts}, expected {want}, all radix, "
              f"7 strided")


def phase_executor(device, grid=GRID, batch2=(16, 1024, 1024),
                   iters: int = 5, timer=time.perf_counter) -> dict:
    """``[executor]``: the mixed queue (:func:`executor_queue`) through
    the plan-stream executor in every dispatch mode, bitwise against the
    solo runs; solo sum, interleaved time and overlap against
    ``report()["predicted"]``, per-segment times, peak memory, donation."""
    import torch
    from repro_torch.core.executor import PlanStreamExecutor, execute_many
    from repro_torch.distributed.fault import StepWatchdog
    cuda = device.type == "cuda"
    p2d, _, xs, entries, solo_call = executor_queue(device, grid, batch2)
    solo = [solo_call(i) for i in range(len(entries))]
    out = {"entries": [f"2d{tuple(batch2)}"] * 3 + ["3d fwd", "3d inv"],
           "modes": {}}
    # the counted run of the path
    reset_counts()
    outs = execute_many(entries)
    if cuda:
        torch.cuda.synchronize(device)
    out["counts"] = counts = path_counts()
    check_queue_counts(counts, "executor", cuda)
    del outs
    for mode in ("async", "pool", "timed"):
        kw = {"watchdog": StepWatchdog()} if mode == "timed" else {}
        ex = PlanStreamExecutor(mode=mode, **kw)
        submit_queue(ex, entries)
        got = ex.run()
        if cuda:
            torch.cuda.synchronize(device)
        same = [bool(torch.equal(g, w)) for g, w in zip(got, solo)]
        check(all(same), f"[executor] mode {mode}: outputs bitwise equal "
              f"to solo {same}")
        rec = {"bitwise": same,
               "predicted_overlap": ex.report()["predicted"][
                   "overlap_efficiency"],
               "order": [s.tag for s in ex.last_schedule]}
        if mode == "timed":
            rec["segment_ms"] = {k: v * 1e3 for k, v in
                                 ex.report()["segment_times"].items()}
            rec["stragglers"] = ex.stragglers
        out["modes"][mode] = rec
        del got
    # donation: a private plan's operand is emptied, the result unchanged
    xd = xs[0].clone()
    got = execute_many([(p2d, xd, {"donate": True})])[0]
    out["donated_emptied"] = xd.numel() == 0
    check(out["donated_emptied"] and bool(torch.equal(got, solo[0])),
          "[executor] a donated operand was not emptied, or its result "
          "changed")
    del got
    boundary = sum(2 * max(math.prod(s.local_shape) * s.dtype.itemsize
                           for s in e[0].segment_boundary_structs(
                               inverse=len(e) == 3))
                   for e in entries)
    out["two_boundary_buffers_bytes"] = boundary
    if cuda:
        ms = [time_ms(lambda i=i: solo_call(i), iters)
              for i in range(len(entries))]
        out["solo_ms"] = ms
        out["solo_sum_ms"] = sum(ms)
        for mode in ("async", "pool"):
            out[f"interleaved_{mode}_ms"] = time_ms(
                lambda m=mode: execute_many(entries, mode=m), iters)
        out["measured_overlap"] = out["interleaved_async_ms"] / sum(ms)
        # Host side of one interleaved run: pricing and placement alone,
        # and the whole call without waiting for the card (enqueue time).
        # An enqueue time near the interleaved time means the run is
        # bound by the host, not by the card.
        ex = PlanStreamExecutor()
        submit_queue(ex, entries)
        t0 = timer()
        for _ in range(iters):
            ex._plan_schedule()
        out["plan_host_ms"] = (timer() - t0) / iters * 1e3
        ex._queue.clear()
        torch.cuda.synchronize(device)
        t0 = timer()
        for _ in range(iters):
            execute_many(entries)
        out["enqueue_host_ms"] = (timer() - t0) / iters * 1e3
        torch.cuda.synchronize(device)
        out["profile"] = profile_run(lambda: execute_many(entries), device)
        out["profile_solo"] = profile_run(
            lambda: [solo_call(i) for i in range(len(entries))], device)
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        outs = execute_many(entries)
        torch.cuda.synchronize(device)
        out["peak_extra_bytes"] = torch.cuda.max_memory_allocated(device) \
            - base
        del outs
    print(f"[executor] {len(entries)} entries, modes async/pool/timed "
          f"bitwise equal to solo; launches {counts}; predicted overlap "
          f"{out['modes']['async']['predicted_overlap']:.4f}"
          + (f"; solo sum {out['solo_sum_ms']:.4f} ms, interleaved async "
             f"{out['interleaved_async_ms']:.4f} ms / pool "
             f"{out['interleaved_pool_ms']:.4f} ms, measured overlap "
             f"{out['measured_overlap']:.4f}; host per interleaved run: "
             f"pricing and placement {out['plan_host_ms']:.4f} ms, enqueue "
             f"{out['enqueue_host_ms']:.4f} ms; one run under "
             f"torch.profiler: {out['profile']} (solo calls: "
             f"{out['profile_solo']}); peak extra memory "
             f"{out['peak_extra_bytes'] / 2**30:.3f} GiB against two "
             f"boundary buffers per entry {boundary / 2**30:.3f} GiB"
             if cuda else ""))
    if cuda:
        print("[executor] timed segment ms: " + ", ".join(
            f"{k}={v:.4f}" for k, v in
            out["modes"]["timed"]["segment_ms"].items()))
    return out


def phase_analysis(device, grid=GRID, batch2=(16, 1024, 1024),
                   iters: int = 5, timer=time.perf_counter) -> dict:
    """``[analysis]``: the ``[executor]`` queue under the static verifier
    and the sanitizer (``repro_torch.analysis``).

    * every dispatch mode with ``verify="strict", sanitize=True``: no
      verify error and 0 SAN001 (async and pool: no finding at all; the
      timed mode's SCHED004 warnings are the verifier's prediction of the
      watchdog's stragglers, printed beside what it flagged), outputs
      bitwise equal to the solo runs, and the same 12 launches as
      ``[executor]`` (a verifier that launched, or changed the launches,
      shows here);
    * pool mode with ``serialize_dispatch=False``: ``verify_schedule()``
      reports SCHED001 and ``run()`` raises ``PlanVerificationError``
      with no launch at all and the queue intact;
    * a donated entry: its operand emptied, and the sanitizer's donation
      table agrees;
    * ``plan.verify()`` on the 512^3 kernel plan: clean, and
      ``describe()`` says so;
    * the host ms of ``verify_schedule()`` (pricing and placement plus
      the check), of the check ``run()`` makes (``_check_schedule`` on a
      planned order), of ``sanitize_json()``, and of the enqueue with
      ``verify="strict"``, with ``sanitize=True`` and with both, beside
      the plain enqueue, in turns;
    * the peak memory of a sanitized run beside a plain one, both with
      ``donate_intermediates=False`` (every boundary buffer is then
      freed by its last reference): the trace holds no buffer, so the
      peaks must agree.
    """
    import torch
    from repro_torch.analysis import PlanVerificationError
    from repro_torch.core.executor import PlanStreamExecutor, execute_many
    from repro_torch.core.pipeline import released
    from repro_torch.distributed.fault import StepWatchdog
    cuda = device.type == "cuda"
    p2d, p3d, xs, entries, solo_call = executor_queue(device, grid, batch2)
    solo = [solo_call(i) for i in range(len(entries))]
    out = {"modes": {}}
    for mode in ("async", "pool", "timed"):
        kw = {"watchdog": StepWatchdog()} if mode == "timed" else {}
        sink = []
        ex = PlanStreamExecutor(mode=mode, verify="strict", sanitize=True,
                                verify_sink=sink.append, **kw)
        submit_queue(ex, entries)
        reset_counts()
        got = ex.run()
        if cuda:
            torch.cuda.synchronize(device)
        counts = path_counts()
        same = [bool(torch.equal(g, w)) for g, w in zip(got, solo)]
        del got
        verify, san = ex.last_verify_report(), ex.last_sanitize_report()
        trace = ex.last_trace()
        rec = {"bitwise": same, "counts": counts,
               "verify": sorted(d.code for d in verify),
               "verify_errors": len(verify.errors), "san001": len(san),
               "sink": [r.codes() for r in sink],
               "turns_in_order": [e.turn for e in trace.events]
               == list(range(len(trace.events))),
               "order_is_plan": trace.launch_order()
               == [(s.entry, s.index) for s in ex.last_schedule]}
        check(all(same), f"[analysis] mode {mode}: outputs bitwise equal "
              f"to solo {same}")
        check_queue_counts(counts, f"analysis {mode}", cuda)
        check(rec["verify_errors"] == 0 and rec["san001"] == 0
              and ex.sanitize_json()["diff"]["san001"] == 0,
              f"[analysis] mode {mode}: verify {verify.render()} sanitize "
              f"{san.render()}")
        check(rec["turns_in_order"] and rec["order_is_plan"],
              f"[analysis] mode {mode}: the trace is not the planned order")
        if mode == "timed":
            check(set(rec["verify"]) <= {"SCHED003", "SCHED004"},
                  f"[analysis] timed: {verify.render()}")
            rec["predicted_stragglers"] = sorted(
                d.plan_key for d in verify.by_code("SCHED004"))
            rec["flagged_stragglers"] = sorted(t for t, _ in ex.stragglers)
        else:
            check(rec["verify"] == [] and sink == [],
                  f"[analysis] mode {mode}: findings {verify.render()}")
        out["modes"][mode] = rec
    out["counts"] = out["modes"]["async"]["counts"]

    # Pool dispatch without turns: flagged and refused before any launch.
    ex = PlanStreamExecutor(mode="pool", serialize_dispatch=False,
                            verify="strict")
    submit_queue(ex, entries)
    reset_counts()
    static = ex.verify_schedule().codes()
    try:
        ex.run()
        refused = []
    except PlanVerificationError as err:
        refused = err.report.codes()
    if cuda:
        torch.cuda.synchronize(device)
    moved = {k: v for k, v in path_counts().items() if v}
    out["unserialized"] = {"static": static, "refused": refused,
                           "counters_moved": moved, "queued": len(ex)}
    check("SCHED001" in static and "SCHED001" in refused and not moved
          and len(ex) == len(entries),
          f"[analysis] unserialized pool: {out['unserialized']}")
    ex._queue.clear()

    # A donated entry: emptied, and the donation table agrees.
    xd = xs[0].clone()
    ex = PlanStreamExecutor(verify="strict", sanitize=True)
    ex.submit(p2d, xd, donate=True)
    got = ex.run()[0]
    fates = {b.tag: [b.expect_deleted, b.deleted]
             for b in ex.last_trace().buffers}
    out["donation"] = {"emptied": released(xd), "fates": fates,
                       "san001": len(ex.last_sanitize_report()),
                       "bitwise": bool(torch.equal(got, solo[0]))}
    check(out["donation"]["emptied"] and fates["entry0/seg0"] == [True, True]
          and out["donation"]["san001"] == 0 and out["donation"]["bitwise"],
          f"[analysis] donation: {out['donation']}")
    del got

    # The main plan's contracts.
    report = p3d.verify()
    verified = p3d.describe().splitlines()[-1].strip()
    out["plan_verify"] = {"findings": report.codes(), "describe": verified}
    check(len(report) == 0 and verified == "verified: contracts clean",
          f"[analysis] plan.verify(): {report.render()} / {verified}")

    if cuda:
        ex = PlanStreamExecutor(verify="strict", sanitize=True)
        submit_queue(ex, entries)
        t0 = timer()
        for _ in range(iters):
            ex.verify_schedule()
        out["verify_schedule_host_ms"] = (timer() - t0) / iters * 1e3
        order = ex._plan_schedule()
        t0 = timer()
        for _ in range(iters):
            ex._check_schedule(order, ex._queue)
        out["check_host_ms"] = (timer() - t0) / iters * 1e3
        ex.run()
        t0 = timer()
        for _ in range(iters):
            json.dumps(ex.sanitize_json())
        out["sanitize_json_host_ms"] = (timer() - t0) / iters * 1e3
        # The plain and the analysed enqueues in turns (each order, then
        # its reverse, twice): host time drifts between rounds.
        kinds = (("enqueue_host_ms", {}),
                 ("enqueue_verify_host_ms", {"verify": "strict"}),
                 ("enqueue_sanitize_host_ms", {"sanitize": True}),
                 ("enqueue_verified_host_ms",
                  {"verify": "strict", "sanitize": True}))
        rounds = {name: [] for name, _ in kinds}
        for name, kw in (kinds + kinds[::-1]) * 2:
            torch.cuda.synchronize(device)
            t0 = timer()
            for _ in range(iters):
                execute_many(entries, **kw)
            rounds[name].append((timer() - t0) / iters * 1e3)
        torch.cuda.synchronize(device)
        for name, ms in rounds.items():
            out[name] = statistics.median(ms)
            out[f"{name}_rounds"] = ms
        peaks = {}
        for name, kw in (("plain", {}),
                         ("sanitized", {"verify": "strict",
                                        "sanitize": True})):
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            outs = execute_many(entries, donate_intermediates=False, **kw)
            torch.cuda.synchronize(device)
            peaks[name] = torch.cuda.max_memory_allocated(device) - base
            del outs
        out["peak_extra_bytes"] = peaks
        check(peaks["sanitized"] <= peaks["plain"] + 2**21,
              f"[analysis] a sanitized run's peak memory {peaks} exceeds "
              f"the plain run's: the trace holds buffers")
    print(f"[analysis] modes async/pool/timed under verify='strict' and "
          f"sanitize=True: bitwise equal to solo, 0 verify errors, 0 "
          f"SAN001, launches {out['counts']} (as [executor]); timed "
          f"findings {out['modes']['timed']['verify']}, predicted "
          f"stragglers {out['modes']['timed']['predicted_stragglers']}, "
          f"flagged {out['modes']['timed']['flagged_stragglers']}; "
          f"unserialized pool: {out['unserialized']}; donation "
          f"{out['donation']}; plan.verify() {out['plan_verify']}")
    if cuda:
        print(f"[analysis] host ms: verify_schedule() (pricing and "
              f"placement plus the check) "
              f"{out['verify_schedule_host_ms']:.4f}, the check inside "
              f"run() {out['check_host_ms']:.4f}, sanitize_json() "
              f"{out['sanitize_json_host_ms']:.4f}; enqueue, median of 4 "
              f"rounds in turns: plain {out['enqueue_host_ms']:.4f} "
              f"{out['enqueue_host_ms_rounds']}, verify='strict' "
              f"{out['enqueue_verify_host_ms']:.4f} "
              f"{out['enqueue_verify_host_ms_rounds']}, sanitize=True "
              f"{out['enqueue_sanitize_host_ms']:.4f} "
              f"{out['enqueue_sanitize_host_ms_rounds']}, both "
              f"{out['enqueue_verified_host_ms']:.4f} "
              f"{out['enqueue_verified_host_ms_rounds']}")
        print(f"[analysis] peak extra memory with donate_intermediates="
              f"False: plain {peaks['plain'] / 2**30:.3f} GiB, sanitized "
              f"{peaks['sanitized'] / 2**30:.3f} GiB")
    return out


def phase_serve(device, requests: int = 48, round_size: int = 16,
                primary=(1024, 1024), secondary=(1024, 2048),
                odd=((1000, 1000), (960, 1024), (1024, 1000)),
                edges=(256, 512, 1024, 2048), max_batch: int = 8,
                windows: int = 3) -> dict:
    """``[serve]``: ``launch/serve_fft.py`` on one card (no loss on a
    1-rank mesh) at card-size grids, the tuner pinned to the kernel, a
    wisdom file in a temporary directory; its own checks (every result
    within 1e-4 of ``torch.fft.fftn``, hit rate >= 0.8, a warmed first
    drain that builds no plan and no kernel) fail the run.  The service
    lifetime runs ``windows`` times, each with a fresh wisdom file, so the
    latencies and rates come with their spread.  The launch counts are
    the traffic drains' own (``serve_fft``'s ``traffic_launches``, not
    the tune and warm-up before them): every routed batch of a 2-D grid
    is 2 launches of the plain four-step variant, one on lines and one
    strided, the strided one radix and the one on lines radix or, where
    the bucket grid's last axis is a wide line (2048 in (1024, 2048);
    ``traffic_batches_by_grid`` counts the batches of each grid), the long
    route's wide kernel; no line copy.  One more lifetime runs the service
    with ``verify="strict"``: its ``verify_warnings`` must stay empty and
    its launch counts exact."""
    import torch
    from repro_torch.kernels import longline
    from repro_torch.launch.serve_fft import serve_fft
    cuda = device.type == "cuda"
    ndim = len(primary)
    check(all(len(g) == ndim for g in (secondary, *odd)),
          "[serve] the served grids differ in rank")
    runs = []
    for w in range(windows + 1):
        verify = "strict" if w == windows else "off"
        with tempfile.TemporaryDirectory() as tmp:
            snap = serve_fft(
                requests=requests, round_size=round_size, lose=0,
                seed=SEED + w, device=None if cuda else device,
                wisdom=os.path.join(tmp, "tuning.json"),
                json_path=os.path.join(ROOT, "chiprun_out",
                                       f"serve_fft_metrics_{w}.json"),
                check=True, primary=primary, secondary=secondary, odd=odd,
                bucket_edges=edges, max_batch=max_batch,
                backends=("kernel",), verify=verify, verbose=False)
        if cuda:
            torch.cuda.synchronize(device)
        drv = snap["driver"]
        check(drv["max_rel_err"] <= 1e-4
              and snap["plan_cache"]["hit_rate"] >= 0.8
              and drv["first_drain"] == {"plan_builds": 0,
                                         "kernel_loads": 0},
              f"[serve] window {w}: {drv}")
        got, nb = drv["traffic_launches"], drv["traffic_batches"]
        by_grid = drv["traffic_batches_by_grid"]
        if cuda:
            # the batches whose bucket grid's last axis (the one on lines)
            # is a wide line run it on the wide kernel
            wide = sum(k for g, k in by_grid.items() if int(
                g.split("x")[-1]) in longline.WIDE[torch.complex64])
            want = {"launches": ndim * nb, "fourstep": ndim * nb,
                    "pack": 0, "twiddle": 0, "radix": ndim * nb - wide,
                    "dense": 0, "long": wide, "split": 0, "split_calls": 0,
                    "fold_dense": 0, "fold_long": 0,
                    "chirp": 0, "chirp_calls": 0, "aligned_copies": 0,
                    "lines": nb, "strided": (ndim - 1) * nb,
                    "copies": 0}
            check(nb > 0 and sum(by_grid.values()) == nb and got == want,
                  f"[serve] window {w}: traffic launches {got} for {nb} "
                  f"routed batches {by_grid}, expected {want}")
        check(snap["verify_warnings"] == {},
              f"[serve] window {w} (verify={verify!r}): verify_warnings "
              f"{snap['verify_warnings']}")
        lat = snap["latency"]
        runs.append({"verify": verify,
                     "verify_warnings": snap["verify_warnings"],
                     "counts": got, "batches": nb,
                     "p50_ms": lat["p50_s"] * 1e3,
                     "p99_ms": lat["p99_s"] * 1e3,
                     "drain_rps": drv["drain_rps"],
                     "loop_rps": drv["loop_rps"], "rps": drv["rps"],
                     "hit_rate": snap["plan_cache"]["hit_rate"],
                     "first_drain": drv["first_drain"],
                     "max_rel_err": drv["max_rel_err"],
                     "families": drv["families"], "wall_s": drv["wall_s"],
                     "seconds": drv["seconds"]})
    out = {"windows": runs, "requests": requests, "round_size": round_size,
           # the kernels line's serve counts: the first window's drains
           "counts": runs[0]["counts"]}
    for r in runs:
        print(f"[serve] verify={r['verify']!r}: {requests} requests in "
              f"rounds of {round_size}, verify_warnings "
              f"{r['verify_warnings']}: "
              f"{r['batches']} routed batches, traffic launches "
              f"{r['counts']}; p50 {r['p50_ms']:.4f} ms, p99 "
              f"{r['p99_ms']:.4f} ms (of {requests} samples: about the "
              f"largest), {r['drain_rps']:.2f} requests/s over the drains, "
              f"{r['loop_rps']:.2f} over submits and drains, "
              f"{r['rps']:.2f} over the loop with its result checks "
              f"(seconds {r['seconds']}); hit rate {r['hit_rate']:.2f}, "
              f"warmed first drain built {r['first_drain']}, worst "
              f"relative error {r['max_rel_err']:.3e}; families "
              f"{r['families']}")
    return out



# ---------------------------------------------------------------------------
# The LM substrate's serving path (PR 17)
# ---------------------------------------------------------------------------

LM_ARCH = "qwen3-8b"
LM_DECODE_TOL = 0.15      # decode vs full forward, the reference's bound
LM_F32_TOL = 1e-4         # card vs CPU, float32 logits
LM_BF16_TOL = 5e-2        # card vs CPU, the configs' bfloat16 logits


def lm_batch(cfg, b: int, s: int, seed: int, device) -> dict:
    """The reference smoke tests' batch (tokens, and the modality stubs'
    embeddings), made from a seed with numpy."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)),
                                       device=device)}
    n = {"audio": s, "vision": min(cfg.n_modality_tokens, s)}.get(
        cfg.modality)
    if n is not None:
        batch["modality_embeds"] = torch.as_tensor(
            rng.standard_normal((b, n, cfg.d_model)), dtype=torch.float32,
            device=device)
    elif cfg.n_enc_layers > 0:
        batch["src_tokens"] = batch["tokens"]
    return batch


def lm_steps(cfg, model, batch: dict, device, steps: int, tokens=None):
    """Prefill ``batch`` and decode ``steps`` greedy tokens: (the logits
    of each step, the greedy tokens).  With ``tokens`` (another run's
    greedy tokens) each step is fed those instead of its own."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import pad_caches
    s = batch["tokens"].shape[1]
    last, caches = make_prefill_step(cfg, device=device)(model, batch)
    caches = pad_caches(caches, cfg, s + steps)
    decode = make_decode_step(cfg, device=device)
    logits, toks = [last], [last.argmax(-1).cpu()]
    for i in range(steps):
        cur = (tokens[i] if tokens is not None else toks[i]).to(device)
        nxt, lg, caches = decode(model, caches, cur[:, None], s + i)
        logits.append(lg)
        toks.append(nxt.cpu())
    return logits, toks


def phase_lm(device, arch: str = LM_ARCH, smoke: bool = False,
             requests: int = 8, batch: int = 4, prompt_len: int = 32,
             max_new: int = 16, check_layers: int = 2,
             timer=time.perf_counter) -> dict:
    """``[lm]``: ``launch.serve.serve`` at qwen3-8b's full width and depth
    (float32 masters, bfloat16 activations, the CLI's defaults), twice from
    one seed: every request gets ``max_new`` tokens in ``[0,
    padded_vocab)``, the same tokens both times (serve's wall time, and
    the tokens/s read from it, include drawing the parameters).  Then, on
    the step
    builders: prefill logits finite; one decode step against the last
    position of a full forward (rel < 0.15, the reference's check, the
    cache padded as ``serve`` pads it); the same prompt on the card and on
    the CPU with the same weights, cut to ``check_layers`` layers (depth
    only) in float32, prefill logits within 1e-4; CUDA-event ms of prefill
    and per decode step, tokens/s, the peak memory, the parameter bytes,
    the decode step's HBM bound (the float32 parameter bytes over
    ``perfmodel.H100_SXM.mem_bw``) and one profiled decode step's busiest
    operations.  No hand-written kernel is on this path (the JAX package
    computes attention with no Pallas kernel): its launches are counted,
    and 0."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.perfmodel import H100_SXM
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import (build_params, make_decode_step,
                                          make_prefill_step)
    from repro_torch.models import costs, transformer as tfm
    cuda = device.type == "cuda"
    cfg = smoke_config(arch) if smoke else get_config(arch)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "requests": requests, "batch": batch, "prompt_len": prompt_len,
           "max_new": max_new}

    runs = []
    for _ in range(2):
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        t0 = timer()
        toks = serve(arch, smoke=smoke, requests=requests, batch=batch,
                     prompt_len=prompt_len, max_new=max_new, seed=SEED,
                     device=None if cuda else device, timer=timer)
        runs.append({"seconds": timer() - t0, "tokens": toks,
                     "counts": path_counts(),
                     "peak_bytes": (torch.cuda.max_memory_allocated(device)
                                    if cuda else None)})
        if cuda:
            torch.cuda.empty_cache()
    toks = runs[0]["tokens"]
    check(len(toks) == requests
          and all(len(r) == max_new for r in toks)
          and all(0 <= t < cfg.padded_vocab for r in toks for t in r),
          f"[lm] serve returned {[len(r) for r in toks]} tokens per request "
          f"or a token outside [0, {cfg.padded_vocab})")
    check(runs[1]["tokens"] == toks, "[lm] two serve runs from one seed "
          "gave different tokens")
    check(runs[0]["counts"]["launches"] == 0, f"[lm] kernel launches on the "
          f"LM serve path: {runs[0]['counts']}")
    out.update(serve_seconds=[r["seconds"] for r in runs],
               serve_tokens_per_s_incl_setup=[
                   requests * max_new / r["seconds"] for r in runs],
               serve_peak_bytes=runs[0]["peak_bytes"],
               counts=runs[0]["counts"], first_request=toks[0])

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    model = build_params(cfg, seed=SEED, device=device)
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    counted = costs.param_counts(cfg)["total"]
    check(abs(param_bytes / 4 - counted) / counted < 1e-3,
          f"[lm] {param_bytes / 4} parameters built, {counted} counted")
    prefill = make_prefill_step(cfg, device=device)
    decode = make_decode_step(cfg, device=device)
    data = lm_batch(cfg, batch, prompt_len, SEED, device)
    last, caches = prefill(model, data)
    check(bool(torch.isfinite(last.float()).all()), "[lm] non-finite "
          "prefill logits")

    # decode against a full forward, the cache padded as serve pads it
    new_tok = torch.full((batch, 1), 3, dtype=torch.long, device=device)
    _, lg, _ = decode(model, tfm.pad_caches(caches, cfg, prompt_len + 1),
                      new_tok, prompt_len)
    with torch.no_grad():
        full, _, _ = tfm.forward(model, cfg, None, dict(
            data, tokens=torch.cat([data["tokens"], new_tok], 1)))
    rel = scaled_err(lg.float(), full[:, -1].float())
    del full
    check(bool(torch.isfinite(lg.float()).all()) and rel < LM_DECODE_TOL,
          f"[lm] decode vs full forward {rel:.4f} (bound {LM_DECODE_TOL})")
    out["decode_vs_forward_rel"] = rel

    if cuda:
        iters = max_new - 1
        out["prefill_ms"] = time_ms(lambda: prefill(model, data), iters=3,
                                    warmup=1)

        def decode_run():
            _, c = prefill(model, data)
            c = tfm.pad_caches(c, cfg, prompt_len + max_new)
            cur = new_tok
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(iters):
                nxt, _, c = decode(model, c, cur, prompt_len + i)
                cur = nxt[:, None]
            stop.record()
            stop.synchronize()
            return start.elapsed_time(stop) / iters

        decode_run()   # warm-up
        step_ms = [decode_run() for _ in range(3)]
        _, c = prefill(model, data)
        c = tfm.pad_caches(c, cfg, prompt_len + max_new)
        out["decode_profile"] = profile_run(
            lambda: decode(model, c, new_tok, prompt_len), device,
            timer=timer, top=8)
        out["prefill_profile"] = profile_run(lambda: prefill(model, data),
                                             device, timer=timer, top=8)
        out.update(decode_step_ms=statistics.median(step_ms),
                   decode_step_ms_runs=step_ms,
                   tokens_per_s=batch * 1e3 / statistics.median(step_ms),
                   peak_bytes=torch.cuda.max_memory_allocated(device))
    bound = param_bytes / H100_SXM.mem_bw * 1e3
    out.update(param_bytes=param_bytes, decode_bound_ms=bound,
               decode_bound_by="bytes")
    del model, caches
    if cuda:
        del c
        torch.cuda.empty_cache()

    # the card against the CPU, same weights, cut to check_layers layers
    cut = dataclasses.replace(cfg, n_layers=check_layers, dtype="float32")
    cpu = torch.device("cpu")
    ref_model = build_params(cut, seed=SEED, device=device).to(cpu)
    dev_model = build_params(cut, seed=SEED, device=device)
    with torch.no_grad():
        got, _, _ = tfm.forward(dev_model, cut, None, data, mode="prefill")
        ref, _, _ = tfm.forward(ref_model, cut, None,
                                {k: v.to(cpu) for k, v in data.items()},
                                mode="prefill")
    err = scaled_err(got.float().cpu(), ref)
    check(err < LM_F32_TOL, f"[lm] {check_layers}-layer float32 prefill, "
          f"card vs CPU: {err:.3e} (bound {LM_F32_TOL})")
    out["card_vs_cpu_err"] = err
    del ref_model, dev_model, got, ref
    if cuda:
        torch.cuda.empty_cache()

    if cuda:
        print(f"[lm] {cfg.name} ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}): {requests} requests x {max_new} tokens "
              f"served twice, same tokens; serve {out['serve_seconds']} s "
              f"({out['serve_tokens_per_s_incl_setup']} tokens/s, drawing "
              f"the parameters included); prefill "
              f"{out['prefill_ms']:.4f} ms ({batch}x{prompt_len}); decode "
              f"{out['decode_step_ms']:.4f} ms per step (runs {step_ms}), "
              f"{out['tokens_per_s']:.2f} tokens/s, HBM bound "
              f"{bound:.4f} ms ({param_bytes} float32 parameter bytes); "
              f"peak {out['peak_bytes']} bytes; decode vs full forward "
              f"{rel:.4f}; {check_layers}-layer card vs CPU {err:.3e}")
        for name in ("decode", "prefill"):
            print(f"[lm] one {name} step under torch.profiler: "
                  + json.dumps(out[f"{name}_profile"]))
    return out


def phase_lm_archs(device, steps: int = 3, b: int = 2, s: int = 32) -> dict:
    """``[lm_archs]``: each of the 10 smoke configs through prefill and
    ``steps`` greedy decode steps on ``device``, held against the same port
    code and weights on the CPU (fed the CPU's greedy tokens): float32
    logits within 1e-4 with equal greedy tokens, the configs' bfloat16
    within 5e-2."""
    import dataclasses

    import torch
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.launch.steps import build_params
    cpu = torch.device("cpu")
    out = {}
    for arch in ARCHS:
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
            model = build_params(cfg, seed=SEED, device=cpu)
            data = lm_batch(cfg, b, s, SEED, cpu)
            ref_lg, ref_toks = lm_steps(cfg, model, data, cpu, steps)
            lg, toks = lm_steps(cfg, model.to(device), {
                k: v.to(device) for k, v in data.items()}, device, steps,
                tokens=ref_toks)
            err = max(scaled_err(g.float().cpu(), r.float())
                      for g, r in zip(lg, ref_lg))
            same = all(torch.equal(g, r) for g, r in zip(toks, ref_toks))
            tol = LM_F32_TOL if dtype == "float32" else LM_BF16_TOL
            check(err < tol and (same or dtype == "bfloat16"),
                  f"[lm_archs] {arch} {dtype}: card vs CPU {err:.3e} "
                  f"(bound {tol}), greedy tokens equal: {same}")
            out[f"{arch}/{dtype}"] = {"err": err, "tokens_equal": same}
    print(f"[lm_archs] {len(ARCHS)} smoke configs, prefill + {steps} "
          f"decode steps, card vs CPU: " + json.dumps(out))
    return out


def phase_lm_fftconv(device, b: int = 1,
                     seqs=(2048, 3072, 3584, 4096, 8192, 12288, 16384,
                           32768),
                     iters: int = 10) -> dict:
    """``[lm_fftconv]``: ``ssm.fft_conv`` at jamba-v0.1-52b's width (d_model
    4096, expand 2: 8192 channels, 16 basis functions), B=1, in float32 and
    in the config's bfloat16, ``fft_backend="kernel"`` against ``"cufft"``.
    At every S the float32 mixer output must be within 1e-4 max-scaled,
    with the counts of 3 transforms of lines of 2S per call (the counts
    set to 0 just before the call and read just after;
    ``expected_counts``): 3 launches on the path ``radix.kernel_path``
    names (long at S=2048: lines of 4096 on the wide kernel; long at S=3072
    and 3584 (lines of 6144 and
    7168, mixed lengths of r = 3 and 7), 4096 and 8192), on lines; at S=12288 (lines of 24576 = 256 x 96), 16384
    and 32768 (``prefill_32k``'s S) 3 split calls of 2 launches each on
    the split path (pass A strided, pass B on lines); none on another path
    (no chirp call), and no line copy.  The 3 transforms alone, kernel
    against cufft, are held to the kernel's complex64 tolerance.
    CUDA-event ms of the mixer on both backends, of its 3 transforms
    alone on the kernel and on ``torch.fft``, the 3 transforms' bound, and
    the peak memory of one float32 kernel call at the longest S."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import transforms as ctf
    from repro_torch.distributed.sharding import ParamBuilder
    from repro_torch.kernels import radix
    from repro_torch.models import ssm
    cuda = device.type == "cuda"
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"),
                              ssm_impl="fft_conv")
    di = cfg.expand * cfg.d_model
    params = ssm.init_fft_conv(ParamBuilder(SEED, device=device), "ssm",
                               cfg)

    def mixer(x, fft_backend):
        return ssm.fft_conv(params, cfg, None, x, fft_backend=fft_backend)

    out = {"d_model": cfg.d_model, "channels": di, "b": b, "runs": []}
    for s in seqs:
        n = 2 * s
        path = radix.kernel_path(n, torch.complex64)
        run = {"s": s, "n": n, "path": path}
        x32 = randc((b, s, cfg.d_model), torch.float32, device, SEED + s)
        for name, x in (("float32", x32), ("bfloat16", x32.bfloat16())):
            ref, _ = mixer(x, fft_backend="cufft")
            if cuda:
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            reset_counts()
            got, _ = mixer(x, fft_backend="kernel")
            if cuda:
                torch.cuda.synchronize(device)
                if name == "float32":
                    run["peak_bytes"] = torch.cuda.max_memory_allocated(
                        device)
            counts = path_counts()
            run[name] = {"err": scaled_err(got.float(), ref.float()),
                         "counts": counts}
            if cuda:
                run[name].update(
                    kernel_ms=time_ms(lambda: mixer(x, fft_backend="kernel"),
                                      iters=iters),
                    cufft_ms=time_ms(lambda: mixer(x, fft_backend="cufft"),
                                     iters=iters))
        if cuda:
            c, want = run["float32"]["counts"], expected_counts(n, 3)
            check(counts_match(c, want), f"[lm_fftconv] S={s}: counts {c}, "
                  f"expected {want} (3 transforms of lines of {n} on the "
                  f"{path} path, no copy)")
        check(run["float32"]["err"] < LM_F32_TOL,
              f"[lm_fftconv] S={s} float32 kernel vs cufft "
              f"{run['float32']['err']:.3e} (bound {LM_F32_TOL})")
        # the 3 transforms alone, at the mixer's shapes
        xt = randc((b, di, n), torch.complex64, device, SEED + 1)
        hp = randc((di, n), torch.complex64, device, SEED + 2)

        def transforms(backend):
            xf = ctf.apply_1d(xt, -1, "fft", backend=backend)
            hf = ctf.apply_1d(hp, -1, "fft", backend=backend)
            return ctf.apply_1d(xf * hf[None], -1, "ifft", backend=backend)

        run["transforms_err"] = scaled_err(transforms("kernel"),
                                           transforms("cufft"))
        check(run["transforms_err"] <= TOL["complex64"],
              f"[lm_fftconv] S={s}: the 3 transforms, kernel vs cufft "
              f"{run['transforms_err']:.3e} (bound {TOL['complex64']})")
        t_lines, by = fft_bound_ms(b * di, n, 8)
        t_h, _ = fft_bound_ms(di, n, 8)
        run.update(transforms_bound_ms=2 * t_lines + t_h,
                   transforms_bound_by=by)
        if cuda:
            run["transforms_kernel_ms"] = time_ms(lambda: transforms("kernel"),
                                                  iters=iters)
            run["transforms_cufft_ms"] = time_ms(lambda: transforms("cufft"),
                                                 iters=iters)
        out["runs"].append(run)
        del xt, hp, x32
        if cuda:
            torch.cuda.empty_cache()
    main = out["runs"][0]
    out.update(launches=main["float32"]["counts"]["launches"],
               scaled_err=main["transforms_err"])
    if cuda:
        out["peak_bytes_longest"] = out["runs"][-1]["peak_bytes"]
        print(f"[lm_fftconv] peak memory of one float32 kernel call at "
              f"S={out['runs'][-1]['s']}: {out['peak_bytes_longest']} bytes")
        for r in out["runs"]:
            print(f"[lm_fftconv] S={r['s']} (lines of {r['n']}, {r['path']} "
                  f"path): mixer kernel vs cufft float32 "
                  f"{r['float32']['err']:.3e}, bfloat16 "
                  f"{r['bfloat16']['err']:.3e}; launches per call "
                  f"{r['float32']['counts']}; mixer ms kernel / cufft: "
                  f"float32 {r['float32']['kernel_ms']:.4f} / "
                  f"{r['float32']['cufft_ms']:.4f}, bfloat16 "
                  f"{r['bfloat16']['kernel_ms']:.4f} / "
                  f"{r['bfloat16']['cufft_ms']:.4f}; the 3 transforms "
                  f"{r['transforms_kernel_ms']:.4f} ms on the kernel, "
                  f"{r['transforms_cufft_ms']:.4f} on torch.fft, bound "
                  f"{r['transforms_bound_ms']:.4f} "
                  f"({r['transforms_bound_by']})")
    return out


def line_entry(x, phase: str, route: str, iters: int = 10,
               plain_iters: int = 3, tol: float = None) -> dict:
    """The user entry (``ops.fft1d``) once on ``(B, N)`` lines, which must
    take ``route`` (``radix.kernel_path``), with the
    counts set to 0 just before and read just after (``expected_counts``
    for one call), held against the plain version (``TOL``) and
    ``torch.fft`` (``tol``, or ``TOL``); then CUDA-event ms of the kernel
    wrapper, its plain version and ``torch.fft.fft`` beside the bound."""
    import torch
    from repro_torch.kernels import ops, radix
    from repro_torch.kernels.fft_matmul import (fft_fourstep,
                                                fft_fourstep_plain)
    cuda = x.device.type == "cuda"
    b, n = x.shape
    dt = str(x.dtype).removeprefix("torch.")
    path = radix.kernel_path(n, x.dtype)
    check(path == route, f"[{phase}] ({b}, {n}) {dt} takes the {path} "
          f"route, expected {route}")
    reset_counts()
    got = ops.fft1d(x)
    if cuda:
        torch.cuda.synchronize(x.device)
    counts = path_counts()
    want = expected_counts(n, 1, x.dtype)
    if cuda:
        check(counts_match(counts, want), f"[{phase}] ({b}, {n}) {dt}: "
              f"counts {counts}, expected {want}")
    ref = fft_fourstep_plain(x)
    lib = torch.fft.fft(x)
    rec = {"shape": [b, n], "dtype": dt, "path": path, "counts": counts,
           "launches": counts[path], "bitwise": bool(torch.equal(got, ref)),
           "max_abs_err": float((got - ref).abs().max()),
           "scaled_err": scaled_err(got, ref),
           "library_err": scaled_err(got, lib)}
    del got, ref, lib
    check(rec["scaled_err"] <= TOL[dt]
          and rec["library_err"] <= (tol or TOL[dt]),
          f"[{phase}] ({b}, {n}) {dt}: kernel vs plain "
          f"{rec['scaled_err']:.3e} (bound {TOL[dt]}), vs torch.fft "
          f"{rec['library_err']:.3e} (bound {tol or TOL[dt]})")
    rec["bound_ms"], rec["bound_by"] = fft_bound_ms(b, n, x.element_size())
    if cuda:
        rec["ms"] = time_ms(lambda: fft_fourstep(x), iters)
        rec["plain_ms"] = time_ms(lambda: fft_fourstep_plain(x),
                                  plain_iters, 1)
        rec["library_ms"] = time_ms(lambda: torch.fft.fft(x), iters)
    return rec


#: (dtype name, N) whose folded pass B ``fold_entry`` times alone: the
#: dense rows with a ragged P on each dtype (complex64 3^15 = 2187 x 6561,
#: C = 8; complex128 2278125 = 1875 x 1215, 2 rows a block, C = 1), c64
#: 10^7 = 1600 x 6250
#: (the kernels line's dense record), the long rows c64 2^24 (its long
#: record) and c128 2^22.
FOLD_TIMED = {("complex64", 3 ** 15), ("complex128", 2278125),
              ("complex64", 10 ** 7), ("complex64", 1 << 24),
              ("complex128", 1 << 22)}


def fold_entry(x, phase: str, iters: int = 10) -> dict:
    """The split route's pass B with pass C folded in (``split.fold_layout``:
    ``split_fold_dense_kernel`` or ``split_fold_long_kernel`` /
    ``split_fold_mixed_kernel``) alone on ``x``'s lines taken as pass A's
    output, through its wrapper (``fft_matmul._launch_fold``, which counts
    nothing) against its plain version on the same inputs (the rows'
    stages and ``split.fold_emulate``, ``TOL``); the cluster's groups
    against the SMs (a batch past one wave of clusters), whether P is
    ragged on them; CUDA-event ms of the kernel and of its plain version
    beside the bound (one read and one write of the lines)."""
    import torch
    from repro_torch.kernels import build, dense, longline, split
    from repro_torch.kernels import fft_matmul as tfm
    b, n = x.shape
    dt = str(x.dtype).removeprefix("torch.")
    plan = split.split_plan(n, x.dtype)
    layout = split.fold_layout(plan, x.dtype)
    check(layout is not None, f"[{phase}] ({b}, {n}) {dt}: no folded pass "
          f"B for {plan}")
    p, q = plan.p, plan.q
    y = torch.empty(b * n + 2, dtype=x.dtype, device=x.device)[:b * n]
    y = y.view(b, p, q)
    y.copy_(x.view(b, p, q))
    out = torch.empty((1, b, n), dtype=x.dtype, device=x.device)
    lib = build.load()
    tfm._declare(lib)
    current = torch.cuda.current_stream(x.device)

    def run():
        err = tfm._launch_fold(lib, y, out, None, plan, layout,
                               inverse=False, seg=n, keep=None,
                               stream=current.cuda_stream, current=current)
        check(err == 0, f"[{phase}] ({b}, {n}) {dt}: the folded pass B "
              f"failed to launch: CUDA error {err}")

    def plain():
        rows = y.reshape(b * p, q)
        if layout.rows == "dense":
            staged, pos = dense.staged(rows, False)
        else:
            pos = split.fold_positions(q, x.dtype)
            staged = torch.zeros((b * p, int(pos.max()) + 1),
                                 dtype=x.dtype, device=x.device)
            staged[:, pos.to(x.device)] = longline.emulate(rows,
                                                           scaled=False)
        return split.fold_emulate(staged.reshape(b, p, -1), pos, plan,
                                  layout)
    run()
    torch.cuda.synchronize(x.device)
    want = plain()
    groups = b * -(-p // layout.group)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    rec = {"rows": layout.rows, "cluster": layout.cluster,
           "lines": layout.lines, "depth": layout.depth,
           "groups": groups, "sms": sms,
           "ragged": p % layout.group != 0,
           "max_abs_err": float((out[0] - want).abs().max()),
           "scaled_err": scaled_err(out[0], want)}
    del want
    check(rec["scaled_err"] <= TOL[dt], f"[{phase}] ({b}, {n}) {dt}: the "
          f"folded pass B vs its plain version {rec['scaled_err']:.3e} "
          f"(bound {TOL[dt]})")
    rec["bound_ms"], rec["bound_by"] = fft_bound_ms(b, n, x.element_size())
    rec["ms"] = time_ms(run, iters)
    rec["plain_ms"] = time_ms(plain, 2, 1)
    rec["library_ms"] = None
    del y, out
    return rec


def print_folds(phase: str, recs) -> None:
    for r in recs:
        f = r.get("fold")
        if f is None:
            continue
        print(f"[{phase}] fold {f['rows']} {tuple(r['shape'])} "
              f"{r['dtype']}: pass B alone {f['ms']:.4f} ms (plain "
              f"{f['plain_ms']:.4f}, bound {f['bound_ms']:.4f}); cluster "
              f"{f['cluster']} x {f['lines']} rows, ring {f['depth']}, "
              f"{f['groups']} groups on {f['sms']} SMs, ragged "
              f"{f['ragged']}; vs plain {f['scaled_err']:.3e}")


def print_lines(phase: str, recs) -> None:
    for r in recs:
        print(f"[{phase}] {r['path']} {tuple(r['shape'])} {r['dtype']}: "
              f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, torch.fft "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"{r['bound_by']}); vs plain {r['scaled_err']:.3e} (bitwise "
              f"{r['bitwise']}), vs torch.fft {r['library_err']:.3e}; "
              f"launches {r['counts']}"
              + (f"; glue ms {r['glue_ms']}" if "glue_ms" in r else ""))


def phase_long(device, shape=(8192, 8192), lengths_bytes: int = 512 << 20,
               radix_shape=(262144, 544), dense_shape=(262144, 816),
               iters: int = 10) -> dict:
    """``[long]``: the long-line kernel at the mixer's shape at S=4096,
    (8192, 8192) complex64, against its plain version (``longline.
    emulate``) and ``torch.fft.fft``, timed beside the HBM bound; every
    other power-of-two long length of both dtypes at 512 MB of lines
    against ``torch.fft`` (``[long_mixed]`` times the mixed ones); the
    radix route at (262144, 544 = 17*32) complex64, whose generic
    17-stage the dense kernel ran before the radix-17 codelet; and the
    dense kernel at a length no other route takes, (262144, 816 = 3*17*16)
    complex64 (no codelet takes 3*17), its generic 17-stage, with its
    plain version, ``torch.fft`` and the bound.  Each kernel is reached
    once through ``ops.fft1d`` with the counts set to 0 just before and
    read just after (one launch on its path)."""
    import torch
    from repro_torch.kernels import longline
    out = {"long": line_entry(randc(shape, torch.complex64, device,
                                    SEED + 20), "long", "long", iters),
           "lengths": []}
    for dtype, sizes in longline.FACTORS.items():
        for n in sizes:
            if (dtype, n) == (torch.complex64, shape[1]) or \
                    longline.long_plan(n, dtype).mixed:
                continue
            b = lengths_bytes // (n * dtype.itemsize)
            out["lengths"].append(line_entry(
                randc((b, n), dtype, device, SEED + n), "long", "long",
                iters))
    out["radix"] = line_entry(randc(radix_shape, torch.complex64, device,
                                    SEED + 22), "long", "radix", iters)
    out["dense"] = line_entry(randc(dense_shape, torch.complex64, device,
                                    SEED + 21), "long", "dense", iters)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        print_lines("long", [out["long"], *out["lengths"], out["radix"],
                             out["dense"]])
    return out

#: (dtype name, N, route, ms) of lengths that a second mixed factor R2
#: moved from the dense kernel or the chirp route to the long-line route,
#: with their time on that route at 256 MB of lines on an H100 80GB HBM3
#: at 700.00 W (``scripts/route_times.py times`` on the tree before the
#: second mixed factor, its first of two runs).
MOVED = (("complex64", 4800, "dense", 5.6854),
         ("complex64", 4480, "dense", 4.3681),
         ("complex64", 8448, "chirp", 3.7352),
         ("complex64", 8960, "chirp", 3.5741),
         ("complex64", 9600, "chirp", 3.3519),
         ("complex64", 11520, "chirp", 2.8511),
         ("complex64", 4992, "chirp", 1.9885),
         ("complex64", 5760, "chirp", 1.7685),
         ("complex128", 4800, "chirp", 3.3321),
         ("complex128", 4224, "chirp", 3.7597),
         ("complex128", 5760, "chirp", 2.8346),
         ("complex128", 2880, "chirp", 1.7584),
         ("complex128", 2400, "dense", 2.5208),
         ("complex128", 1056, "dense", 1.8211))


def phase_long_mixed(device, lengths_bytes: int = 512 << 20,
                     moved_bytes: int = 256 << 20, iters: int = 10) -> dict:
    """``[long_mixed]``: the long-line route at every mixed length of both
    dtypes with one mixed factor (N = r*2^k, r in
    ``radix.EVERY_ROUTE_ODD``, blocks of 128 or 256 threads), about 512
    MB of lines each, reached once through ``ops.fft1d`` (one launch on
    "long"), against its plain version and ``torch.fft``, timed beside
    ``torch.fft.fft`` and the bound; then lengths with a second mixed
    factor that left the dense kernel or the chirp route (``MOVED``) at
    256 MB, each printed beside its time on the route it left.  (``[kernel]``
    checks every length of the route against its plain version.)"""
    import torch
    from repro_torch.kernels import longline, radix
    out = {"lengths": []}
    for dtype, sizes in longline.FACTORS.items():
        for n in sorted(sizes):
            if radix.odd_part(n) not in radix.EVERY_ROUTE_ODD:
                continue
            b = lengths_bytes // (n * dtype.itemsize)
            rec = line_entry(randc((b, n), dtype, device, SEED + 100 + n),
                             "long_mixed", "long", iters)
            rec["factors"] = list(longline.FACTORS[dtype][n])
            rec["threads"] = longline.long_plan(n, dtype).threads
            out["lengths"].append(rec)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    out["moved"] = []
    for dt, n, route, ms_before in MOVED:
        dtype = getattr(torch, dt)
        b = moved_bytes // (n * dtype.itemsize)
        rec = line_entry(randc((b, n), dtype, device, SEED + 200 + n),
                         "long_mixed", "long", iters)
        rec.update(factors=list(longline.FACTORS[dtype][n]),
                   route_before=route, ms_before=ms_before)
        out["moved"].append(rec)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if device.type == "cuda":
        print_lines("long_mixed", out["lengths"] + out["moved"])
        for r in out["moved"]:
            print(f"[long_mixed] {tuple(r['shape'])} {r['dtype']} "
                  f"{'x'.join(map(str, r['factors']))} left the "
                  f"{r['route_before']} route: {r['ms']:.4f} ms on the "
                  f"{r['path']} route against {r['ms_before']:.4f} on the "
                  f"{r['route_before']} (torch.fft {r['library_ms']:.4f}, "
                  f"bound {r['bound_ms']:.4f})")
    return out


#: (dtype name, N) of ``[split_mixed]``: the mixer's lines at S = 12288
#: and the next two lengths of 3*2^k on radix rows, two 2^23-range lengths
#: on long-line rows; complex128 on radix and on long-line rows; then the
#: shortest and the longest 7*2^k, 11*2^k and 13*2^k of each dtype (c64
#: 13*2^20 and c128 13*2^18 raised before the radix-13 codelet), and c64
#: 13*2^12, whose pass B of 208 runs no radix-route length; then the
#: shortest and the longest 21*2^k, 25*2^k and 27*2^k of each dtype
#: (chirp before); then the shortest and the longest 17*2^k, 19*2^k and
#: 23*2^k of each dtype (chirp before; the longest raised, past the
#: chirp's limit); then lengths of the split route's rule
#: (``split.rule_factors``): complex64 33792 = 256 x 132 on radix rows
#: (chirp before), 1982464 = 512 x 3872 on long-line rows (chirp before)
#: and 33*2^18 = 1024 x 8448 past the chirp's limit (raised before).
SPLIT_MIXED_LENGTHS = (("complex64", 24576), ("complex64", 49152),
                       ("complex64", 98304), ("complex64", 3 << 21),
                       ("complex64", 15 << 19), ("complex128", 12288),
                       ("complex128", 24576), ("complex128", 9 << 15),
                       ("complex64", 7 << 12), ("complex64", 7 << 21),
                       ("complex64", 11 << 11), ("complex64", 11 << 20),
                       ("complex128", 7 << 11), ("complex128", 7 << 19),
                       ("complex128", 11 << 10), ("complex128", 11 << 18),
                       ("complex64", 13 << 11), ("complex64", 13 << 20),
                       ("complex128", 13 << 10), ("complex128", 13 << 18),
                       ("complex64", 13 << 12),
                       ("complex64", 21 << 10), ("complex64", 21 << 19),
                       ("complex64", 25 << 10), ("complex64", 25 << 19),
                       ("complex64", 27 << 10), ("complex64", 27 << 19),
                       ("complex128", 21 << 9), ("complex128", 21 << 17),
                       ("complex128", 25 << 9), ("complex128", 25 << 17),
                       ("complex128", 27 << 9), ("complex128", 27 << 17),
                       ("complex64", 17 << 10), ("complex64", 17 << 19),
                       ("complex64", 19 << 10), ("complex64", 19 << 19),
                       ("complex128", 17 << 9), ("complex128", 17 << 17),
                       ("complex128", 19 << 9), ("complex128", 19 << 17),
                       ("complex64", 23 << 10), ("complex64", 23 << 19),
                       ("complex128", 23 << 9), ("complex128", 23 << 17),
                       ("complex64", 33792), ("complex64", 1982464),
                       ("complex64", 33 << 18))


def phase_split_mixed(device, lengths=SPLIT_MIXED_LENGTHS,
                      lengths_bytes: int = 512 << 20,
                      iters: int = 10) -> dict:
    """``[split_mixed]``: the split route at mixed lengths (P a power of
    two, the odd part in Q, on radix or long-line rows), about 512 MB of
    lines each, reached once through ``ops.fft1d`` (one split call),
    against its plain version and ``torch.fft``, timed beside
    ``torch.fft.fft`` and the bound."""
    import torch
    from repro_torch.kernels import split
    out = {"lengths": []}
    for i, (dt, n) in enumerate(lengths):
        dtype = getattr(torch, dt)
        b = max(1, lengths_bytes // (n * dtype.itemsize))
        rec = line_entry(randc((b, n), dtype, device, SEED + 110 + i),
                         "split_mixed", "split", iters)
        plan = split.split_plan(n, dtype)
        rec.update(factors=[plan.p, plan.q], row_path=plan.row_path)
        if device.type == "cuda":
            check(rec["counts"]["split"] == 2, f"[split_mixed] {dt} {n}: "
                  f"{rec['counts']}, expected 2 launches")
        out["lengths"].append(rec)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if device.type == "cuda":
        print_lines("split_mixed", out["lengths"])
    return out


#: (dtype name, N, MB of lines) of ``[split_general]``: the split route's
#: general plans (``split.general_factors``: every other 13-smooth N past
#: one block, pass B on the dense route's launch and pass C): complex64
#: 29106 = 2*3^3*7^2*11 (one factor of 2), 30976 = 256 x 121 and 96000 =
#: 256 x 375 (a radix pass A, Q on no radix or long-line row), the odd
#: 33075, 44100 = one second of CD audio, 10^6, 13^6 = 4826809 (P = 2197,
#: a column tile of 8), all on the chirp before; 10^7 = 2^7*5^7 and 3^15
#: past the chirp's limit, which raised; complex128 14406 = 2*3*7^4,
#: 2278125 = 3^6*5^5 (raised) and 4084223 = 11*13^5 (raised; P = 1859, a
#: column tile of 4; since the folded rows P = 1875 x 1215 and 2197 x 1859,
#: two rows a block), 1397760 = 256 x 5460 (a radix pass A, dense rows on
#: clusters of 2); past the split route's old limit, the nested plans
#: (``split.nested_factors``, which raised before): complex64 3^16 = 2187 x
#: 19683 (dense rows too long for the folded kernel: pass C kept), 2^25 =
#: 512 x 65536 (a radix pass A, rows on the split route), complex128 2^23
#: = 256 x 32768.
SPLIT_GENERAL_LENGTHS = (
    ("complex64", 29106, 256), ("complex64", 30976, 256),
    ("complex64", 33075, 256), ("complex64", 44100, 256),
    ("complex64", 96000, 256), ("complex64", 10 ** 6, 256),
    ("complex64", 13 ** 6, 256), ("complex64", 10 ** 7, 512),
    ("complex64", 3 ** 15, 512), ("complex128", 14406, 256),
    ("complex128", 2278125, 512), ("complex128", 4084223, 512),
    ("complex128", 1397760, 256), ("complex64", 3 ** 16, 512), ("complex64", 1 << 25, 512),
    ("complex128", 1 << 23, 512))


def phase_split_general(device, lengths=SPLIT_GENERAL_LENGTHS,
                        grad_shape=(4, 29106), iters: int = 10) -> dict:
    """``[split_general]``: the split route's general plans (pass A on the
    radix route or the dense kernel's column form, pass B on the dense
    route's stages with pass C folded in, ``split_fold_dense_kernel``) and,
    past its old limit, its nested plans (the rows' own launch on their
    route and pass C: c64 3^16 = 2187 x 19683, 2^25 = 512 x 65536, c128
    2^23 = 256 x 32768) at each of ``lengths``, each reached once through
    ``ops.fft1d`` on the split route with the counts set to 0 just before
    and read just after (``line_entry``: one split call of 2 launches, the
    second on the folded rows, where ``split.fold_layout`` folds; else 3,
    more where the rows run on the split route), against its plain
    version (``TOL``) and within
    ``PATH_TOL`` of ``torch.fft``; the inverse with the twiddle and a
    ``pack_parts`` segment of any length against the plain version;
    CUDA-event ms beside ``torch.fft.fft`` and the bound; then one
    gradient through ``kernels/ops.LineTransform`` at ``grad_shape``
    against ``torch.fft``'s."""
    import torch
    from repro_torch.kernels import ops, split
    from repro_torch.kernels.fft_matmul import (fft_fourstep,
                                                fft_fourstep_plain)
    cuda = device.type == "cuda"
    out = {"lengths": []}
    for i, (dt, n, mb) in enumerate(lengths):
        dtype = getattr(torch, dt)
        b = max(1, (mb << 20) // (n * dtype.itemsize))
        x = randc((b, n), dtype, device, SEED + 150 + i)
        rec = line_entry(x, "split_general", "split", iters, plain_iters=1,
                         tol=PATH_TOL)
        plan = split.split_plan(n, dtype)
        if cuda and split.fold_layout(plan, dtype) is not None:
            c = rec["counts"]
            check(c["split"] == 2 and c["fold_dense"] == 1,
                  f"[split_general] ({b}, {n}) {dt}: {c}, expected 2 "
                  f"launches, the second the folded dense rows")
            if (dt, n) in FOLD_TIMED:
                rec["fold"] = fold_entry(x, "split_general", iters)
        rec.update(factors=[plan.p, plan.q], col_path=plan.col_path,
                   row_path=(plan.row_path if plan.row_path != "any" else
                             "any: " + split.row_route(plan.q, dtype)))
        k = torch.arange(n, dtype=torch.float64, device=device)
        tw = torch.exp(-1j * math.pi * k / (2 * n)).to(dtype)
        parts = next(f for f in (3, 5, 2, 7, 11, 13) if n % f == 0)
        got = fft_fourstep(x, inverse=True, twiddle=tw, pack_parts=parts)
        ref = fft_fourstep_plain(x, inverse=True, twiddle=tw,
                                 pack_parts=parts)
        rec["epilogues"] = {"parts": parts,
                            "scaled_err": scaled_err(got, ref)}
        del got, ref, x
        check(rec["epilogues"]["scaled_err"] <= TOL[dt],
              f"[split_general] ({b}, {n}) {dt}: the inverse with the "
              f"twiddle and pack_parts={parts} vs plain "
              f"{rec['epilogues']['scaled_err']:.3e} (bound {TOL[dt]})")
        out["lengths"].append(rec)
        if cuda:
            torch.cuda.empty_cache()
    # the gradient: the adjoint runs the same route
    x = randc(grad_shape, torch.complex64, device, SEED + 170)
    g = randc(grad_shape, torch.complex64, device, SEED + 171)
    grads = []
    for fn in (ops.fft1d, torch.fft.fft):
        xx = x.clone().requires_grad_(True)
        (fn(xx) * g).real.sum().backward()
        grads.append(xx.grad)
    out["grad_err"] = scaled_err(grads[0], grads[1])
    check(out["grad_err"] <= PATH_TOL, f"[split_general] gradient at "
          f"{grad_shape} vs torch.fft {out['grad_err']:.3e}")
    if cuda:
        folds = [r for r in out["lengths"] if "fold" in r]
        for dt in {r["dtype"] for r in folds}:
            mine = [r["fold"] for r in folds if r["dtype"] == dt]
            check(any(f["ragged"] for f in mine)
                  and any(f["groups"] > f["sms"] for f in mine),
                  f"[split_general] {dt}: no folded pass B with a ragged P "
                  f"or a batch past one wave of clusters: {mine}")
        print_lines("split_general", out["lengths"])
        print_folds("split_general", out["lengths"])
        for r in out["lengths"]:
            print(f"[split_general] {r['dtype']} {r['shape'][1]} as "
                  f"{r['factors'][0]} x {r['factors'][1]} (pass A "
                  f"{r['col_path']}, rows {r['row_path']}); inverse with "
                  f"the epilogues vs plain {r['epilogues']['scaled_err']:.3e}")
        print(f"[split_general] gradient at {grad_shape} vs torch.fft "
              f"{out['grad_err']:.3e}")
    return out


#: (dtype name, N) of ``[mixed]``'s timings beside (262144, 384)
#: complex64: one length per odd part r = 3, 5, 7, 9, 11, 13, 15 and per
#: dtype (the longest 7*2^k, 11*2^k and 13*2^k of each dtype), then the
#: longest r*2^k of each odd product r = 21 to 63 and dtype (complex128
#: 504 for 63: complex64 504 spills and runs dense); then lengths with an
#: odd part from 65 (dense before): complex64 1000 = 25 x 40, 1800 = 40 x
#: 45, 2400 = 48 x 50 and 3600 = 60 x 60, complex128 300 = 15 x 20 and
#: 900 = 30 x 30; then the longest 17*2^k and 19*2^k of each dtype
#: (chirp or dense before): complex64 2176 = 34 x 64, 2432 = 38 x 64,
#: complex128 544 = 17 x 32, 608 = 19 x 32; then the longest 23*2^k of
#: each dtype (dense before, a generic 23-stage): complex64 2944 = 46 x
#: 64, complex128 736 = 23 x 32.  The wide lines among them
#: (``longline.WIDE``) run on the long route's wide kernel.
MIXED_LENGTHS = (("complex64", 1536), ("complex64", 640),
                 ("complex64", 2304), ("complex64", 3840),
                 ("complex128", 768), ("complex128", 640),
                 ("complex128", 576), ("complex128", 960),
                 ("complex64", 3584), ("complex64", 2816),
                 ("complex128", 896), ("complex128", 704),
                 ("complex64", 3328), ("complex128", 832),
                 ("complex64", 2688), ("complex64", 3200),
                 ("complex64", 3456), ("complex64", 2112),
                 ("complex64", 2240), ("complex64", 2496),
                 ("complex64", 2880), ("complex64", 3136),
                 ("complex64", 3520), ("complex64", 4032),
                 ("complex128", 672), ("complex128", 800),
                 ("complex128", 864), ("complex128", 528),
                 ("complex128", 560), ("complex128", 624),
                 ("complex128", 720), ("complex128", 784),
                 ("complex128", 440), ("complex128", 504),
                 ("complex64", 1000), ("complex64", 1800),
                 ("complex64", 2400), ("complex64", 3600),
                 ("complex128", 300), ("complex128", 900),
                 ("complex64", 2176), ("complex64", 2432),
                 ("complex128", 544), ("complex128", 608),
                 ("complex64", 2944), ("complex128", 736))


def phase_mixed(device, shape=(262144, 384), shape7=(262144, 448),
                shape13=(262144, 416), shape21=(262144, 672),
                shape45=(262144, 360), shape75=(262144, 600),
                lengths=MIXED_LENGTHS,
                lengths_bytes: int = 512 << 20, iters: int = 10) -> dict:
    """``[mixed]``: the radix route at mixed lengths (N = r*2^k, chains of
    radix-19, 17, 13, 11, 7, 5, 3, 4 and 2 codelets): (262144, 384) complex64,
    where the dense route took 3.4354 ms before, (262144, 448), where it took
    3.4432 before the radix-7 codelet, (262144, 416), where it took 3.1830
    before the radix-13 codelet, (262144, 672 = 21*32), where it took 6.9234
    before the odd products joined the radix route, (262144, 360 = 45*8), the
    one-degree grid's longitudes, (262144, 600 = 75*8), where the dense route
    took 6.6113 ms before the odd parts from 65 joined the radix route, and one
    length per odd part and dtype at about 512 MB of lines, each reached once
    through ``ops.fft1d`` (one radix launch), against its plain version and
    ``torch.fft``, timed beside ``torch.fft.fft`` and the bound."""
    import torch
    out = {"main": line_entry(randc(shape, torch.complex64, device,
                                    SEED + 70), "mixed", "radix", iters),
           "main7": line_entry(randc(shape7, torch.complex64, device,
                                     SEED + 69), "mixed", "radix", iters),
           "main13": line_entry(randc(shape13, torch.complex64, device,
                                      SEED + 68), "mixed", "radix", iters),
           "main21": line_entry(randc(shape21, torch.complex64, device,
                                      SEED + 67), "mixed", "radix", iters),
           "main45": line_entry(randc(shape45, torch.complex64, device,
                                      SEED + 66), "mixed", "radix", iters),
           "main75": line_entry(randc(shape75, torch.complex64, device,
                                      SEED + 65), "mixed", "radix", iters),
           "lengths": []}
    from repro_torch.kernels import longline
    for i, (dt, n) in enumerate(lengths):
        dtype = getattr(torch, dt)
        b = lengths_bytes // (n * dtype.itemsize)
        # the wide lines take the long route's wide kernel
        route = "long" if n in longline.WIDE[dtype] else "radix"
        out["lengths"].append(line_entry(
            randc((b, n), dtype, device, SEED + 71 + i), "mixed", route,
            iters))
    if device.type == "cuda":
        torch.cuda.empty_cache()
        print_lines("mixed", [out["main"], out["main7"], out["main13"],
                              out["main21"], out["main45"],
                              out["main75"], *out["lengths"]])
    return out


def phase_mixed_plan(device, grid=(384, 384, 384), iters: int = 5,
                     poisson: bool = True) -> dict:
    """``[mixed_plan]``: the main path at a mixed grid.  ``plan_fft`` C2C
    of 384^3 complex64 (453 MB; 448^3, 719 MB, for the radix-7 codelets;
    416^3, 576 MB, for the radix-13 ones; 360^3, 373 MB, for the odd
    products: 360 = 18 x 20, the 3s and the 5 of 45 over both codelets;
    600^3, 1.73 GB, for the odd parts from 65: 600 = 24 x 25, the 5s of
    75 in one codelet, its 3 in the other)
    on ``backend="kernel"``: forward against ``fftn`` (``PATH_TOL``) and
    the round trip (``ROUNDTRIP_TOL``), with exactly 3 radix launches per
    direction (2 on the strided entry), 0 dense, 0 chirp, 0 line copies, a
    contiguous result; CUDA-event ms per direction beside ``fftn``, a
    ``cufft``-backend plan and the bound (three stages, each reading and
    writing the grid once).  Then, with ``poisson``, the PPB Poisson solve
    at the grid in float32 on the kernel against the ``cufft`` backend's
    (``PATH_TOL``), all its launches on the radix route, timed on both."""
    import torch
    from repro_torch import PoissonSolver, make_mesh, plan_fft
    cuda = device.type == "cuda"
    mesh = make_mesh((1, 1), ("data", "model"),
                     device=None if cuda else device)
    plan = plan_fft(mesh, grid, backend="kernel")
    x = randc(grid, torch.complex64, device, SEED + 80)
    reset_counts()
    y = plan.forward(x)
    if cuda:
        torch.cuda.synchronize(device)
    fwd = path_counts()
    reset_counts()
    xr = plan.inverse(y, sharded_in=True)
    if cuda:
        torch.cuda.synchronize(device)
    inv = path_counts()
    ref = torch.fft.fftn(x)
    out = {"grid": list(grid), "forward_counts": fwd, "inverse_counts": inv,
           "err_fwd": scaled_err(y, ref), "err_roundtrip": scaled_err(xr, x),
           "contiguous": bool(y.is_contiguous()),
           "launches": fwd["radix"]}
    del ref, xr
    check(out["err_fwd"] <= PATH_TOL and out["err_roundtrip"]
          <= ROUNDTRIP_TOL, f"[mixed_plan] forward vs fftn "
          f"{out['err_fwd']:.3e} (bound {PATH_TOL}), round trip "
          f"{out['err_roundtrip']:.3e} (bound {ROUNDTRIP_TOL})")
    if cuda:
        for key, c in (("forward", fwd), ("inverse", inv)):
            check(c["launches"] == 3 and c["radix"] == 3 and c["dense"] == 0
                  and c["chirp"] == 0 and c["strided"] == 2
                  and c["copies"] == 0,
                  f"[mixed_plan] {grid} {key}: counts {c}, expected 3 "
                  f"radix launches (2 strided), no dense or chirp launch, "
                  f"no line copy")
        check(out["contiguous"], "[mixed_plan] forward result not "
              "contiguous")
    stage, by = fft_bound_ms(x.numel() // grid[-1], grid[-1], 8)
    out.update(bound_ms=3 * stage, bound_by=by)
    if cuda:
        cplan = plan_fft(mesh, grid, backend="cufft")
        out.update(
            kernel_fwd_ms=time_ms(lambda: plan.forward(x), iters),
            kernel_inv_ms=time_ms(lambda: plan.inverse(y, sharded_in=True),
                                  iters),
            cufft_fwd_ms=time_ms(lambda: cplan.forward(x), iters),
            fftn_ms=time_ms(lambda: torch.fft.fftn(x), iters))
        print(f"[mixed_plan] grid {grid} complex64 on the kernel: forward vs "
              f"fftn {out['err_fwd']:.3e}, round trip "
              f"{out['err_roundtrip']:.3e}; launches forward {fwd}, inverse "
              f"{inv}; ms forward {out['kernel_fwd_ms']:.4f}, inverse "
              f"{out['kernel_inv_ms']:.4f}, cufft plan "
              f"{out['cufft_fwd_ms']:.4f}, fftn {out['fftn_ms']:.4f}, bound "
              f"{out['bound_ms']:.4f} ({by})")
    del y
    if not poisson:
        return out
    topo = ("periodic", "periodic", "bounded")
    solver = PoissonSolver(mesh, grid, topology=topo, backend="kernel")
    csolver = PoissonSolver(mesh, grid, topology=topo, backend="cufft")
    gen = torch.Generator(device=device).manual_seed(SEED + 81)
    rhs = torch.randn(grid, dtype=torch.float32, device=device,
                      generator=gen)
    rhs -= rhs.mean()
    reset_counts()
    phi = solver(rhs)
    if cuda:
        torch.cuda.synchronize(device)
    out["poisson_counts"] = pc = path_counts()
    out["poisson_err"] = scaled_err(phi, csolver(rhs))
    check(out["poisson_err"] <= PATH_TOL, f"[mixed_plan] PPB solve vs the "
          f"cufft backend's {out['poisson_err']:.3e} (bound {PATH_TOL})")
    if cuda:
        check(pc["launches"] == pc["radix"] == 8 and pc["copies"] == 0,
              f"[mixed_plan] PPB solve: counts {pc}, expected 8 radix "
              f"launches and no line copy")
        out.update(solve_kernel_ms=time_ms(lambda: solver(rhs), iters),
                   solve_cufft_ms=time_ms(lambda: csolver(rhs), iters))
        print(f"[mixed_plan] PPB solve at {grid} vs cufft "
              f"{out['poisson_err']:.3e}, launches {pc}, ms kernel "
              f"{out['solve_kernel_ms']:.4f} / cufft "
              f"{out['solve_cufft_ms']:.4f}")
    del x, phi, rhs
    return out


#: (dtype name, N, M's route) of ``[chirp]``: lengths no other route
#: takes, 29*2^k (a prime factor past 23 past the dense route's limit)
#: and the prime 4831 (which left the dense route's generic stage), M =
#: 16384 or, complex128, 8192 on the long-line route; the primes c64
#: 10007 (M = 20449) and c128 4099 (8281) on the dense route's kernel;
#: the prime 20011, M = 40040 on a split plan (rows of 104 on the radix
#: route, pass C kept); the primes c64 744833 (M = 1490580 = 390 x 3822)
#: and c128 210209 (M = 420420 = 196 x 2145) on a split plan whose dense
#: rows fold pass C in (clusters of 8 and 2, the second transform's
#: store keeping the first N).  The first is the ``fft_fourstep_chirp``
#: entry's timing.
CHIRP_LENGTHS = (("complex64", 7424, "long"), ("complex64", 10007, "dense"),
                 ("complex64", 20011, "split"), ("complex128", 3001, "long"),
                 ("complex128", 3712, "long"), ("complex64", 4831, "long"),
                 ("complex128", 4099, "dense"),
                 ("complex64", 744833, "split"),
                 ("complex128", 210209, "split"))
#: (dtype name, N, M's route) of ``[chirp]`` at 512 MB of lines: lengths
#: that raised past the chirp's old limit (half the split route's longest
#: power of two), M on a split plan: the prime 8388617, 2^24 + 1 =
#: 97*257*673, complex128 2^21 + 1 = 9*233017.
CHIRP_PAST = (("complex64", 8388617, "split"),
              ("complex64", (1 << 24) + 1, "split"),
              ("complex128", (1 << 21) + 1, "split"))
#: (dtype name, N, route) of ``[gaps]``, on the dense route but one: the
#: lengths it had with the widest gaps to ``torch.fft`` (the even
#: 13-smooth complex64 2730 = 2*1365, 3430 = 2*1715 and 4050 = 2*2025,
#: complex128 990 = 2*495, which no codelets of the radix or long-line
#: route hold, and the odd complex64 4725), the 13-smooth lengths past
#: its old one-block limit that it took from the chirp route (complex64
#: 16896 = 33*2^9, 23040 = 45*2^9, complex128 8448 = 33*2^8), and a
#: length with a generic stage (complex64 3264 = 3*17*64, complex128 1824
#: = 3*19*32), and complex64 1616 = 101*16, which the refit of
#: ``dense.GENERIC_COST`` moved to the chirp (M = 3380 on the dense
#: route's kernel).
GAP_LENGTHS = (("complex64", 2730, "dense"), ("complex64", 3430, "dense"),
               ("complex64", 4050, "dense"), ("complex128", 990, "dense"),
               ("complex64", 4725, "dense"), ("complex64", 16896, "dense"),
               ("complex64", 23040, "dense"), ("complex128", 8448, "dense"),
               ("complex64", 3264, "dense"), ("complex64", 1616, "chirp"),
               ("complex128", 1824, "dense"))


def phase_chirp(device, lengths=CHIRP_LENGTHS, past=CHIRP_PAST,
                lengths_bytes: int = 256 << 20,
                past_bytes: int = 512 << 20, iters: int = 10) -> dict:
    """``[chirp]``: the chirp route (Bluestein over two transforms of M,
    the cheapest 13-smooth length from 2N - 1, on the dense route's
    kernel, the long-line route or a split plan, the input's chirp in the
    first one's load and the first N kept by the second one's store) at
    each of ``lengths``, about
    256 MB of lines, and ``past``, 512 MB, through ``ops.fft1d`` once (one
    chirp call, its launches all on "chirp", 2 on the dense route's
    kernel or the long-line route: ``expected_counts``), against its
    plain version
    (``chirp.emulate``; ``TOL``) and within ``PATH_TOL`` of
    ``torch.fft``; the inverse with the twiddle and ``pack_parts`` (no
    line copy) against ``torch.fft``; CUDA-event ms beside
    ``torch.fft.fft`` and the lines' bound; M, its route (the one
    ``lengths`` or ``past`` names) and, on a split plan, (P, Q) and the
    rows' route."""
    import torch
    from repro_torch.kernels import chirp, radix, split
    from repro_torch.kernels.fft_matmul import fft_fourstep
    cuda = device.type == "cuda"
    out = {"lengths": []}
    cases = ([(dt, n, route, lengths_bytes) for dt, n, route in lengths]
             + [(dt, n, route, past_bytes) for dt, n, route in past])
    for i, (dt, n, route, nbytes) in enumerate(cases):
        dtype = getattr(torch, dt)
        plan = chirp.chirp_plan(n, dtype)
        check(plan.route == route, f"[chirp] {dt} {n}: M = {plan.m} on the "
              f"{plan.route} route, expected the {route} route")
        b = max(1, nbytes // (n * dtype.itemsize))
        x = randc((b, n), dtype, device, SEED + 90 + i)
        rec = line_entry(x, "chirp", "chirp", iters, plain_iters=1,
                         tol=PATH_TOL)
        rec.update(m=plan.m, m_route=plan.route)
        if plan.split is not None:
            rec.update(factors=[plan.split.p, plan.split.q],
                       rows_route=radix.kernel_path(plan.split.q, dtype))
            if cuda and split.fold_layout(plan.split, dtype) is not None:
                check(rec["counts"]["chirp"] == 4
                      and rec["counts"]["fold_dense"] == 2,
                      f"[chirp] ({b}, {n}) {dt}: {rec['counts']}, expected "
                      f"4 launches, two on the folded dense rows")
        k = torch.arange(n, dtype=torch.float64, device=device)
        tw = torch.exp(-1j * math.pi * k / (2 * n)).to(dtype)
        parts = next((f for f in (2, 3, 5, 7, 11, 13) if n % f == 0), 1)
        reset_counts()
        got = fft_fourstep(x, inverse=True, twiddle=tw, pack_parts=parts)
        counts = path_counts()
        want = torch.fft.ifft(x) * tw
        rec["epilogues"] = {
            "parts": parts, "copies": counts["copies"],
            "launches": counts["chirp"],
            "library_err": scaled_err(got, want.reshape(b, parts,
                                                        n // parts))}
        del got, want, x
        check(rec["epilogues"]["library_err"] <= PATH_TOL
              and counts["copies"] == 0
              and (not cuda or counts["chirp"] == rec["launches"]),
              f"[chirp] ({b}, {n}) {dt}: the inverse with the twiddle and "
              f"pack_parts={parts}: vs torch.fft "
              f"{rec['epilogues']['library_err']:.3e} (bound {PATH_TOL}), "
              f"{counts['copies']} line copies, {counts['chirp']} launches")
        out["lengths"].append(rec)
        if cuda:
            torch.cuda.empty_cache()
    if cuda:
        print_lines("chirp", out["lengths"])
        for r in out["lengths"]:
            rows = (f" = {r['factors'][0]} x {r['factors'][1]}, rows on "
                    f"the {r['rows_route']} route" if "factors" in r
                    else "")
            print(f"[chirp] {r['dtype']} {r['shape'][1]}: M = {r['m']} on "
                  f"the {r['m_route']} route{rows}; {r['launches']} "
                  f"launches a call; inverse with the twiddle and "
                  f"pack_parts={r['epilogues']['parts']} vs torch.fft "
                  f"{r['epilogues']['library_err']:.3e}, "
                  f"{r['epilogues']['copies']} line copies")
    return out


def phase_gaps(device, lengths=GAP_LENGTHS, lengths_bytes: int = 256 << 20,
               iters: int = 10) -> dict:
    """``[gaps]``: the dense route's widest gaps, the lengths it took from
    the chirp route and its generic stage (``GAP_LENGTHS``), each reached
    once through ``ops.fft1d`` on the route ``lengths`` names (one dense
    launch), about 256 MB of lines, against its plain version and within
    ``PATH_TOL`` of ``torch.fft``, timed beside ``torch.fft.fft`` and the
    bound: the readings that rank the next routes to build."""
    import torch
    out = {"lengths": []}
    for i, (dt, n, route) in enumerate(lengths):
        dtype = getattr(torch, dt)
        b = max(1, lengths_bytes // (n * dtype.itemsize))
        out["lengths"].append(line_entry(
            randc((b, n), dtype, device, SEED + 130 + i), "gaps", route,
            iters, plain_iters=2, tol=PATH_TOL))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if device.type == "cuda":
        print_lines("gaps", out["lengths"])
    return out


#: (dtype name, N) of ``[split]``: the ends of the route in both dtypes,
#: the mixer's lines at S = 16384 and 32768, and a length between.
SPLIT_LENGTHS = (("complex64", 1 << 15), ("complex64", 1 << 16),
                 ("complex64", 1 << 20), ("complex64", 1 << 24),
                 ("complex128", 1 << 14), ("complex128", 1 << 16),
                 ("complex128", 1 << 22))


def phase_split(device, lengths=SPLIT_LENGTHS,
                lengths_bytes: int = 512 << 20, iters: int = 10) -> dict:
    """``[split]``: the split route (two launches through HBM for lines
    longer than one block) at each of ``lengths``, about 512 MB of lines,
    reached through ``ops.fft1d`` and ``ops.ifft1d`` with the counts set
    to 0 just before and read just after (``expected_counts``: 1 split
    call of 2 launches, 3 with rows on the long-line route); each
    direction against its plain version
    (``split.emulate``: bitwise or within ``TOL``) and ``torch.fft``;
    the twiddle and ``pack_parts`` epilogues against ``torch.fft`` and
    the plain version; CUDA-event ms beside ``torch.fft.fft``'s and the
    bound (one read and one write of the lines; two HBM passes cannot beat
    half of it)."""
    import torch
    from repro_torch.kernels import ops, split
    from repro_torch.kernels.fft_matmul import (fft_fourstep,
                                                fft_fourstep_plain)
    cuda = device.type == "cuda"
    out = {"lengths": []}
    for i, (dt, n) in enumerate(lengths):
        dtype = getattr(torch, dt)
        b = max(1, lengths_bytes // (n * dtype.itemsize))
        plan = split.split_plan(n, dtype)
        x = randc((b, n), dtype, device, SEED + 40 + i)
        rec = {"shape": [b, n], "dtype": dt, "path": "split",
               "factors": [plan.p, plan.q], "row_path": plan.row_path}
        for inverse in (False, True):
            key = "inverse" if inverse else "forward"
            reset_counts()
            got = (ops.ifft1d if inverse else ops.fft1d)(x)
            if cuda:
                torch.cuda.synchronize(device)
            counts = path_counts()
            want = expected_counts(n, 1, dtype)
            if cuda:
                check(counts_match(counts, want), f"[split] {key} "
                      f"({b}, {n}) {dt}: counts {counts}, expected {want}")
            ref = fft_fourstep_plain(x, inverse=inverse)
            lib = (torch.fft.ifft if inverse else torch.fft.fft)(x)
            rec[key] = {"counts": counts, "bitwise": bool(torch.equal(got,
                                                                      ref)),
                        "max_abs_err": float((got - ref).abs().max()),
                        "scaled_err": scaled_err(got, ref),
                        "library_err": scaled_err(got, lib)}
            del got, ref, lib
            r = rec[key]
            check(r["scaled_err"] <= TOL[dt] and r["library_err"] <= TOL[dt],
                  f"[split] {key} ({b}, {n}) {dt}: kernel vs plain "
                  f"{r['scaled_err']:.3e}, vs torch.fft "
                  f"{r['library_err']:.3e} (bound {TOL[dt]})")
        # the epilogues, on the last store of pass B
        k = torch.arange(n, dtype=torch.float64, device=device)
        tw = torch.exp(-1j * math.pi * k / (2 * n)).to(dtype)
        lib = torch.fft.fft(x)
        got = ops.fft1d(x, twiddle=tw)
        ref = fft_fourstep_plain(x, twiddle=tw)
        rec["twiddle"] = {"scaled_err": scaled_err(got, ref),
                          "library_err": scaled_err(got, lib * tw)}
        del got, ref
        # the send buffer itself, (4, B, N/4)
        got = ops.packed_fft1d(x, 1, 4, inverse=True)
        ref = fft_fourstep_plain(x, inverse=True, pack_parts=4)
        want = torch.fft.ifft(x).reshape(b, 4, n // 4)
        rec["pack"] = {"scaled_err": scaled_err(got, ref.transpose(0, 1)),
                       "library_err": scaled_err(got, want.transpose(0, 1)),
                       "destination_major": bool(got.is_contiguous())}
        del got, ref, want, lib
        for ep in ("twiddle", "pack"):
            check(rec[ep]["scaled_err"] <= TOL[dt]
                  and rec[ep]["library_err"] <= TOL[dt],
                  f"[split] {ep} ({b}, {n}) {dt}: {rec[ep]}")
        check(rec["pack"]["destination_major"],
              f"[split] ({b}, {n}) {dt}: pack buffer not destination-major")
        rec["bound_ms"], rec["bound_by"] = fft_bound_ms(b, n,
                                                        dtype.itemsize)
        if cuda:
            check(rec["forward"]["counts"]["split"] == 2,
                  f"[split] ({b}, {n}) {dt}: {rec['forward']['counts']}, "
                  f"expected 2 launches")
            if (dt, n) in FOLD_TIMED:
                rec["fold"] = fold_entry(x, "split", iters)
            rec["ms"] = time_ms(lambda: fft_fourstep(x), iters)
            rec["library_ms"] = time_ms(lambda: torch.fft.fft(x), iters)
            rec["plain_ms"] = time_ms(lambda: fft_fourstep_plain(x), 3, 1)
        out["lengths"].append(rec)
        del x
        if cuda:
            torch.cuda.empty_cache()
    if cuda:
        for r in out["lengths"]:
            print(f"[split] {tuple(r['shape'])} {r['dtype']} as "
                  f"{r['factors'][0]}x{r['factors'][1]} (rows on "
                  f"{r['row_path']}): {r['ms']:.4f} ms (plain "
                  f"{r['plain_ms']:.4f}, torch.fft {r['library_ms']:.4f}, "
                  f"bound {r['bound_ms']:.4f} {r['bound_by']}); launches "
                  f"{r['forward']['counts']}; vs plain fwd "
                  f"{r['forward']['scaled_err']:.3e} (bitwise "
                  f"{r['forward']['bitwise']}) inv "
                  f"{r['inverse']['scaled_err']:.3e} (bitwise "
                  f"{r['inverse']['bitwise']}); vs torch.fft fwd "
                  f"{r['forward']['library_err']:.3e} inv "
                  f"{r['inverse']['library_err']:.3e}, twiddle "
                  f"{r['twiddle']['library_err']:.3e}, pack "
                  f"{r['pack']['library_err']:.3e}")
        print_folds("split", [dict(r, dtype=r["dtype"]) for r in
                              out["lengths"]])
    return out


def phase_split_plan(device, grid=(64, 64, 32768), iters: int = 5) -> dict:
    """A ``plan_fft`` C2C plan on one card (a (1, 1) mesh) with an axis of
    32768, complex64 (1 GiB), on ``backend="kernel"``: forward against
    ``torch.fft.fftn`` within ``PATH_TOL`` and the round trip within
    ``ROUNDTRIP_TOL``, with the launches per path and the line copies of
    each direction recorded; the long axis runs on the split route (at
    least one split call, no dense launch); CUDA-event ms beside
    ``fftn``'s."""
    import torch
    from repro_torch import make_mesh, plan_fft
    cuda = device.type == "cuda"
    mesh = make_mesh((1, 1), ("data", "model"),
                     device=None if cuda else device)
    plan = plan_fft(mesh, grid, backend="kernel")
    x = randc(grid, torch.complex64, device, SEED + 60)
    reset_counts()
    y = plan.forward(x)
    if cuda:
        torch.cuda.synchronize(device)
    fwd = path_counts()
    reset_counts()
    xr = plan.inverse(y, sharded_in=True)
    if cuda:
        torch.cuda.synchronize(device)
    inv = path_counts()
    ref = torch.fft.fftn(x)
    out = {"grid": list(grid), "forward_counts": fwd, "inverse_counts": inv,
           "err_fwd": scaled_err(y, ref), "err_roundtrip": scaled_err(xr, x)}
    del ref, xr
    check(out["err_fwd"] <= PATH_TOL and out["err_roundtrip"]
          <= ROUNDTRIP_TOL, f"[split_plan] forward vs fftn "
          f"{out['err_fwd']:.3e} (bound {PATH_TOL}), round trip "
          f"{out['err_roundtrip']:.3e} (bound {ROUNDTRIP_TOL})")
    if cuda:
        for key, c in (("forward", fwd), ("inverse", inv)):
            check(c["split_calls"] >= 1 and c["dense"] == 0,
                  f"[split_plan] {key}: counts {c}, expected the axis of "
                  f"{grid[-1]} on the split route and no dense launch")
        out["kernel_fwd_ms"] = time_ms(lambda: plan.forward(x), iters)
        out["kernel_inv_ms"] = time_ms(
            lambda: plan.inverse(y, sharded_in=True), iters)
        out["fftn_ms"] = time_ms(lambda: torch.fft.fftn(x), iters)
        print(f"[split_plan] grid {grid} complex64 on the kernel: forward vs "
              f"fftn {out['err_fwd']:.3e}, round trip "
              f"{out['err_roundtrip']:.3e}; launches forward {fwd}, inverse "
              f"{inv}; ms forward {out['kernel_fwd_ms']:.4f}, inverse "
              f"{out['kernel_inv_ms']:.4f}, fftn {out['fftn_ms']:.4f}")
    del x, y
    return out

def phase_mixed_long_plan(device, grid=(128, 128, 6144), iters: int = 5,
                          long_launches: int = 1, copies=(0, 0)) -> dict:
    """``[mixed_long_plan]``: a ``plan_fft`` C2C plan on one card (a (1, 1)
    mesh) with a mixed axis on the long-line route, by default (128, 128,
    6144) complex64 (805 MB), on ``backend="kernel"``: forward against
    ``torch.fft.fftn`` within ``PATH_TOL`` and the round trip within
    ``ROUNDTRIP_TOL``; per direction ``long_launches`` launches on "long"
    (the 6144 axis on lines), no dense or chirp launch and ``copies``
    line copies, forward and inverse (a long axis that is strided is
    copied contiguous, as every long length is); CUDA-event ms beside
    ``fftn``'s and a ``cufft``-backend plan's."""
    import torch
    from repro_torch import make_mesh, plan_fft
    cuda = device.type == "cuda"
    mesh = make_mesh((1, 1), ("data", "model"),
                     device=None if cuda else device)
    plan = plan_fft(mesh, grid, backend="kernel")
    x = randc(grid, torch.complex64, device, SEED + 120)
    reset_counts()
    y = plan.forward(x)
    if cuda:
        torch.cuda.synchronize(device)
    fwd = path_counts()
    reset_counts()
    xr = plan.inverse(y, sharded_in=True)
    if cuda:
        torch.cuda.synchronize(device)
    inv = path_counts()
    ref = torch.fft.fftn(x)
    out = {"grid": list(grid), "forward_counts": fwd, "inverse_counts": inv,
           "err_fwd": scaled_err(y, ref), "err_roundtrip": scaled_err(xr, x),
           "launches": fwd["long"]}
    del ref, xr
    tag = f"[mixed_long_plan {'x'.join(map(str, grid))}]"
    check(out["err_fwd"] <= PATH_TOL and out["err_roundtrip"]
          <= ROUNDTRIP_TOL, f"{tag} forward vs fftn "
          f"{out['err_fwd']:.3e} (bound {PATH_TOL}), round trip "
          f"{out['err_roundtrip']:.3e} (bound {ROUNDTRIP_TOL})")
    if cuda:
        for key, c, want in (("forward", fwd, copies[0]),
                             ("inverse", inv, copies[1])):
            check(c["long"] == long_launches and c["dense"] == 0
                  and c["chirp"] == 0 and c["copies"] == want,
                  f"{tag} {key}: counts {c}, expected {long_launches} "
                  f"launches on the long-line route, no dense or chirp "
                  f"launch, {want} line copies")
        cplan = plan_fft(mesh, grid, backend="cufft")
        out["kernel_fwd_ms"] = time_ms(lambda: plan.forward(x), iters)
        out["kernel_inv_ms"] = time_ms(
            lambda: plan.inverse(y, sharded_in=True), iters)
        out["cufft_fwd_ms"] = time_ms(lambda: cplan.forward(x), iters)
        out["fftn_ms"] = time_ms(lambda: torch.fft.fftn(x), iters)
        print(f"{tag} grid {grid} complex64 on the kernel: "
              f"forward vs fftn {out['err_fwd']:.3e}, round trip "
              f"{out['err_roundtrip']:.3e}; launches forward {fwd}, inverse "
              f"{inv}; ms forward {out['kernel_fwd_ms']:.4f}, inverse "
              f"{out['kernel_inv_ms']:.4f}, cufft plan "
              f"{out['cufft_fwd_ms']:.4f}, fftn {out['fftn_ms']:.4f}")
    del x, y
    return out

# ---------------------------------------------------------------------------
# The LM substrate's training path (PR 18)
# ---------------------------------------------------------------------------

PEAK_BF16_FLOPS = 989e12  # one H100 SXM, dense bf16 tensor cores
TRAIN_LAYERS = 8          # qwen3-8b's depth cut from 36 (training state)
TRAIN_STEPS = 5
TRAIN_DET_TOL = 1e-3      # the same seed twice: embedding/gather atomics
GRAD_TOL = 1e-4           # gradients, kernel vs cufft and card vs CPU


def phase_train_fftconv(device, b: int = 1, s: int = 2048,
                        iters: int = 5) -> dict:
    """``[train_fftconv]``: ``ssm.fft_conv`` forward and backward at
    jamba-v0.1-52b's mixer width (8192 channels, 16 basis functions),
    B=1, S=2048 (or ``s``), float32, on ``fft_backend="kernel"`` (the
    autograd Function, ``kernels/ops.LineTransform``) against ``"cufft"``
    (torch.fft's autograd): every gradient (w_in, basis_w, decay, w_out,
    the input) within 1e-4 max-scaled; exactly 6 launches on lines per
    forward and backward (3 + the 3 adjoints, the counts set to 0 just
    before and read just after), all on the path ``radix.kernel_path``
    names for lines of 2S (long at S=2048 on the wide kernel and at
    S=4096), and no line
    copy (``expected_counts``: at S=16384 6 split calls of 2 launches
    each); CUDA-event ms of forward and backward on both backends beside
    the bound of its 6 transforms (bytes over HBM bandwidth, as
    ``[lm_fftconv]`` reckons its 3)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import ParamBuilder
    from repro_torch.kernels import radix
    from repro_torch.models import ssm
    cuda = device.type == "cuda"
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"),
                              ssm_impl="fft_conv", dtype="float32")
    di, n = cfg.expand * cfg.d_model, 2 * s
    path = radix.kernel_path(n, torch.complex64)
    params = ssm.init_fft_conv(ParamBuilder(SEED, device=device), "ssm",
                               cfg)
    params.requires_grad_(True)
    x = randc((b, s, cfg.d_model), torch.float32, device, SEED + 7)
    r = randc((b, s, cfg.d_model), torch.float32, device, SEED + 8)

    def fwd_bwd(backend):
        for p in params.parameters():
            p.grad = None
        xx = x.detach().requires_grad_(True)
        y, _ = ssm.fft_conv(params, cfg, None, xx, fft_backend=backend)
        (y * r).sum().backward()
        return {**{k: p.grad for k, p in params.named_parameters()},
                "x": xx.grad}

    ref = fwd_bwd("cufft")
    reset_counts()
    got = fwd_bwd("kernel")
    if cuda:
        torch.cuda.synchronize(device)
    counts = path_counts()
    errs = {k: scaled_err(got[k], ref[k]) for k in ref}
    out = {"d_model": cfg.d_model, "channels": di, "b": b, "s": s, "n": n,
           "path": path, "counts": counts, "grad_errs": errs,
           "launches": counts["launches"]}
    check(all(e < GRAD_TOL for e in errs.values()),
          f"[train_fftconv] kernel vs cufft gradients {errs} (bound "
          f"{GRAD_TOL})")
    check(all(bool(v.abs().max() > 0) for v in got.values()),
          "[train_fftconv] a gradient is all zeros")
    if cuda:
        want = expected_counts(n, 6)
        check(counts_match(counts, want), f"[train_fftconv] S={s}: counts "
              f"{counts}, expected {want} (6 transforms of lines of {n} on "
              f"the {path} path, no copy)")
    t_lines, by = fft_bound_ms(b * di, n, 8)
    t_h, _ = fft_bound_ms(di, n, 8)
    out.update(bound_ms=4 * t_lines + 2 * t_h, bound_by=by)
    if cuda:
        out["kernel_ms"] = time_ms(lambda: fwd_bwd("kernel"), iters=iters)
        out["cufft_ms"] = time_ms(lambda: fwd_bwd("cufft"), iters=iters)
        print(f"[train_fftconv] S={s}, {di} channels: forward+backward "
              f"kernel vs cufft gradients {json.dumps(errs)}; launches "
              f"{counts}; ms kernel {out['kernel_ms']:.4f} / cufft "
              f"{out['cufft_ms']:.4f}; the 6 transforms' bound "
              f"{out['bound_ms']:.4f} ({by})")
    del params, x, r, ref, got
    return out


def train_flops(cfg, tokens: int, seq: int) -> dict:
    """The step's least work: ``6 * N * T`` for the N parameters that
    multiply activations (every layer's projections and the LM head; the
    embedding lookup is no matmul) over T tokens, plus causal attention
    ``6 * L * S^2 * H * hd`` per sequence (QK^T and PV, forward and twice
    that backward, half the S^2 pairs).  Recomputation is not counted:
    it is the step's choice, not the function's work."""
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    h, k = cfg.n_heads, cfg.n_kv_heads
    per_layer = d * h * hd * 2 + d * k * hd * 2 + 3 * d * cfg.d_ff
    n_mm = cfg.n_layers * per_layer + d * cfg.padded_vocab
    attn = 6 * cfg.n_layers * seq * seq * h * hd * (tokens // seq)
    return {"matmul_params": n_mm, "flops": 6 * n_mm * tokens + attn}


def phase_train(device, arch: str = LM_ARCH, layers: int = TRAIN_LAYERS,
                seq: int = 4096, batch: int = 1, steps: int = TRAIN_STEPS,
                check_layers: int = 2, check_seq: int = 256,
                timer=time.perf_counter) -> dict:
    """``[train]``: ``launch/train.py``'s step (``make_train_step``) at
    qwen3-8b's full width (d_model 4096,
    32 heads, kv 8, d_ff 12288, vocab 151936, qk-norm), depth cut to
    ``layers`` of 36, bfloat16 activations, float32 masters and AdamW
    moments, ``remat=True``, ``grad_compress=True``; ``train_4k``'s
    sequence of 4096 with the batch cut from 256 to 1; ``steps`` steps of
    ``SyntheticLM`` data from seed 0, twice from one seed.  The optimizer
    is ``AdamWConfig()``, the reference's defaults (peak 3e-4, warm-up 100
    of 10000 steps): these are the first steps of a run.  With
    ``train()``'s schedule for a 5-step run (warm-up 2) the loss rises
    after the first update at this width (PERF.md, PR 18).  Gates: every
    loss finite, the last below the first, the two runs' losses within
    1e-3 relative (embedding and gather backward accumulate with atomics
    on the card); the same step on the card and on the CPU from the same
    weights cut to ``check_layers`` layers in float32 on ``check_seq``
    tokens, loss and gradient leaves within 1e-4.  Records ms per step
    (CUDA events, the median of the steps after the first), tokens/s, the
    FLOP and byte bounds, peak memory, and one step under
    ``torch.profiler``."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import (build_params, loss_and_grads,
                                          make_train_step)
    from repro_torch.models.config import SHAPES
    from repro_torch.models.convert import param_leaves
    from repro_torch.optim import AdamWConfig, adamw_init
    cuda = device.type == "cuda"
    full = get_config(arch) if cuda else smoke_config(arch)
    cfg = dataclasses.replace(full, n_layers=min(layers, full.n_layers))
    shape = SHAPES["train_4k"]
    opt_cfg = AdamWConfig()
    data = SyntheticLM(cfg, shape, seed=SEED, batch_override=batch,
                       seq_override=seq)
    step_fn = make_train_step(cfg, None, opt_cfg, remat=True,
                              grad_compress=True, device=device)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "layers_of": full.n_layers, "d_model": cfg.d_model,
           "seq": seq, "batch": batch, "steps": steps,
           "reduced": [f"depth {cfg.n_layers} of {full.n_layers} layers",
                       f"batch {batch} of {shape.global_batch}"]}

    def run(profile: bool = False):
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        model = build_params(cfg, seed=SEED, device=device)
        state = adamw_init(param_leaves(model), opt_cfg)
        losses, events = [], []
        for i in range(steps):
            b_ = data.device_batch(i, device)
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            _, _, metrics = step_fn(model, state, b_)
            if cuda:
                ev[1].record()
                events.append(ev)
            losses.append(metrics["loss"])
        losses = [float(v) for v in losses]
        rec = {"losses": losses}
        if cuda:
            torch.cuda.synchronize(device)
            rec["step_ms"] = [a.elapsed_time(z) for a, z in events]
            rec["peak_bytes"] = torch.cuda.max_memory_allocated(device)
            if profile:
                b_ = data.device_batch(steps, device)
                rec["profile"] = profile_run(
                    lambda: step_fn(model, state, b_), device, timer=timer,
                    top=16)
        rec["param_bytes"] = sum(p.numel() * p.element_size()
                                 for p in model.parameters())
        del model, state
        if cuda:
            torch.cuda.empty_cache()
        return rec

    first = run(profile=True)
    second = run()
    l1, l2 = first["losses"], second["losses"]
    rel = max(abs(a - b_) / abs(b_) for a, b_ in zip(l1, l2))
    check(all(math.isfinite(v) for v in l1 + l2),
          f"[train] non-finite loss {l1} {l2}")
    check(l1[-1] < l1[0], f"[train] the loss did not fall: {l1}")
    check(rel <= TRAIN_DET_TOL, f"[train] two runs from one seed: "
          f"{l1} vs {l2} (rel {rel:.3e}, bound {TRAIN_DET_TOL})")
    out.update(losses=l1, losses_again=l2, same_seed_rel=rel,
               same_seed_bitwise=l1 == l2, param_bytes=first["param_bytes"])
    work = train_flops(cfg, batch * seq, seq)
    t_ops = work["flops"] / PEAK_BF16_FLOPS * 1e3
    # params, m and v read once and written once (float32 state)
    state_bytes = 3 * first["param_bytes"]
    t_bytes = 2 * state_bytes / PEAK_HBM_BYTES * 1e3
    out.update(matmul_params=work["matmul_params"], flops=work["flops"],
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               flops_bound_ms=t_ops, bytes_bound_ms=t_bytes)
    if cuda:
        ms = statistics.median(first["step_ms"][1:])
        out.update(step_ms=ms, step_ms_runs=[first["step_ms"],
                                             second["step_ms"]],
                   tokens_per_s=batch * seq * 1e3 / ms,
                   peak_bytes=first["peak_bytes"],
                   profile=first["profile"])

    # the card against the CPU, same weights, cut to check_layers layers
    cut = dataclasses.replace(cfg, n_layers=check_layers, dtype="float32")
    cpu = torch.device("cpu")
    host = SyntheticLM(cut, shape, seed=SEED, batch_override=1,
                       seq_override=check_seq).batch_for_step(0)
    res = {}
    for dev in (device, cpu):
        model = build_params(cut, seed=SEED, device=device).to(dev)
        loss, _, grads = loss_and_grads(model, cut, None,
                                        SyntheticLM.to_device(host, dev))
        pick = [k for k in grads if k[0] in ("embed", "lm_head",
                                             "decoder/layer0/attn/wq",
                                             "decoder/layer0/mlp/w_down")]
        res[dev.type] = (float(loss), {k: grads[k].cpu() for k in pick})
        del model, grads
        if cuda:
            torch.cuda.empty_cache()
    (lc, gc), (lr_, gr) = res[device.type], res["cpu"]
    gerr = {"/".join(map(str, k)): scaled_err(gc[k], gr[k]) for k in gr}
    lerr = abs(lc - lr_) / abs(lr_)
    check(lerr < LM_F32_TOL and all(e < GRAD_TOL for e in gerr.values()),
          f"[train] {check_layers}-layer float32 card vs CPU: loss "
          f"{lerr:.3e}, gradients {gerr} (bound {GRAD_TOL})")
    out.update(card_vs_cpu_loss_rel=lerr, card_vs_cpu_grad_errs=gerr)
    if cuda:
        print(f"[train] {cfg.name} at {cfg.n_layers} of {full.n_layers} "
              f"layers, d_model {cfg.d_model}, B={batch} S={seq}, remat, "
              f"bf16 grads: losses {l1} (again {l2}, rel {rel:.3e}); "
              f"{out['step_ms']:.2f} ms per step (runs "
              f"{out['step_ms_runs']}), {out['tokens_per_s']:.1f} tokens/s; "
              f"bound {out['bound_ms']:.2f} ms ({out['bound_by']}: "
              f"{work['flops']:.4e} FLOP, {work['matmul_params']} matmul "
              f"parameters; bytes {t_bytes:.2f} ms); peak "
              f"{out['peak_bytes']} bytes ({first['param_bytes']} parameter "
              f"bytes); {check_layers}-layer card vs CPU loss {lerr:.3e}, "
              f"gradients {json.dumps(gerr)}")
        print("[train] one step under torch.profiler: "
              + json.dumps(out["profile"]))
    return out


def phase_train_ckpt(device, arch: str = LM_ARCH, steps: int = 20,
                     every: int = 10) -> dict:
    """``[train_ckpt]``: ``launch/train.py``'s ``train`` at the smoke config
    on ``device`` in a temporary directory (a full-width checkpoint would
    write 33 GB): ``steps`` steps straight, against ``every`` steps, a
    simulated preemption (``stop_after``) and a resume; the losses within
    1e-3 relative (the reference's bound; the embedding's backward
    accumulates with atomics on the card); the final checkpoint restored
    onto the CPU equal to the same checkpoint restored onto the card."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import train
    out = {"arch": arch, "steps": steps, "every": every,
           "reduced": ["smoke width: a full-width checkpoint is 33 GB"]}
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(steps=steps, smoke=True, ckpt_every=every,
                  log_every=steps, seed=SEED, device=device)
        full = train(arch, ckpt_dir=os.path.join(tmp, "a"), **kw)
        part = train(arch, ckpt_dir=os.path.join(tmp, "b"),
                     stop_after=every, **kw)
        rest = train(arch, ckpt_dir=os.path.join(tmp, "b"), **kw)
        mgr = CheckpointManager(os.path.join(tmp, "b"))
        step_cpu, on_cpu = mgr.restore(device="cpu")
        _, on_dev = mgr.restore(device=device)
    joined = part["losses"] + rest["losses"]
    rel = max(abs(a - b_) / abs(b_) for a, b_ in zip(joined, full["losses"]))
    check(len(part["losses"]) == every and len(joined) == steps
          and rel <= TRAIN_DET_TOL,
          f"[train_ckpt] resumed {joined} vs uninterrupted {full['losses']} "
          f"(rel {rel:.3e}, bound {TRAIN_DET_TOL})")

    def leaves(tree, pre=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{pre}{k}/")
            else:
                yield pre + k, v
    cpu_leaves, dev_leaves = dict(leaves(on_cpu)), dict(leaves(on_dev))
    check(step_cpu == steps and sorted(cpu_leaves) == sorted(dev_leaves)
          and all(v.device.type == "cpu" for v in cpu_leaves.values())
          and all(torch.equal(v, dev_leaves[k].cpu())
                  for k, v in cpu_leaves.items())
          and int(on_cpu["opt"]["count"]) == steps,
          "[train_ckpt] the checkpoint restored onto the CPU differs from "
          "the one restored onto the card")
    out.update(losses=full["losses"], resumed=joined, rel=rel,
               bitwise=joined == full["losses"], arrays=len(cpu_leaves))
    print(f"[train_ckpt] {arch} smoke, {steps} steps: resumed at step "
          f"{every} vs uninterrupted rel {rel:.3e} (bitwise "
          f"{out['bitwise']}); {len(cpu_leaves)} arrays restored onto the "
          f"CPU, equal to the card's")
    return out


def phase_lm_sharded(device, arch: str = LM_ARCH, layers: int = 2,
                     seq: int = 4096, s_fft: int = 2048) -> dict:
    """``[lm_sharded]``: the mesh path of the LM (``rules.mesh``, the
    sharded parameters, ``sharded_batch``, the collectives) on one card:
    an NCCL group of one (gloo on the CPU) with an explicit (1, 1) mesh.
    ``serve`` and two ``train`` steps at ``arch``'s full width cut to
    ``layers`` layers (the smoke config on the CPU), each bitwise equal
    to the run with ``mesh=None`` (every collective is skipped on an axis
    of one rank); then ``fft_conv`` at jamba-v0.1-52b's mixer width
    forward and backward with the mesh's rules on the kernel against
    ``cufft``: 6 launches on lines (the counts set to 0 just before and
    read just after) on the route of lines of 2 * ``s_fft`` (4096: the
    long route's wide kernel), no line copy, gradients within 1e-4.  The
    drivers build the cut config through their ``get_config`` and
    ``smoke_config``, set to it for the phase's runs."""
    import dataclasses

    import torch
    import torch.distributed as dist
    import repro_torch.launch.serve as serve_mod
    import repro_torch.launch.train as train_mod
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.distributed.sharding import MeshRules, ParamBuilder
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models import ssm
    cuda = device.type == "cuda"
    full = get_config(arch) if cuda else smoke_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    out = {"arch": cfg.name, "n_layers": layers, "d_model": cfg.d_model,
           "reduced": [f"depth {layers} of {full.n_layers} layers"]}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method=f"file://{tmp}/rendezvous",
                                world_size=1, rank=0)
        try:
            mesh = make_lm_mesh((1, 1), device=None if cuda else device)
            drivers = [(m, n, getattr(m, n)) for m in (serve_mod, train_mod)
                       for n in ("get_config", "smoke_config")]
            for m, n, _ in drivers:
                setattr(m, n, lambda name: cfg)
            try:
                kw = dict(requests=2, batch=2, max_new=8, seed=SEED)
                toks = [serve_mod.serve(arch, mesh=mesh, **kw),
                        serve_mod.serve(arch, device=device, **kw)]
                kw = dict(steps=2, seq_len=seq if cuda else 64,
                          global_batch=1, log_every=9, seed=SEED)
                losses = [train_mod.train(arch, mesh=mesh, **kw)["losses"],
                          train_mod.train(arch, device=device,
                                          **kw)["losses"]]
            finally:
                for m, n, f in drivers:
                    setattr(m, n, f)
            if cuda:
                torch.cuda.empty_cache()
            check(toks[0] == toks[1], f"[lm_sharded] (1, 1) mesh tokens "
                  f"{toks[0]} vs no mesh {toks[1]}")
            check(losses[0] == losses[1] and all(
                math.isfinite(v) for v in losses[0]),
                f"[lm_sharded] (1, 1) mesh losses {losses[0]} vs no mesh "
                f"{losses[1]}")
            out.update(tokens=toks[0], losses=losses[0], bitwise=True)

            # fft_conv through the mesh path
            fcfg = dataclasses.replace(get_config("jamba-v0.1-52b"),
                                       ssm_impl="fft_conv", dtype="float32")
            rules = MeshRules.for_mesh(mesh)
            params = ssm.init_fft_conv(
                ParamBuilder(SEED, device=device, rules=rules), "ssm", fcfg)
            params.requires_grad_(True)
            x = randc((1, s_fft, fcfg.d_model), torch.float32, device,
                      SEED + 7)
            r = randc((1, s_fft, fcfg.d_model), torch.float32, device,
                      SEED + 8)

            def fwd_bwd(backend):
                for p in params.parameters():
                    p.grad = None
                xx = x.detach().requires_grad_(True)
                y, _ = params(xx, rules=rules, fft_backend=backend)
                (y * r).sum().backward()
                return {**{k: p.grad for k, p in params.named_parameters()},
                        "x": xx.grad}

            ref = fwd_bwd("cufft")
            reset_counts()
            got = fwd_bwd("kernel")
            if cuda:
                torch.cuda.synchronize(device)
            counts = path_counts()
        finally:
            dist.destroy_process_group()
    errs = {k: scaled_err(got[k], ref[k]) for k in ref}
    out.update(fft_conv_channels=fcfg.expand * fcfg.d_model, s=s_fft,
               counts=counts, grad_errs=errs, launches=counts["launches"])
    check(all(e < GRAD_TOL for e in errs.values()),
          f"[lm_sharded] fft_conv kernel vs cufft gradients {errs} (bound "
          f"{GRAD_TOL})")
    if cuda:
        from repro_torch.kernels import radix
        path = radix.kernel_path(2 * s_fft, torch.complex64)
        check(counts["launches"] == 6 and counts[path] == 6
              and counts["lines"] == 6 and counts["copies"] == 0,
              f"[lm_sharded] fft_conv counts {counts}, expected 6 {path} "
              f"launches on lines and no copy")
        print(f"[lm_sharded] {cfg.name} at {layers} of {full.n_layers} "
              f"layers on a (1, 1) NCCL mesh: serve tokens and 2 train "
              f"losses {losses[0]} bitwise equal to no mesh; fft_conv "
              f"forward+backward through the mesh path: launches {counts}, "
              f"gradients {json.dumps(errs)}")
    del params, x, r, ref, got
    return out


def main(timer=time.perf_counter) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the port "
              "on a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version: fp32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t0 = timer()
    laps, last = {}, [t0]

    def lap(name):
        # seconds of each phase since the one before
        now = timer()
        laps[name], last[0] = now - last[0], now
    report = {"build": phase_build()}
    lap("build")
    report["kernel_vs_plain"] = phase_kernel_vs_plain(device)
    lap("kernel_vs_plain")
    report["main"] = main_run = phase_main_path(device)
    lap("main")
    torch.cuda.empty_cache()
    report["pack"] = pack = phase_pack(device)
    lap("pack")
    torch.cuda.empty_cache()
    report["poisson"] = poisson = phase_poisson(device)
    lap("poisson")
    torch.cuda.empty_cache()
    report["twiddle"] = tw = phase_twiddle_timing(device)
    lap("twiddle")
    torch.cuda.empty_cache()
    report["r2c"] = phase_r2c(device)
    lap("r2c")
    torch.cuda.empty_cache()
    report["chunked"] = phase_chunked(device)
    lap("chunked")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        from repro_torch.core.plan import TuningCache
        cache = TuningCache(os.path.join(tmp, "tuning.json"))
        report["calibrate"] = phase_calibrate(device, cache)
        lap("calibrate")
        report["tune"] = phase_tune(device, cache, poisson)
        lap("tune")
    torch.cuda.empty_cache()
    report["segments"] = segs = phase_segments(device)
    lap("segments")
    torch.cuda.empty_cache()
    report["executor"] = execu = phase_executor(device)
    lap("executor")
    torch.cuda.empty_cache()
    report["analysis"] = analysis = phase_analysis(device)
    lap("analysis")
    torch.cuda.empty_cache()
    report["serve"] = serve = phase_serve(device)
    lap("serve")
    torch.cuda.empty_cache()
    report["lm"] = lm = phase_lm(device, timer=timer)
    lap("lm")
    torch.cuda.empty_cache()
    report["lm_archs"] = phase_lm_archs(device)
    lap("lm_archs")
    torch.cuda.empty_cache()
    report["long"] = long_ = phase_long(device)
    lap("long")
    torch.cuda.empty_cache()
    report["split"] = split_ = phase_split(device)
    lap("split")
    torch.cuda.empty_cache()
    report["split_plan"] = phase_split_plan(device)
    lap("split_plan")
    torch.cuda.empty_cache()
    report["mixed"] = mixed = phase_mixed(device)
    lap("mixed")
    torch.cuda.empty_cache()
    report["mixed_plan"] = mixed_plan = phase_mixed_plan(device)
    lap("mixed_plan")
    torch.cuda.empty_cache()
    report["mixed_plan_448"] = mixed_plan7 = phase_mixed_plan(
        device, grid=(448, 448, 448), poisson=False)
    lap("mixed_plan_448")
    torch.cuda.empty_cache()
    report["mixed_plan_416"] = mixed_plan13 = phase_mixed_plan(
        device, grid=(416, 416, 416), poisson=False)
    lap("mixed_plan_416")
    torch.cuda.empty_cache()
    report["mixed_plan_360"] = mixed_plan45 = phase_mixed_plan(
        device, grid=(360, 360, 360), poisson=False)
    lap("mixed_plan_360")
    torch.cuda.empty_cache()
    report["mixed_plan_600"] = mixed_plan75 = phase_mixed_plan(
        device, grid=(600, 600, 600), poisson=False)
    lap("mixed_plan_600")
    torch.cuda.empty_cache()
    report["long_mixed"] = long_mixed = phase_long_mixed(device)
    lap("long_mixed")
    torch.cuda.empty_cache()
    report["split_mixed"] = split_mixed = phase_split_mixed(device)
    lap("split_mixed")
    torch.cuda.empty_cache()
    report["split_general"] = split_general = phase_split_general(device)
    lap("split_general")
    torch.cuda.empty_cache()
    report["mixed_long_plan"] = phase_mixed_long_plan(device)
    lap("mixed_long_plan")
    torch.cuda.empty_cache()
    # one face of the LLC4320 ocean grid: 4320 = 30 x 9 x 16 on both axes;
    # the forward copies the strided axis's lines and then the last
    # axis's, which the first stage left as a strided view
    report["mixed_long_plan_4320"] = face = phase_mixed_long_plan(
        device, grid=(4320, 4320), long_launches=2, copies=(2, 1))
    lap("mixed_long_plan_4320")
    torch.cuda.empty_cache()
    report["chirp"] = chirp_ = phase_chirp(device)
    lap("chirp")
    torch.cuda.empty_cache()
    report["gaps"] = gaps = phase_gaps(device)
    lap("gaps")
    torch.cuda.empty_cache()
    report["lm_fftconv"] = fftconv = phase_lm_fftconv(device)
    lap("lm_fftconv")
    torch.cuda.empty_cache()
    report["train_fftconv"] = train_fftconv = phase_train_fftconv(device)
    lap("train_fftconv")
    torch.cuda.empty_cache()
    report["train_fftconv_3072"] = train_mixed = phase_train_fftconv(
        device, s=3072, iters=3)
    lap("train_fftconv_3072")
    torch.cuda.empty_cache()
    report["train_fftconv_4096"] = train_long = phase_train_fftconv(
        device, s=4096)
    lap("train_fftconv_4096")
    torch.cuda.empty_cache()
    report["train_fftconv_16384"] = train_split = phase_train_fftconv(
        device, s=16384, iters=3)
    lap("train_fftconv_16384")
    torch.cuda.empty_cache()
    report["train"] = phase_train(device, timer=timer)
    lap("train")
    torch.cuda.empty_cache()
    report["train_ckpt"] = phase_train_ckpt(device)
    lap("train_ckpt")
    torch.cuda.empty_cache()
    report["lm_sharded"] = lm_sharded = phase_lm_sharded(device)
    lap("lm_sharded")
    torch.cuda.empty_cache()

    mixer_runs = {r["s"]: r for r in fftconv["runs"]}
    long_mixed_6144 = next(r for r in long_mixed["lengths"]
                           if r["shape"][1] == 6144
                           and r["dtype"] == "complex64")

    def _timing(rec):
        return {k: rec[k] for k in ("max_abs_err", "scaled_err", "ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}

    def by_path(layout):
        # the FFT mixer at S=2048 (lines of 4096) runs the wide kernel:
        # its launches are that kernel's entry's
        return {"segments": segs["forward"][layout] + segs["inverse"][layout],
                "executor": execu["counts"][layout],
                "analysis": analysis["counts"][layout],
                "serve": serve["counts"][layout],
                "lm": lm["counts"][layout]}
    wide_2944 = next(r for r in mixed["lengths"]
                     if r["shape"][1] == 2944 and r["dtype"] == "complex64")
    fold_dense_rec = next(r for r in split_general["lengths"]
                          if r["shape"][1] == 10 ** 7)
    fold_long_rec = next(r for r in split_["lengths"]
                         if r["shape"][1] == 1 << 24)

    def _fold_timing(rec):
        # the folded pass B alone (fold_entry), not the split call
        return {k: rec["fold"][k] for k in (
            "max_abs_err", "scaled_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")}
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
         "library_ms": main_run["stage_library_ms"],
         "launches_by_path": by_path("lines")},
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
         "library_ms": main_run["strided_mid_library_ms"],
         "launches_by_path": by_path("strided")},
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
        # launches: the mixer at S=4096, its main path (3 per call)
        {"name": "fft_fourstep_long", "route": "cuda", "source": LONG_SOURCE,
         "path": "long", "replaces": "src/repro/kernels/fft_matmul.py:216",
         "launches": mixer_runs[4096]["float32"]["counts"]["long"],
         "max_abs_err": long_["long"]["max_abs_err"],
         "scaled_err": long_["long"]["scaled_err"],
         "ms": long_["long"]["ms"], "plain_ms": long_["long"]["plain_ms"],
         "bound_ms": long_["long"]["bound_ms"],
         "bound_by": long_["long"]["bound_by"],
         "library_ms": long_["long"]["library_ms"],
         "launches_by_path": {
             "lm_fftconv_8192": mixer_runs[8192]["float32"]["counts"]["long"],
             "train_fftconv_4096": train_long["counts"]["long"]}},
        # launches: one ops.fft1d call at (262144, 816); [gaps]'s one
        # call per length beside it
        {"name": "fft_fourstep_dense", "route": "cuda",
         "source": DENSE_SOURCE, "path": "dense",
         "sources": [DENSE_SOURCE, KERNEL_SOURCE,
                     "src/repro_torch/kernels/dense.py"],
         "replaces": "src/repro/kernels/fft_matmul.py:216",
         "launches": long_["dense"]["launches"],
         "max_abs_err": long_["dense"]["max_abs_err"],
         "scaled_err": long_["dense"]["scaled_err"],
         "ms": long_["dense"]["ms"], "plain_ms": long_["dense"]["plain_ms"],
         "bound_ms": long_["dense"]["bound_ms"],
         "bound_by": long_["dense"]["bound_by"],
         "library_ms": long_["dense"]["library_ms"],
         "launches_by_path": {
             f"gaps_{r['dtype']}_{r['shape'][1]}": r["launches"]
             for r in gaps["lengths"]}},
        # launches: the mixer at S=16384, its main path (3 split calls of
        # 2 launches); timed at [split]'s (16384, 32768) complex64
        {"name": "fft_fourstep_split", "route": "cuda",
         "source": RADIX_SOURCE, "path": "split",
         "sources": [RADIX_SOURCE, LONG_SOURCE, SPLIT_SOURCE],
         "replaces": "src/repro/kernels/fft_matmul.py:216",
         "launches": mixer_runs[16384]["float32"]["counts"]["split"],
         "max_abs_err": split_["lengths"][0]["forward"]["max_abs_err"],
         "scaled_err": split_["lengths"][0]["forward"]["scaled_err"],
         "ms": split_["lengths"][0]["ms"],
         "plain_ms": split_["lengths"][0]["plain_ms"],
         "bound_ms": split_["lengths"][0]["bound_ms"],
         "bound_by": split_["lengths"][0]["bound_by"],
         "library_ms": split_["lengths"][0]["library_ms"],
         "launches_by_path": {
             "lm_fftconv_16384": mixer_runs[16384]["float32"]["counts"],
             "lm_fftconv_32768": mixer_runs[32768]["float32"]["counts"],
             "train_fftconv_16384": train_split["counts"]}},
        # launches: the 384^3 plan's forward ([mixed_plan], 3 per
        # direction); timed at (262144, 384) complex64
        {"name": "fft_fourstep_mixed", "route": "cuda",
         "source": RADIX_SOURCE, "path": "radix",
         "replaces": "src/repro/kernels/fft_matmul.py:216",
         "launches": mixed_plan["launches"],
         "max_abs_err": mixed["main"]["max_abs_err"],
         "scaled_err": mixed["main"]["scaled_err"],
         "ms": mixed["main"]["ms"], "plain_ms": mixed["main"]["plain_ms"],
         "bound_ms": mixed["main"]["bound_ms"],
         "bound_by": mixed["main"]["bound_by"],
         "library_ms": mixed["main"]["library_ms"],
         "launches_by_path": {
             "mixed_plan_inverse": mixed_plan["inverse_counts"]["radix"],
             "mixed_plan_poisson": mixed_plan["poisson_counts"]["radix"],
             "mixed_plan_448": mixed_plan7["forward_counts"]["radix"],
             "mixed_plan_416": mixed_plan13["forward_counts"]["radix"],
             "mixed_plan_360": mixed_plan45["forward_counts"]["radix"],
             "mixed_plan_600": mixed_plan75["forward_counts"]["radix"]}},
        # launches: [chirp]'s calls, one ops.fft1d call per length (no
        # LM path runs the chirp route now); timed at lines of 7424, the
        # source the kernel of its M's route
        {"name": "fft_fourstep_chirp", "route": "cuda",
         "source": CHIRP_ROUTE_SOURCE[chirp_["lengths"][0]["m_route"]],
         "path": "chirp",
         "functions": ["dense_chirp_kernel", "long_chirp_kernel",
                       "dense_column_chirp_kernel",
                       "split_fold_dense_kernel",
                       "split_transpose_keep_kernel"],
         "sources": [DENSE_SOURCE, LONG_SOURCE, KERNEL_SOURCE,
                     CHIRP_SOURCE, SPLIT_SOURCE],
         "replaces": "src/repro/kernels/fft_matmul.py:216",
         "launches": sum(r["counts"]["chirp"] for r in chirp_["lengths"]),
         "max_abs_err": chirp_["lengths"][0]["max_abs_err"],
         "scaled_err": chirp_["lengths"][0]["scaled_err"],
         "ms": chirp_["lengths"][0]["ms"],
         "plain_ms": chirp_["lengths"][0]["plain_ms"],
         "bound_ms": chirp_["lengths"][0]["bound_ms"],
         "bound_by": chirp_["lengths"][0]["bound_by"],
         "library_ms": chirp_["lengths"][0]["library_ms"],
         "launches_by_path": {
             "chirp_calls": sum(r["counts"]["chirp_calls"]
                                for r in chirp_["lengths"])}},
        # launches: the mixer at S=3072, its main path (3 long-line
        # launches); timed at [long_mixed]'s 512 MB of lines of 6144
        {"name": "fft_fourstep_long_mixed", "route": "cuda",
         "source": LONG_SOURCE, "path": "long",
         "replaces": "src/repro/kernels/fft_matmul.py:216",
         "launches": mixer_runs[3072]["float32"]["counts"]["long"],
         **_timing(long_mixed_6144),
         "launches_by_path": {
             "lm_fftconv_3072": mixer_runs[3072]["float32"]["counts"],
             "lm_fftconv_3584": mixer_runs[3584]["float32"]["counts"],
             "train_fftconv_3072": train_mixed["counts"],
             "mixed_long_plan_4320": face["forward_counts"]["long"]}},
        # launches: the mixer at S=2048 (lines of 4096), its main path (3
        # launches on the long route's wide kernel); timed at [mixed]'s 512
        # MB of lines of 2944 = 32 x 23 x 4
        {"name": "fft_fourstep_wide", "route": "cuda", "source": WIDE_SOURCE,
         "path": "long", "functions": ["wide_kernel"],
         "sources": [WIDE_SOURCE, KERNEL_SOURCE,
                     "src/repro_torch/kernels/longline.py"],
         "timed": {"dtype": "complex64", "shape": wide_2944["shape"]},
         "replaces": "src/repro/kernels/fft_matmul.py:216",
         "launches": mixer_runs[2048]["float32"]["counts"]["long"],
         **_timing(wide_2944),
         "launches_by_path": {
             "lm_fftconv_2048": mixer_runs[2048]["float32"]["counts"],
             "train_fftconv_2048": train_fftconv["counts"],
             "lm_sharded": lm_sharded["counts"],
             **{f"mixed_{r['dtype']}_{r['shape'][1]}": r["launches"]
                for r in mixed["lengths"] if r["path"] == "long"}}},
        # launches: the mixer at S=12288, its main path (3 split calls of
        # 2 launches); timed at [split_mixed]'s 512 MB of lines of 24576
        {"name": "fft_fourstep_split_mixed", "route": "cuda",
         "source": RADIX_SOURCE, "path": "split",
         "sources": [RADIX_SOURCE, LONG_SOURCE, SPLIT_SOURCE],
         "replaces": "src/repro/kernels/fft_matmul.py:216",
         "launches": mixer_runs[12288]["float32"]["counts"]["split"],
         **_timing(split_mixed["lengths"][0]),
         "launches_by_path": {
             "lm_fftconv_12288": mixer_runs[12288]["float32"]["counts"]}},
        # launches: [split_general]'s calls, one ops.fft1d call per length
        # (2 launches each: pass A, the dense rows with pass C folded in;
        # a nested plan's rows on the split route, pass C); timed at its
        # 256 MB of lines of 29106 = 378 x 77
        {"name": "fft_fourstep_split_general", "route": "cuda",
         "source": DENSE_SOURCE, "path": "split",
         "functions": ["dense_column_kernel", "split_fold_dense_kernel",
                       "split_transpose_any_kernel"],
         "sources": [DENSE_SOURCE, LONG_SOURCE, KERNEL_SOURCE,
                     SPLIT_SOURCE],
         "replaces": "src/repro/kernels/fft_matmul.py:216",
         "launches": sum(r["counts"]["split"]
                         for r in split_general["lengths"]),
         **_timing(split_general["lengths"][0]),
         "launches_by_path": {
             f"split_general_{r['dtype']}_{r['shape'][1]}": r["launches"]
             for r in split_general["lengths"]}},
        # launches: the split route's pass B on dense rows with pass C
        # folded in, on [split_general]'s and [chirp]'s calls (one
        # ops.fft1d call per length); timed alone at [split_general]'s 512
        # MB of lines of 10^7 = 1600 x 6250 complex64
        {"name": "split_fold_dense", "route": "cuda",
         "source": DENSE_SOURCE, "path": "split",
         "functions": ["split_fold_dense_kernel"],
         "sources": [DENSE_SOURCE, LONG_SOURCE, KERNEL_SOURCE,
                     SPLIT_SOURCE],
         "replaces": "src/repro/kernels/fft_matmul.py:216",
         "launches": sum(r["counts"]["fold_dense"]
                         for phase in (split_general, chirp_)
                         for r in phase["lengths"]),
         "timed": {"dtype": fold_dense_rec["dtype"],
                   "shape": fold_dense_rec["shape"]},
         **_fold_timing(fold_dense_rec),
         "launches_by_path": {
             f"{phase}_{r['dtype']}_{r['shape'][1]}": r["counts"][
                 "fold_dense"]
             for phase, runs in (("split_general", split_general),
                                 ("chirp", chirp_))
             for r in runs["lengths"] if r["counts"]["fold_dense"]}},
        # launches: the split route's pass B on long-line rows with pass C
        # folded in, on [split]'s and [split_mixed]'s calls; timed alone at
        # [split]'s 512 MB of lines of 2^24 = 1024 x 16384 complex64
        {"name": "split_fold_long", "route": "cuda", "source": LONG_SOURCE,
         "path": "split",
         "functions": ["split_fold_long_kernel", "split_fold_mixed_kernel"],
         "sources": [LONG_SOURCE, KERNEL_SOURCE, SPLIT_SOURCE],
         "replaces": "src/repro/kernels/fft_matmul.py:216",
         "launches": sum(r[k]["counts"]["fold_long"]
                         for r in split_["lengths"]
                         for k in ("forward", "inverse"))
                     + sum(r["counts"]["fold_long"]
                           for r in split_mixed["lengths"]),
         "timed": {"dtype": fold_long_rec["dtype"],
                   "shape": fold_long_rec["shape"]},
         **_fold_timing(fold_long_rec),
         "launches_by_path": {
             **{f"split_{r['dtype']}_{r['shape'][1]}": r["forward"][
                 "counts"]["fold_long"] for r in split_["lengths"]},
             **{f"split_mixed_{r['dtype']}_{r['shape'][1]}": r["counts"][
                 "fold_long"] for r in split_mixed["lengths"]
                if r["counts"]["fold_long"]}}},
    ]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']}: launched no time on its "
              f"main path")
    report["kernels"] = kernels
    report["seconds"] = timer() - t0
    report["phase_seconds"] = laps
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print("[twiddle] the DCT-II stage's kernel at (262144, 512): "
          + json.dumps(tw))
    print("[phases] seconds: " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in laps.items()))
    print(f"[done] {report['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
