"""The split route of the four-step kernel: lines longer than one block
holds, as a two-level four-step through HBM.

A line of N = P*Q (:data:`FACTORS`: the measured table, :data:`_TABLE`,
of the powers of two, complex64 N from 32768 to 2^24 and complex128 from
16384 to 2^22, and the mixed lengths r*2^k, r in ``radix.EVERY_ROUTE_ODD``
= {3, 5, 7, 9, 11, 13, 15, 17, 19, 21, 23, 25, 27}, past the long-line
route's up to the same limits; then a rule, :func:`rule_factors`, for
every other N up to those limits that is 13-smooth or r*2^k, r in
``radix.WIDE_ODD``, that no other route takes and whose Q a radix or
long-line row holds, 23*2^k among them; P a power of two, a mixed N's odd
part in Q, so the odd codelets run in pass B; then the general plans,
:func:`general_factors`, for every other 13-smooth N past one block up to
those limits) is viewed as (P, Q), x[p*Q + q], and transformed by the
routes one block holds, in two launches (more where a nested plan's rows
run their own launch on another route):

* pass A — the P-long DFT down every column q (stride Q): the radix
  route's strided entry on the ``(B, P, Q)`` block (outer = B, N = P,
  inner = Q), whose store multiplies by the inter-step twiddle
  W_N^(kp*q) (``fft_radix.cuh``, ``kRadixSplitA``) and writes the
  same ``(B, P, Q)`` layout;
* pass B — the Q-long DFT of every contiguous row (b, kp).  On the radix
  route (Q up to 2048 complex64, 1024 complex128; the rule's to
  :data:`ROW_MAX`) it is stored transposed at out[b, kp + P*kq], the line's
  output index, with the line's own epilogues on that store: the output
  twiddle (N,), the inverse's 1/N (once, for the whole line) and the
  ``pack_parts`` segment store.  A tile holds L consecutive rows in the
  layout (k1, l, m2) with a row pitch of Q2 + 1, and the row pass runs its
  threads along l, so a warp stores L consecutive kp (``kRadixSplitB``).
* On the long-line route (Q of ``longline.FACTORS``, one mixed factor or
  two) and on the dense route's stages (the general plans, below; a
  nested plan's or a chirp's M whose rows take the dense route) a block
  holds one row or a few, so its stores alone cannot make runs of
  consecutive kp: stored straight to kp + P*kq from one-row blocks they
  took 2.5 times as long at 2^24 (3.8 ms against 1.5; PERF.md), which is
  why a third launch, pass C, transposed the rows once more through HBM.
  Pass B now stores them transposed itself, through a thread-block
  cluster (:func:`fold_layout`): C blocks on neighbouring SMs transform C
  consecutive rows kp (L rows a block where the dense plan holds several,
  C = 1 where L rows already make runs of :data:`FOLD_RUN_BYTES`), keep
  them in shared memory, and after a cluster barrier each block reads its
  share of kq of all of them through distributed shared memory and stores
  runs of C*L consecutive outputs with the line's epilogues
  (``fft_long.cuh``'s ``split_fold_store``: ``split_fold_long_kernel`` and
  ``split_fold_mixed_kernel`` on the long-line route's bodies,
  ``fft_dense.cuh``'s ``split_fold_dense_kernel`` on the dense route's
  stages; :func:`fold_emulate` is their plain version).  Two launches.
* The general plans (odd N, N with too few factors of 2 for a P of
  :data:`COLUMN_SIZES`, Q on no radix or long-line row) put pass B on the
  dense route's stages (rows of any 13-smooth Q that fits one block);
  pass A stays on the radix route where N has a P of
  :data:`COLUMN_SIZES` (its tables within :data:`TABLE_MAX_BYTES`), else
  runs on the dense kernel's column form (``dense_column_kernel``: a tile
  of 16, 8 or 4 consecutive columns of any 13-smooth P, its inter-step
  twiddle W_N^e = WA[e mod W] * WB[e div W], W = 2^w_log2 >= sqrt(N)).
  The dense kernel's chain is run-time data, so no length adds an
  instantiation.
* Rows that the folded kernels do not take keep pass C (row path "any":
  their own launch in natural order, then ``split_transpose_any``: any P
  and Q, bounds-checked 32 x 32 tiles, the epilogues, the inverse's 1/P):
  a nested plan's rows on another route (the radix, long-line or split
  route), and dense rows too long for a slot and the cluster's tile in
  one block (a general plan's Q past about 14000 complex64 and 7000
  complex128, a nested plan's or a chirp's M past them).

The inter-step twiddle would be an N-entry table (128 MB at N = 2^24 in
complex64); it is TA[kp, ql] * TB[kp, qh] with q = qh*QL + ql, QL a power
of two that divides Q (:attr:`SplitPlan.ql`), two tables of P*QL and P*QH
entries built in float64 (:func:`constants`, one rounding per entry) and
read through L2.

:func:`emulate` runs exactly these passes and index maps in torch, through
``radix.emulate``, ``longline.emulate`` and ``dense``'s stages with the
same modes, :func:`fold_emulate` and :func:`transpose_emulate`; it is the
route's plain version
(``fft_matmul.fft_fourstep_plain`` takes it for these N), and the CPU
tests hold it against ``np.fft`` and the JAX package's kernel
(``dense.emulate`` and its ``columns=`` mode for the general plans).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from . import dense, longline, radix

#: The powers of two's (P, Q) per complex dtype, picked by measurement on
#: an H100 among every (P, Q) the kernel could run, at 512 MB of lines
#: (PERF.md has the readings).  P runs on the strided radix
#: entry (to 1024 complex64, 512 complex128: ``fft_matmul.
#: strided_supported``), Q on the radix route (to 2048 / 1024) or the
#: long-line route (``longline.FACTORS``, with the transpose pass).  What
#: the readings showed: P of 128 to 512 mostly; rows of 4096 on the radix
#: route are slow (a tile holds 2 rows, so pass B stores 16-byte runs:
#: about twice the time), so the longest lengths put their rows on the
#: long-line route; the longest have one choice.
_POW2 = {
    torch.complex64: {
        1 << 15: (256, 128), 1 << 16: (256, 256), 1 << 17: (256, 512),
        1 << 18: (256, 1024), 1 << 19: (256, 2048), 1 << 20: (512, 2048),
        1 << 21: (1024, 2048), 1 << 22: (512, 8192),
        1 << 23: (512, 16384), 1 << 24: (1024, 16384)},
    torch.complex128: {
        1 << 14: (64, 256), 1 << 15: (128, 256), 1 << 16: (128, 512),
        1 << 17: (256, 512), 1 << 18: (256, 1024), 1 << 19: (64, 8192),
        1 << 20: (128, 8192), 1 << 21: (256, 8192),
        1 << 22: (512, 8192)},
}
#: The mixed lengths r*2^k, per odd part r, shortest first, picked once by
#: measurement on an H100 among the (P, Q) the kernel instantiates, at 512
#: MB of lines (PERF.md has the readings): P of 256 or 512 complex64 and
#: 64 to 512 complex128 mostly, Q on the radix route up to 1920 complex64
#: and 960 complex128, the longest with their rows on the long-line route.
#: 11*2^11 complex64 is 512 x 44: pass B of 88 = 8x11 spills in ptxas.
#: Pass B of 208 = 13x16 complex64 is clean though its plain kernel
#: spills (``radix.RADIX_SIZES``), so Q need not be a radix-route length.
#: 21*2^k, 25*2^k and 27*2^k follow the 7*2^k rows' P (not probed);
#: 17*2^k and 19*2^k the 13*2^k rows' P and route of Q (not probed).
_MIXED = {
    torch.complex64: (
        (256, 96), (256, 192), (256, 384), (512, 384), (256, 1536),
        (512, 1536), (1024, 1536), (512, 6144), (512, 12288), (1024, 12288),
        (256, 80), (256, 160), (512, 160), (256, 640), (512, 640),
        (512, 1280), (1024, 1280), (512, 5120), (512, 10240), (1024, 10240),
        (256, 72), (256, 144), (512, 144), (256, 576), (512, 576),
        (512, 1152), (1024, 1152), (512, 4608), (1024, 4608), (1024, 9216),
        (256, 120), (256, 240), (256, 480), (256, 960), (512, 960),
        (512, 1920), (1024, 1920), (512, 7680), (1024, 7680),
        (1024, 15360),
        (256, 112), (256, 224), (256, 448), (512, 448), (512, 896),
        (512, 1792), (1024, 1792), (512, 7168), (512, 14336),
        (1024, 14336),
        (512, 44), (256, 176), (512, 176), (256, 704), (512, 704),
        (512, 1408), (1024, 1408), (512, 5632), (512, 11264),
        (1024, 11264),
        (256, 104), (256, 208), (256, 416), (256, 832), (512, 832),
        (512, 1664), (256, 6656), (512, 6656), (512, 13312),
        (1024, 13312),
        (256, 84), (256, 168), (256, 336), (512, 336), (512, 672),
        (512, 1344), (1024, 1344), (512, 5376), (512, 10752),
        (1024, 10752),
        (256, 100), (256, 200), (256, 400), (512, 400), (512, 800),
        (512, 1600), (1024, 1600), (512, 6400), (512, 12800),
        (1024, 12800),
        (256, 108), (256, 216), (256, 432), (512, 432), (512, 864),
        (512, 1728), (1024, 1728), (512, 6912), (512, 13824),
        (1024, 13824),
        (256, 68), (256, 136), (256, 272), (256, 544), (512, 544),
        (512, 1088), (1024, 1088), (512, 4352), (512, 8704), (1024, 8704),
        (256, 76), (256, 152), (256, 304), (256, 608), (512, 608),
        (512, 1216), (1024, 1216), (512, 4864), (512, 9728),
        (1024, 9728)),
    torch.complex128: (
        (64, 192), (128, 192), (64, 768), (128, 768), (256, 768),
        (512, 768), (128, 6144), (256, 6144), (512, 6144),
        (64, 160), (128, 160), (64, 640), (128, 640), (256, 640),
        (512, 640), (128, 5120), (256, 5120), (512, 5120),
        (64, 144), (128, 144), (256, 144), (128, 576), (256, 576),
        (512, 576), (256, 2304), (256, 4608), (512, 4608),
        (64, 240), (128, 240), (128, 480), (256, 480), (256, 960),
        (512, 960), (512, 1920), (512, 3840), (512, 7680),
        (64, 224), (128, 224), (128, 448), (256, 448), (256, 896),
        (64, 7168), (256, 3584), (512, 3584), (512, 7168),
        (64, 176), (128, 176), (64, 704), (128, 704), (256, 704),
        (512, 704), (128, 5632), (256, 5632), (512, 5632),
        (64, 208), (128, 208), (256, 208), (256, 416), (256, 832),
        (64, 6656), (128, 6656), (256, 6656), (512, 6656),
        (64, 168), (128, 168), (128, 336), (256, 336), (256, 672),
        (64, 5376), (256, 2688), (512, 2688), (512, 5376),
        (64, 200), (128, 200), (128, 400), (256, 400), (256, 800),
        (64, 6400), (256, 3200), (512, 3200), (512, 6400),
        (64, 216), (128, 216), (128, 432), (256, 432), (256, 864),
        (64, 6912), (256, 3456), (512, 3456), (512, 6912),
        (64, 136), (128, 136), (256, 136), (256, 272), (256, 544),
        (64, 4352), (128, 4352), (256, 4352), (512, 4352),
        (64, 152), (128, 152), (256, 152), (256, 304), (256, 608),
        (64, 4864), (128, 4864), (256, 4864), (512, 4864)),
}
#: (P, Q) per length and complex dtype: both measured tables.
_TABLE = {dtype: {**_POW2[dtype], **{p * q: (p, q) for p, q in pairs}}
          for dtype, pairs in _MIXED.items()}


#: Pass A's lengths, each instantiated by the kernel (``fft_radix.cuh``'s
#: ``radix_dispatch`` for ``kRadixSplitA``): the P of every plan.
COLUMN_SIZES = {torch.complex64: (256, 512, 1024),
                torch.complex128: (64, 128, 256, 512)}
#: The longest line per complex dtype: 2^24 complex64 and 2^22 complex128
#: (128 MB and 64 MB), the powers of two's own limit.
LIMIT = {dtype: max(_POW2[dtype]) for dtype in _POW2}
#: The longest Q the rule puts on the radix route, per complex dtype: the
#: measured table's longest radix rows (1920 = 40 x 48 complex64, 960 =
#: 30 x 32 complex128).
ROW_MAX = {torch.complex64: 1920, torch.complex128: 960}
#: The longest Q the rule prefers on radix rows: an H100 sweep of every
#: instantiated (P, Q) at 41 rule lengths (``scripts/route_times.py split``
#: and ``splitcheck``; PERF.md §6) read Q past 1024 on P = 256 (tiles of 4
#: to 8 rows, short stores) and P = 1024 (pass A's tile alone on its SM)
#: 11-16% slower than P = 512 with Q half as long.
ROW_SHORT = 1024
#: The P of long-line rows the rule tries, in order, per complex dtype:
#: the measured table's (512 before 1024 and 256 for complex64; the
#: least first for complex128).
LONG_P = {torch.complex64: (512, 1024, 256),
          torch.complex128: (64, 128, 256, 512)}


def _radix_rows(dtype: torch.dtype) -> frozenset:
    """Q that the rule may put on the radix route: radix-route lengths up
    to :data:`ROW_MAX`."""
    return frozenset(q for q in radix.RADIX_SIZES[dtype]
                     if q <= ROW_MAX[dtype])


def _long_rows(dtype: torch.dtype) -> frozenset:
    """Q that the rule may put on the long-line route: its lengths that
    pass C's 32 x 32 tiles take (a multiple of 32)."""
    return frozenset(q for q in longline.FACTORS[dtype] if q % 32 == 0)


def rule_factors(n: int, dtype: torch.dtype) -> Optional[tuple]:
    """(P, Q) with N = P*Q, P in :data:`COLUMN_SIZES`: on a radix row
    (:func:`_radix_rows`, its tile's rows dividing P) the least P below
    the largest whose Q is at most :data:`ROW_SHORT`, else the least P;
    with no radix row, the first P of :data:`LONG_P` whose Q is a
    long-line row (:func:`_long_rows`); None where there is none."""
    rows, top = _radix_rows(dtype), max(COLUMN_SIZES[dtype])
    fits = [(p, n // p) for p in COLUMN_SIZES[dtype]
            if n % p == 0 and n // p in rows and p % radix.radix_tile(
                n // p, dtype.itemsize, False, False).lines == 0]
    if fits:
        return min(fits, key=lambda pq: (pq[1] > ROW_SHORT or pq[0] == top,
                                         pq[0]))
    rows = _long_rows(dtype)
    for p in LONG_P[dtype]:
        if n % p == 0 and n // p in rows:
            return p, n // p
    return None


def _rule(dtype: torch.dtype) -> dict:
    """The rule's lengths: every N = P*Q up to :data:`LIMIT` that
    :func:`rule_factors` splits and no other route takes (the radix and
    long-line routes' lengths, :data:`_TABLE`'s, and the 13-smooth lines
    of one block that ``dense.takes``), with their (P, Q).  Q's odd part
    is N's, so N is 13-smooth or r*2^k with r in ``radix.WIDE_ODD``."""
    from .dense import takes as dense_takes    # dense imports chirp
    rows = _radix_rows(dtype) | _long_rows(dtype)
    taken = (set(radix.RADIX_SIZES[dtype]) | set(longline.FACTORS[dtype])
             | set(_TABLE[dtype]))
    out = {}
    for n in sorted({p * q for p in COLUMN_SIZES[dtype] for q in rows}):
        if n > LIMIT[dtype] or n in taken or dense_takes(n, dtype):
            continue
        factors = rule_factors(n, dtype)
        if factors is not None:
            out[n] = factors
    return out


#: (P, Q) per length and complex dtype (``radix.kernel_path`` reads this
#: table): :data:`_TABLE`, then the rule's (:func:`_rule`).  Every other
#: 13-smooth N past one block takes :func:`general_factors`' plan.
FACTORS = {dtype: {**table, **_rule(dtype)} for dtype, table in _TABLE.items()}
#: Pass B's lengths on the radix route, each instantiated by the kernel
#: (``radix_dispatch`` for ``kRadixSplitB``).  Q on the long-line route
#: takes ``longline.FACTORS``'s lengths.
ROW_SIZES = {dtype: tuple(sorted({q for _, q in table.values()
                                  if q not in longline.FACTORS[dtype]}))
             for dtype, table in FACTORS.items()}


#: The largest inter-step twiddle tables (P*(QL + QH) entries) that the
#: general rule gives a radix pass A: at an odd Q (QL = 1) they hold N
#: entries, so past this they would no longer sit in L2 beside the lines
#: (:func:`rule_factors`' largest are 8 MB, and its sweep read them no
#: slower).
TABLE_MAX_BYTES = 8 << 20


def _divisors(n: int) -> list:
    """The divisors of a 13-smooth ``n``, ascending."""
    out = [1]
    for p in (2, 3, 5, 7, 11, 13):
        k = 0
        while n % p == 0:
            n //= p
            k += 1
        out = [d * p ** e for d in out for e in range(k + 1)]
    return sorted(out)


@functools.lru_cache(maxsize=None)
def _row_fits(q: int, dtype: torch.dtype) -> bool:
    """Whether the dense kernel takes rows of ``q`` (13-smooth, one row
    and its tables in one block) for pass B of a general plan."""
    return q >= 2 and radix.smooth(q) and dense.fits(q, dtype)


def general_candidates(n: int, dtype: torch.dtype) -> list:
    """Every (P, Q, column route) of a general plan for a 13-smooth N:
    pass B on dense rows of Q (:func:`_row_fits`), pass A on the radix
    route at a P of :data:`COLUMN_SIZES` (its inter-step tables within
    :data:`TABLE_MAX_BYTES`) or on the dense kernel at any P whose column
    tile fits (``dense.column_plan``); ascending P, radix before dense."""
    out = []
    for p in COLUMN_SIZES[dtype]:
        if n % p == 0 and _row_fits(n // p, dtype):
            plan = SplitPlan(n, p, n // p, "dense")
            if plan.const_elems * dtype.itemsize <= TABLE_MAX_BYTES:
                out.append((p, n // p, "radix"))
    for p in _divisors(n):
        if _row_fits(n // p, dtype) and dense.column_plan(p, dtype):
            out.append((p, n // p, "dense"))
    return out


#: The general rule's P on the dense kernel's columns (the candidate
#: nearest it, in ratio) and the longest Q it prefers on the dense
#: kernel's rows, per complex dtype.  An H100 sweep of every candidate
#: family forced on the same lines (``scripts/route_times.py splitgen``:
#: 40 lengths, up to 14 dense and every radix pass A each; PERF.md §6)
#: read the best dense P at 150 to 700 (complex128 half complex64's)
#: while Q stays at or below about 7500 complex64 (rows past it: 10-30%
#: slower), small P far slower (P = 2: 8.4 ms against 0.79), and the
#: radix pass A at its least P, where it ran, level with or ahead of every
#: dense one.  With pass C folded into the rows (``split_fold_dense_kernel``)
#: the rule's pick under eight (P, longest Q) pairs, forced on the sweep's
#: lengths (``generalrules``), read complex128 rows of at most 1750 ahead
#: (geometric mean 0.881 of the three passes' time against 0.928 at 3750;
#: the held-out lengths 0.901 against 0.938) and complex64 best at 7500.
GENERAL_P = {torch.complex64: 400, torch.complex128: 200}
GENERAL_Q_MAX = {torch.complex64: 7500, torch.complex128: 1750}


@functools.lru_cache(maxsize=None)
def general_factors(n: int, dtype: torch.dtype) -> Optional[tuple]:
    """(P, Q, column route) of the general rule: every 13-smooth N up to
    :data:`LIMIT` that no other route takes (the radix and long-line
    routes' lengths, :data:`FACTORS`', and the lines of one block that
    ``dense.takes``), on dense rows (pass B on the dense kernel, then pass
    C).  Of the candidates (:func:`general_candidates`): a radix pass A
    where there is one, at its least P whose Q is at most
    :data:`GENERAL_Q_MAX`, else at its shortest Q; else the dense P whose
    Q is at most that nearest :data:`GENERAL_P` in ratio (the less of two
    as near), else the shortest Q.  None where N is not such a length or
    has no plan."""
    if (dtype not in LIMIT or n > LIMIT[dtype] or not radix.smooth(n)
            or n in FACTORS[dtype] or n in longline.FACTORS[dtype]
            or n in radix.RADIX_SIZES[dtype] or dense.takes(n, dtype)):
        return None
    cands = general_candidates(n, dtype)
    if not cands:
        return None
    qmax, target = GENERAL_Q_MAX[dtype], GENERAL_P[dtype]
    family = [c for c in cands if c[2] == "radix"] or cands
    fits = [c for c in family if c[1] <= qmax]
    if not fits:
        return min(family, key=lambda c: c[1])
    if family[0][2] == "radix":
        return fits[0]
    return min(fits, key=lambda c: (abs(math.log(c[0] / target)), c[0]))


#: The longest line any route takes, per complex dtype: a line's offsets
#: in the kernels are 32-bit ints, and the chirp route's M, at least 2N -
#: 1, stays within :data:`LINE_MAX`.
MAX_LENGTH = 1 << 30
#: The longest line the kernels index (their line offsets are ``int``).
LINE_MAX = (1 << 31) - 1
#: The nested plans' P (``nested_factors``): the candidate nearest it, in
#: ratio, with a radix pass A, or where no candidate's rows fit one block
#: (rows on the split route one level down).  An H100 sweep of the
#: candidates forced on the same lines (``scripts/route_times.py nested``,
#: 10 lengths; PERF.md §6) read a radix pass A ahead of every dense one
#: where it ran (c64 2^25 256 x 131072 1.70 ms against 2048 x 16384
#: 1.86), and rows of one block ahead of rows on the split route.
NESTED_P = {torch.complex64: 400, torch.complex128: 200}
#: The nested plans' P where the rows fit one block and no radix pass A
#: runs: the candidate nearest it in ratio.  The sweep and its held-out
#: lengths read a longer column and shorter rows faster up to about it
#: (c64 2*3^12*16 2916 x 5832 1.60 ms against 864 x 19683 2.38; c128
#: 2*3^14 2187 x 4374 2.22 against 729 x 13122 2.43) and a longer column
#: past it slower (c64 3^16 6561 x 6561 2.21 against 2187 x 19683 1.96;
#: 10^8 6400 x 15625 5.03 against 4000 x 25000 4.08).
NESTED_ONE_P = {torch.complex64: 2500, torch.complex128: 1500}


def smooth_divisors(n: int) -> list:
    """The divisors of ``n``'s 13-smooth part, ascending."""
    m = n
    for p in (2, 3, 5, 7, 11, 13):
        while m % p == 0:
            m //= p
    return _divisors(n // m)


@functools.lru_cache(maxsize=1 << 16)
def row_route(q: int, dtype: torch.dtype) -> Optional[str]:
    """The route of rows of ``q`` up to :data:`LIMIT`, as
    ``radix.kernel_path`` names it, but None where that is the chirp (a
    nested plan's rows never are): worked out from the routes' tables and
    ``dense.takes`` alone, so that a plan asks it of many Q cheaply."""
    if q in radix.RADIX_SIZES[dtype]:
        return "radix"
    if q in longline.FACTORS[dtype]:
        return "long"
    if q in FACTORS[dtype]:
        return "split"
    if radix.smooth(q):
        # the general plans take every 13-smooth N past one block
        return "dense" if dense.takes(q, dtype) else "split"
    return "dense" if dense.takes(q, dtype) else None


def any_candidates(n: int, dtype: torch.dtype, *, limit: int = None,
                   dense_only: bool = False) -> list:
    """Every (P, Q, pass A's route) of a plan whose rows run on any route:
    P a 13-smooth divisor of N on a column pass (the radix route at a P of
    :data:`COLUMN_SIZES` whose inter-step tables fit
    :data:`TABLE_MAX_BYTES`, unless ``dense_only``; the dense kernel's
    column form where ``dense.column_plan`` fits), Q = N/P up to ``limit``
    (:data:`LIMIT`) on a route other than the chirp (:func:`row_route`);
    ascending P, radix before dense."""
    lim = LIMIT[dtype] if limit is None else limit
    out = []
    for p in smooth_divisors(n):
        q = n // p
        if p < 2 or q < 2 or q > lim:
            continue
        cols = []
        if not dense_only and p in COLUMN_SIZES[dtype]:
            plan = SplitPlan(n, p, q, "any")
            if plan.const_elems * dtype.itemsize <= TABLE_MAX_BYTES:
                cols.append("radix")
        if dense.column_plan(p, dtype):
            cols.append("dense")
        if cols and row_route(q, dtype) is not None:
            out.extend((p, q, col) for col in cols)
    return out


def _family(cands: list, dtype: torch.dtype) -> list:
    """The candidates a plan with rows on any route picks among: those
    with a radix pass A, else those whose rows fit one block (their route
    is not the split route), else all."""
    return ([c for c in cands if c[2] == "radix"]
            or [c for c in cands if row_route(c[1], dtype) != "split"]
            or cands)


def _nearest(family: list, target: int) -> tuple:
    """The candidate whose P is nearest ``target`` in ratio, the less of
    two as near."""
    return min(family, key=lambda c: (abs(math.log(c[0] / target)), c[0]))


def any_factors(n: int, dtype: torch.dtype, *, limit: int = None,
                dense_only: bool = False) -> Optional[tuple]:
    """(P, Q, pass A's route) of a plan with rows on any route
    (:func:`any_candidates`): of :func:`_family`, the P nearest
    :data:`NESTED_P`.  None where there is none."""
    family = _family(any_candidates(n, dtype, limit=limit,
                                    dense_only=dense_only), dtype)
    return _nearest(family, NESTED_P[dtype]) if family else None


@functools.lru_cache(maxsize=1 << 16)
def nested_factors(n: int, dtype: torch.dtype) -> Optional[tuple]:
    """(P, Q, pass A's route) of the nested plans: every N past
    :data:`LIMIT` up to :data:`MAX_LENGTH` with a plan of
    :func:`any_candidates` (rows of Q on any route but the chirp, one
    level of nesting where Q runs on the split route itself): of
    :func:`_family`, the P nearest :data:`NESTED_ONE_P` where the family
    is rows of one block with a dense pass A, else nearest
    :data:`NESTED_P`.  None elsewhere."""
    if dtype not in LIMIT or not LIMIT[dtype] < n <= MAX_LENGTH:
        return None
    family = _family(any_candidates(n, dtype), dtype)
    if not family:
        return None
    one = family[0][2] != "radix" and row_route(family[0][1], dtype) != "split"
    return _nearest(family, (NESTED_ONE_P if one else NESTED_P)[dtype])


def takes(n: int, dtype: torch.dtype) -> bool:
    """Whether the split route takes lines of ``n``: :data:`FACTORS`'
    lengths, the general rule's (:func:`general_factors`) and past
    :data:`LIMIT` the nested plans' (:func:`nested_factors`)."""
    return (n in FACTORS.get(dtype, {})
            or general_factors(n, dtype) is not None
            or nested_factors(n, dtype) is not None)


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    n: int
    p: int              # pass A's length (columns)
    q: int              # pass B's length (rows)
    row_path: str       # "radix", "long", "dense" or "any": pass B's
    #                     route ("dense": the dense stages with pass C
    #                     folded in; "any": the rows' own launch, any
    #                     route, then pass C)
    col_path: str = "radix"     # "radix" or "dense": pass A's route

    @property
    def p_log2(self) -> int:
        return self.p.bit_length() - 1

    @property
    def ql_log2(self) -> int:
        """log2 of QL, the low factor of q in the twiddle tables: a power
        of two that divides Q, about its square root (half of Q's bits,
        rounded up, for a power of two)."""
        twos = (self.q & -self.q).bit_length() - 1
        return min(twos, self.q.bit_length() // 2)

    @property
    def ql(self) -> int:
        return 1 << self.ql_log2

    @property
    def qh(self) -> int:
        return self.q >> self.ql_log2

    @property
    def const_elems(self) -> int:
        """TA (P x QL) then TB (P x QH); on a dense pass A, WA (2^w_log2)
        then WB (N / 2^w_log2, rounded up)."""
        if self.col_path == "dense":
            return (1 << self.w_log2) + -(-self.n >> self.w_log2)
        return self.p * (self.ql + self.qh)

    @property
    def w_log2(self) -> int:
        """log2 of W, WA's length on a dense pass A: W >= sqrt(N)."""
        return ((self.n - 1).bit_length() + 1) // 2


def split_plan(n: int, dtype: torch.dtype) -> SplitPlan:
    """The plan of a length the split route takes, with its (P, Q) from
    :data:`FACTORS` (the measured table's, else the rule's), else the
    general rule's (:func:`general_factors`), else the nested plans'
    (:func:`nested_factors`)."""
    factors = FACTORS.get(dtype, {}).get(n)
    if factors is not None:
        p, q = factors
        row_path = "long" if q in longline.FACTORS[dtype] else "radix"
        return SplitPlan(n, p, q, row_path)
    general = general_factors(n, dtype)
    if general is not None:
        # dense rows with pass C folded in, or, where a row and its tile do
        # not fit one block, the rows' own launch and pass C
        p, q, col_path = general
        plan = SplitPlan(n, p, q, "dense", col_path)
        if fold_layout(plan, dtype) is None:
            plan = SplitPlan(n, p, q, "any", col_path)
        return plan
    nested = nested_factors(n, dtype)
    if nested is None:
        raise ValueError(
            f"the split route takes N in split.FACTORS "
            f"({len(FACTORS.get(dtype, {}))} lengths up to "
            f"{LIMIT.get(dtype)} for {dtype}: the measured table's and "
            f"rule_factors'), every other 13-smooth N past one block up "
            f"to that limit (general_factors) and past it every N up to "
            f"{MAX_LENGTH} with a 13-smooth P on a column pass and rows "
            f"on a route other than the chirp (nested_factors), got {n}")
    p, q, col_path = nested
    return SplitPlan(n, p, q, "any", col_path)


#: The bytes of one run of pass B's transposed store that a cluster's
#: group of rows makes (C*L rows of one line, C*L consecutive outputs),
#: per kind of row and complex dtype: on long-line rows, one a block, C =
#: 8 complex64 (64 bytes) and 2 complex128 (32 bytes), which an H100 sweep
#: of C forced on the same lines read fastest (``scripts/route_times.py
#: splitfold``: complex128 2^22 and 23, 25, 27*2^17 at C = 2 1-10% ahead
#: of C = 4, complex64 2^24 at C = 8 3% ahead of C = 4); on dense rows C*L
#: rows of 64 and 32 bytes (complex64 C = 8 ahead of 4 over four lengths,
#: complex128 2278125 at C = 2 5% ahead of 4; PERF.md §6).
FOLD_RUN_BYTES = {"long": {torch.complex64: 64, torch.complex128: 32},
                  "dense": {torch.complex64: 64, torch.complex128: 32}}
#: The ring of pass B's folded kernel on dense rows where a block stores
#: its own rows (C = 1): two slots where they fit one block's shared
#: memory, so that a group's rows land while the one before is stored;
#: else one.  Where C > 1 the block's one slot is free again once its
#: rows are pushed into the tiles.
FOLD_DEPTH = 2
#: The Q of long-line rows that the split route's plans run
#: (``fft_long.cuh``'s ``split_fold_part`` instantiates each).
FOLD_LONG_ROWS = {dtype: tuple(sorted({q for _, q in table.values()
                                       if q in longline.FACTORS[dtype]}))
                  for dtype, table in FACTORS.items()}


@dataclasses.dataclass(frozen=True)
class FoldLayout:
    rows: str           # "dense" (split_fold_dense_kernel) or "long"
    cluster: int        # C: blocks of a cluster, one group of rows
    lines: int          # L: consecutive rows a block holds
    depth: int          # slots of the ring
    slot_elems: int     # values of one slot (dense rows)
    smem_bytes: int
    threads: int        # the block's threads (dense rows; the long
    #                     kernels' are their own)
    tile_pitch: int = 0  # dense rows, C > 1: the row pitch of the owners'
    #                      tiles they are pushed into (odd, at least the
    #                      share)

    @property
    def group(self) -> int:
        """Consecutive rows kp of one line that a cluster stores at once."""
        return self.cluster * self.lines


def _dense_rows(plan: SplitPlan, dtype: torch.dtype) -> bool:
    """Whether pass B runs on the dense route's stages: a general plan's
    rows, or those of a nested plan or a chirp's M that take the dense
    route."""
    return plan.row_path == "dense" or (
        plan.row_path == "any" and row_route(plan.q, dtype) == "dense")


@functools.lru_cache(maxsize=1 << 12)
def fold_layout(plan: SplitPlan, dtype: torch.dtype) -> Optional[FoldLayout]:
    """Pass B with pass C folded in, where the plan's rows take it: on
    long-line rows (``fft_long.cuh``'s ``split_fold_long_kernel``,
    ``split_fold_mixed_kernel``: a cluster of C rows, one a block, the
    long kernel's own layout, C = :data:`FOLD_RUN_BYTES` / itemsize, which
    divides P) and on the dense route's stages at a 13-smooth Q
    (``fft_dense.cuh``'s ``split_fold_dense_kernel``: L = the dense plan's
    lines of Q a block, C = the run's rows over L, at least 1; the tables
    of ``dense.DensePlan``, then the ring's slots of L rows and 16 bytes
    each: where C = 1 :data:`FOLD_DEPTH` slots, or 1 where two do not
    fit; where C > 1 one slot and the tile of G rows at an odd pitch of
    at least ceil(Q/C) that the cluster's blocks push their rows into; an
    mbarrier per slot).  None where the rows keep pass C: radix rows
    (their own pass B stores transposed), a nested plan's rows on another
    route, dense rows with a generic stage or whose slot (and tile) do
    not fit one block."""
    if plan.row_path == "long":
        tile = longline.long_tile(plan.q, dtype)
        run = FOLD_RUN_BYTES["long"][dtype] // dtype.itemsize
        return FoldLayout("long", min(run, plan.p), 1, tile.depth, 0,
                          tile.smem_bytes, 0)
    if not _dense_rows(plan, dtype):
        return None
    rows = dense.dense_plan(plan.q, dtype)
    if rows.generic:
        return None
    run = FOLD_RUN_BYTES["dense"][dtype] // dtype.itemsize
    cluster = max(1, run // rows.lines)
    for depth in ((1,) if cluster > 1 else (FOLD_DEPTH, 1)):
        layout = dense_fold(plan, dtype, cluster, depth)
        if layout is not None:
            return layout
    return None


def dense_fold(plan: SplitPlan, dtype: torch.dtype, cluster: int,
               depth: int) -> Optional[FoldLayout]:
    """The folded pass B's layout on dense rows of ``plan`` for clusters of
    ``cluster`` blocks and a ring of ``depth`` slots, with, where cluster >
    1, the tile the rows are pushed into (:func:`fold_layout` picks among
    them); the block's threads the dense route's narrow count, the wide
    one where one block has the SM alone (an H100 sweep read the narrow
    count ahead wherever two blocks share an SM, PERF.md §6).  None where
    it does not fit one block's shared memory."""
    rows = dense.dense_plan(plan.q, dtype)
    size = dtype.itemsize
    slot = -(-(rows.lines * plan.q * size + 16) // 16) * 16
    pitch = -(-plan.q // cluster) | 1 if cluster > 1 else 0
    smem = (rows.buf_offset + depth * slot
            + cluster * rows.lines * pitch * size + 16)
    if smem > radix.SMEM_MAX_BYTES:
        return None
    narrow, wide = dense.THREADS[size]
    return FoldLayout("dense", cluster, rows.lines, depth, slot // size, smem,
                      wide if smem > radix.SMEM_TARGET_BYTES else narrow,
                      pitch)


def call_launches(plan: SplitPlan, dtype: torch.dtype) -> int:
    """Launches of one call of ``plan`` but a nested plan's rows' own:
    pass A and pass B (radix rows, or rows with pass C folded in), or
    pass A, the rows' launch and pass C."""
    return 2 if plan.row_path == "radix" or fold_layout(plan, dtype) else 3


def column_tile(plan: SplitPlan, dtype: torch.dtype):
    """Pass A's tile: the strided radix tile of P (no staged twiddle), or
    the dense kernel's column tile (``dense.column_plan``)."""
    if plan.col_path == "dense":
        return dense.column_plan(plan.p, dtype)
    return radix.radix_tile(plan.p, dtype.itemsize, False, True)


def row_tile(plan: SplitPlan, dtype: torch.dtype):
    """Pass B's tile: the radix route's tile of Q on lines (the output
    twiddle is read from L2, not staged) or the long-line route's."""
    if plan.row_path == "long":
        return longline.long_tile(plan.q, dtype)
    return radix.radix_tile(plan.q, dtype.itemsize, False, False)


def row_lines(plan: SplitPlan, dtype: torch.dtype) -> int:
    """Rows of one pass-B tile on the radix route: consecutive kp of one
    line, so L divides P."""
    return radix.radix_tile(plan.q, dtype.itemsize, False, False).lines


def _w(n: int, e: np.ndarray, sign: float) -> np.ndarray:
    return np.exp(sign * 2j * np.pi * e / n)


def constants(plan: SplitPlan, inverse: bool) -> np.ndarray:
    """TA[kp, ql] = W_N^(kp*ql) and TB[kp, qh] = W_N^(kp*qh*QL), row-major,
    one complex128 array built in float64: TA*TB is the inter-step
    twiddle W_N^(kp*q) of pass A.  On a dense pass A, WA[i] = W_N^i, i <
    W, then WB[i] = W_N^(i*W), W = 2^w_log2: W_N^e = WA[e mod W] *
    WB[e div W]."""
    sign = 1.0 if inverse else -1.0
    if plan.col_path == "dense":
        w = 1 << plan.w_log2
        return np.concatenate([
            _w(plan.n, np.arange(w, dtype=np.float64), sign),
            _w(plan.n, np.arange(-(-plan.n // w), dtype=np.float64) * w,
               sign)])
    kp = np.arange(plan.p, dtype=np.float64)[:, None]
    ql = np.arange(plan.ql, dtype=np.float64)[None, :]
    qh = np.arange(plan.qh, dtype=np.float64)[None, :]
    # kp*q stays below 2^53, so the exponents are exact in float64
    ta = _w(plan.n, kp * ql, sign)
    tb = _w(plan.n, kp * qh * plan.ql, sign)
    return np.concatenate([ta.reshape(-1), tb.reshape(-1)])


def emulate(x: torch.Tensor, *, inverse: bool = False,
            twiddle: Optional[torch.Tensor] = None,
            pack_parts: Optional[int] = None) -> torch.Tensor:
    """Run the split route's two passes and index maps in torch: ``x`` is
    contiguous ``(B, N)``.  Returns what the kernels write: ``(B, N)``, or
    the ``(p, B, N/p)`` buffer with ``pack_parts``."""
    b, n = x.shape
    return emulate_plan(x, split_plan(n, x.dtype), inverse=inverse,
                        twiddle=twiddle, pack_parts=pack_parts)


def emulate_plan(x: torch.Tensor, plan: SplitPlan, *, inverse: bool = False,
                 twiddle: Optional[torch.Tensor] = None,
                 pack_parts: Optional[int] = None,
                 pre: Optional[torch.Tensor] = None,
                 keep: Optional[int] = None) -> torch.Tensor:
    """:func:`emulate` with the plan given (a forced (P, Q) too).

    The chirp route's folded load and store (``kernels/chirp.py``):
    with ``pre`` (n_in values, dense pass A only) ``x`` is ``(B, n_in)``
    and pass A reads index e < n_in of each (P, Q) block as x[b, e] *
    pre[e], zero past it; with ``keep`` pass C stores only the outputs of
    index < ``keep``, ``(B, keep)`` or the ``(p, B, keep/p)`` buffer, and
    ``twiddle`` holds ``keep`` values."""
    b = x.shape[0]
    tables = torch.from_numpy(constants(plan, inverse)).to(x.device, x.dtype)
    if pre is not None:
        block = torch.zeros((b, plan.n), dtype=x.dtype, device=x.device)
        n_in = x.shape[1]
        block[:, :n_in] = x * pre.to(x.device, x.dtype)
        block = block.reshape(b, plan.p, plan.q)
    else:
        block = x.reshape(b, plan.p, plan.q)
    if plan.col_path == "dense":
        y = dense.emulate(block, inverse=inverse,
                          columns=(tables, plan.w_log2))
    else:
        y = radix.emulate(block, inverse=inverse, strided=True,
                          split_twiddle=(tables, plan.ql_log2))
    rows = y.reshape(b * plan.p, plan.q)
    if plan.row_path == "radix":
        return radix.emulate(rows, inverse=inverse, twiddle=twiddle,
                             pack_parts=pack_parts, rows_per_line=plan.p)
    layout = fold_layout(plan, x.dtype)
    if layout is not None:
        if layout.rows == "dense":
            staged, pos = dense.staged(rows, inverse)
        else:
            pos = fold_positions(plan.q, x.dtype)
            staged = torch.zeros((b * plan.p, int(pos.max()) + 1),
                                 dtype=x.dtype, device=x.device)
            staged[:, pos.to(x.device)] = longline.emulate(
                rows, inverse=inverse, scaled=False)
        return fold_emulate(staged.reshape(b, plan.p, -1), pos, plan,
                            layout, inverse=inverse, twiddle=twiddle,
                            pack_parts=pack_parts, keep=keep)
    # rows that keep pass C ("any"): the rows' own route, its 1/Q included
    from .fft_matmul import fft_fourstep_plain    # it imports this
    z = fft_fourstep_plain(rows.contiguous(), inverse=inverse)
    return transpose_emulate(z, plan, inverse=inverse, twiddle=twiddle,
                             pack_parts=pack_parts, keep=keep)


def fold_positions(q: int, dtype: torch.dtype) -> torch.Tensor:
    """Where the long-line kernels' pass 3 leaves output kq of a row of
    ``q`` in its line buffer (:func:`fold_emulate`'s ``pos``): in natural
    order on a power-of-two Q (``long_body``), at (k1, k2, k3) on a mixed
    one (``mixed_tiles``: kq = kA + R1*R2*k3, kA = k1 + R1*k2, each item's
    outputs where it read its inputs, R1 rows at a pitch of R2*R3 plus 16
    bytes)."""
    kq = torch.arange(q)
    if radix.is_pow2(q):
        return kq
    r1, r2, r3 = longline.FACTORS[dtype][q]
    pitch = r2 * r3 + 16 // dtype.itemsize
    k3, ka = kq // (r1 * r2), kq % (r1 * r2)
    return (ka % r1) * pitch + (ka // r1) * r3 + k3


def fold_shares(plan: SplitPlan, layout: FoldLayout,
                dtype: torch.dtype) -> list:
    """The kq each block of a cluster stores (``split_fold_store``), per
    rank, in the order its threads take them: on mixed long-line rows the
    k3 in [rank*K3, (rank+1)*K3), K3 = R3/C, of every kA = k1 + R1*k2, k3
    fastest (kq = kA + R1*R2*k3: consecutive words of ``mixed_tiles``'
    buffer, :func:`fold_positions`); else [rank*S, (rank+1)*S) within Q,
    S = ceil(Q/C)."""
    q, c = plan.q, layout.cluster
    if layout.rows == "long" and not radix.is_pow2(q):
        r1, r2, r3 = longline.FACTORS[dtype][q]
        k3s = r3 // c
        t = torch.arange(q // c)
        return [t // k3s + r1 * r2 * (rank * k3s + t % k3s)
                for rank in range(c)]
    share = -(-q // c)
    return [torch.arange(min(q, rank * share), min(q, (rank + 1) * share))
            for rank in range(c)]


def fold_emulate(staged: torch.Tensor, pos: torch.Tensor, plan: SplitPlan,
                 layout: FoldLayout, *, inverse: bool = False,
                 twiddle: Optional[torch.Tensor] = None,
                 pack_parts: Optional[int] = None,
                 keep: Optional[int] = None) -> torch.Tensor:
    """Pass B's store with pass C folded in, by the cluster's own map
    (``split_fold_store``): ``staged`` holds B lines of P rows as the
    kernel leaves them in shared memory, output kq of row kp at
    staged[b, kp, pos[kq]] (unscaled).  Line b's rows go in groups of G =
    C*L (``layout.group``) consecutive kp0 + j, a group never spanning two
    lines, the last group's rows past P masked; block ``rank`` of a
    cluster stores its share of kq (:func:`fold_shares`) of every row of
    the group at of = kp0 + j + P*kq, times ``twiddle[of]``, times the
    inverse's 1/(P*Q), into the ``pack_parts`` segment of of; with
    ``keep`` only of < ``keep``.  Returns what the kernel writes: ``(B,
    N)`` (or ``(B, keep)``), or the ``(p, B, N/p)`` buffer with
    ``pack_parts``."""
    b, dev, cdt = staged.shape[0], staged.device, staged.dtype
    p, g = plan.p, layout.group
    kept = plan.n if keep is None else keep
    parts = pack_parts or 1
    seg = kept // parts
    out = torch.empty(parts * b * seg, dtype=cdt, device=dev)
    kp = (torch.arange(-(-p // g), device=dev)[:, None] * g
          + torch.arange(g, device=dev)[None, :])        # (groups, G)
    valid = kp < p
    line = torch.arange(b, device=dev)[:, None]
    tw = None if twiddle is None else twiddle.to(dev, cdt).reshape(-1)
    pos = pos.to(dev)
    for kq in fold_shares(plan, layout, cdt):
        kq = kq.to(dev)
        of = kp[..., None] + p * kq                       # (groups, G, K)
        mask = valid[..., None] & (of < kept)
        src = kp.clamp(max=p - 1)[..., None] * staged.shape[2] + pos[kq]
        of, src = of[mask], src[mask]
        y = staged.reshape(b, -1)[:, src]                 # (B, M)
        if tw is not None:
            y = y * tw[of]
        if inverse:
            y = y * (1.0 / plan.n)
        out[((of // seg) * b + line) * seg + of % seg] = y
    if pack_parts is None:
        return out.reshape(b, kept)
    return out.reshape(parts, b, seg)


def transpose_emulate(z: torch.Tensor, plan: SplitPlan, *,
                      inverse: bool = False,
                      twiddle: Optional[torch.Tensor] = None,
                      pack_parts: Optional[int] = None,
                      keep: Optional[int] = None) -> torch.Tensor:
    """Pass C in torch: ``z`` holds B lines of (P, Q) rows z[b, kp, kq];
    out[b, kp + P*kq] = z[b, kp, kq] times ``twiddle[kp + P*kq]``, times
    the inverse's 1/N (1/P after rows that applied their 1/Q: all but
    long-line rows, which apply none),
    stored as the kernel stores it: ``(B, N)`` or the ``(p, B, N/p)``
    buffer; with ``keep`` only the outputs of index < ``keep``, ``(B,
    keep)`` or ``(p, B, keep/p)``."""
    n, dev, cdt = plan.n, z.device, z.dtype
    b = z.numel() // n
    kp = torch.arange(plan.p, device=dev)[:, None]
    kq = torch.arange(plan.q, device=dev)[None, :]
    of = kp + plan.p * kq                               # (P, Q)
    y = z.reshape(b, plan.p, plan.q)
    kept = n if keep is None else keep
    mask = of < kept
    of, y = of[mask], y[:, mask]                        # (K,), (B, K)
    if twiddle is not None:
        y = y * twiddle.to(dev, cdt).reshape(-1)[of]
    if inverse:
        y = y * (1.0 / (n if plan.row_path == "long" else plan.p))
    parts = pack_parts or 1
    seg = kept // parts
    line = torch.arange(b, device=dev)[:, None]
    out = torch.empty(b * kept, dtype=cdt, device=dev)
    out[((of // seg) * b + line) * seg + of % seg] = y
    if pack_parts is None:
        return out.reshape(b, kept)
    return out.reshape(parts, b, seg)
