"""The radix path of the four-step kernel: its plan, its tiles and their
index maps, in Python.

For N = N1*N2 (``transforms.factorize``) in :data:`RADIX_SIZES` (every even
N whose only prime factors are 2, 3, 5, 7, 11 and 13, and every 17*2^k,
19*2^k and 23*2^k, whose two factors are both at most :data:`CODELET_MAX`
long: the powers of two and the mixed lengths r*2^k, their odd parts r in
:data:`RADIX_ODD`, 3 to 1701) the kernel (``csrc/fft_radix.cuh``) computes
the four steps with in-register codelets instead of dense DFT-matrix
products (on the CPU, :func:`emulate` runs the same index maps):

* column pass — a thread holds one (line, m2) column x[m1*N2 + m2],
  m1 < N1, in registers, transforms it with a radix-2 codelet of length
  N1, multiplies by T[k1, m2] = W_N^(k1*m2) and stores it in the tile in
  shared memory at (line, k1, m2);
* row pass — a thread holds one (line, k1) row of the tile, m2 < N2,
  transforms it with a codelet of length N2 and writes
  out[k1 + N1*k2] with the epilogue (the output twiddle, 1/N, the
  ``pack_parts`` segment store).

A codelet of a power-of-two length L is the iterative radix-2 decimation
in time: the input sits in bit-reversed order, and stage s (m = 2^s, h =
m/2) does the butterflies (b+j, b+j+h) for b a multiple of m and j < h,
the lower input multiplied by W_m^j = w[j * N2/m], where w[k] = W_N2^k
for k < N2/2 is the one table both codelets share (N1 divides N2).

A codelet of any other length L = 2^a 3^b 5^c 7^d 11^e 13^f 17^g 19^h 23^i
(N a mixed length) is the mixed-radix decimation in time over the chain
:func:`radices` (the 23s, the 19s, the 17s, the 13s, the 11s, the 7s, the
5s, the 3s, then 4s and a last 2, first stage first): the input sits in
digit-reversed order (:func:`digit_rev`), and a stage of radix r after
stages spanning m does, for every block b of m*r and j < m, the r-point
DFT of v[b + j + q*m], q < r, input q first multiplied by W_(m*r)^(j*q) =
w[j*q * L/(m*r)] from the codelet's own table of W_L^k, k < L (N1 need
not divide N2: 384 = 16*24).  The r-point DFTs are the constant
rotations of :func:`_dft_small` (radix 3, 4, 5, 7, 11, 13, 17, 19 and
23 with the direction's sign; no table; 7 to 23 in the symmetric-pair
form).
For a mixed N both codelets have their own table
(W_N1^k and W_N2^k), a power-of-two factor's codelet too.  The loops
unroll fully in the kernel (N1 and N2 are template parameters), so every
index is a constant and the values stay in registers.

Two layouts of lines, one kernel:

* lines — contiguous ``(B, N)``: a tile is ``lines`` consecutive lines;
  threads run fastest along m2 (column pass) or k1 (row pass), so loads
  and stores of a warp hit consecutive addresses; the tile is stored
  (line, k1, m2) with a row pitch of N2 + 1, so the row pass's reads
  down k1 spread over the banks.
* strided — a contiguous ``(outer, N, inner)`` block transformed along
  dim 1: a tile is one ``outer`` index, all N and ``lines`` consecutive
  ``inner`` indices; threads run fastest along the inner index, both for
  global memory and for the tile, stored (k1, m2, line).  The last group
  of ``inner`` is masked.

The split route (``kernels/split.py``) runs two more modes of the
kernel, for lines longer than one block holds: pass A, the strided layout
whose store multiplies by the inter-step twiddle from two tables
(``emulate``'s ``split_twiddle``); pass B, contiguous rows whose tile is
laid out (k1, line, m2) with a row pitch of N2 + 1 and whose row pass
runs its threads along the line, storing each row transposed into its
line's output (``rows_per_line``).

:func:`emulate` runs exactly these loops and index maps in torch, so the
CPU tests hold the kernel's index math against ``np.fft``; the kernel
mirrors them line for line.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.transforms import factorize

#: Threads of one block of the radix kernel.
THREADS = 256
#: Dynamic shared memory one block may take on Hopper (227 KB).
SMEM_MAX_BYTES = 232448
#: Budget that lets two blocks share an SM.
SMEM_TARGET_BYTES = SMEM_MAX_BYTES // 2 - 1024
#: ``inner`` indices per strided tile: a row of the tile is 128 bytes of
#: complex64 (256 of complex128), whole sectors.
STRIDED_LINES = 16
#: The odd parts of the mixed lengths N = r*2^k, k >= 1, that every route
#: of them takes: the radix route within one block, the long-line route
#: (``longline.FACTORS``: r*2^a is its mixed factor R1 <= 32, R2 and R3
#: powers of two) and the split route past it (``split.FACTORS``).  The
#: long-line route takes other 13-smooth odd parts too (33 to 729, R2
#: mixed: ``longline.rule_factors``), and so does the split route where
#: its rule finds a P and a Q (``split.rule_factors``).
EVERY_ROUTE_ODD = (3, 5, 7, 9, 11, 13, 15, 17, 19, 21, 23, 25, 27)
#: The odd parts with a prime factor past 13 that the codelet routes take:
#: the primes of the radix-17, radix-19 and radix-23 butterflies alone, as
#: N = 17*2^k, 19*2^k and 23*2^k (:func:`codelet_length`).  Their odd
#: products (51, 57, 69, 85, ...) are not taken yet.
WIDE_ODD = (17, 19, 23)
#: The longest codelet per complex dtype, in values: a codelet of 64
#: complex128 values would take 256 registers and spill, so complex128
#: stops at 32 (and its 2048 and 4096 take the long-line route).
CODELET_MAX = {torch.complex64: 64, torch.complex128: 32}


def smooth(n: int) -> bool:
    """Whether ``n`` >= 1 has no prime factor but 2, 3, 5, 7, 11 and 13,
    the radices of the codelets."""
    for p in (2, 3, 5, 7, 11, 13):
        while n % p == 0:
            n //= p
    return n == 1


def odd_part(n: int) -> int:
    """``n`` without its factors of 2."""
    return n >> ((n & -n).bit_length() - 1)


def codelet_length(n: int) -> bool:
    """Whether the codelet chain (:func:`radices`) takes a length ``n`` >=
    1: 13-smooth (:func:`smooth`, which the dense and long-line routes'
    rules read), or r*2^k with r in :data:`WIDE_ODD` (17, 19 and 23)."""
    return smooth(n) or odd_part(n) in WIDE_ODD


#: Lengths the kernel instantiates, per complex dtype: every even N whose
#: only prime factors are 2, 3, 5, 7, 11 and 13, and every 17*2^k, 19*2^k
#: and 23*2^k (:func:`codelet_length`), whose two factors (``factorize``)
#: are both at most ``CODELET_MAX`` long, so both codelets stay in
#: registers: complex64 2 to 4096 (12 powers of two and 320 mixed lengths,
#: 4096 = 64 x 64, 3780 = 60 x 63, 600 = 24 x 25, 2944 = 46 x 64),
#: complex128 4 to 1024 (9 and 155; 900 = 30 x 30, 736 = 23 x 32).  Of the
#: even 13-smooth lengths whose factors do not both fit, those that three
#: codelets of at most 32 take run the long-line kernel
#: (``longline.rule_factors``: complex64 3168 to 4096, such as 3888 = 27 x
#: 9 x 16 and 4000; complex128 792 to 1024, such as 1000); the rest
#: (complex64 1690 = 26 x 65 to 4056, such as 2730 and 4050; complex128 490
#: = 14 x 35 to 1014, such as 990) and odd N run the dense kernel.  Four
#: lengths whose kernels ptxas spills at a low register count stay on the
#: dense path too: complex128 N = 2 (4 bytes at 64 registers) and N = 22 =
#: 2x11 (4 bytes at 80), complex64 N = 208 = 13x16 (4 bytes and an 8-byte
#: stack frame at 64) and N = 504 = 21x24 (4 bytes and an 8-byte stack
#: frame at 80).
_SPILLS = {torch.complex64: (208, 504), torch.complex128: (2, 22)}
RADIX_SIZES = {
    dtype: tuple(n for n in range(2, cap * cap + 1, 2)
                 if codelet_length(n) and max(factorize(n)) <= cap
                 and n not in _SPILLS[dtype])
    for dtype, cap in CODELET_MAX.items()}
#: The odd parts the radix route takes, per complex dtype: 13-smooth, or
#: 17, 19 or 23, in some even N whose two factors both fit one codelet
#: (complex64 3 to 1701, complex128 3 to 405).  Which r*2^k of them run
#: there is :data:`RADIX_SIZES`' rule: 75*2 = 150 = 10 x 15 does, 75*64 =
#: 4800 = 60 x 80 does not.
RADIX_ODD = {dtype: frozenset(odd_part(n) for n in sizes if odd_part(n) > 1)
             for dtype, sizes in RADIX_SIZES.items()}


def kernel_path(n: int, dtype: torch.dtype) -> str:
    """"radix" when the kernel has a codelet instantiation for ``n`` and
    ``dtype``, "long" for the longer lines the long-line route takes
    (``longline.FACTORS``: powers of two and mixed lengths to a 128 KB
    line, with one mixed factor or two), "split" for the lines longer
    than one block holds (``split.FACTORS``: two passes through HBM, N =
    P*Q with P a power of two; the measured table and, since the rule,
    every 13-smooth N or r*2^k, r in :data:`WIDE_ODD`, whose Q a radix or
    long-line row takes: ``split.rule_factors``; and every other 13-smooth
    N past one block: ``split.general_factors``; ``split.takes``), "chirp"
    for every other length the dense route does not take up to the chirp
    route's limit
    (``chirp.takes``: Bluestein over the other routes; ``dense.takes``: N
    up to ``dense.DENSE_LIMIT`` whose generic stages cost no more than the
    chirp (``dense.GENERIC_COST``), and the 13-smooth N whose line fits
    one block), else "dense" (the mixed-radix kernel over a run-time
    chain; past the chirp's limit it raises).  The wide lines of
    :data:`RADIX_SIZES` (``longline.WIDE``: a factor past 32 values,
    complex64, or 16, complex128) are "long": their contiguous lines take
    the long route's wide kernel, while the radix kernel keeps their
    strided layout and the split route's rows of them."""
    # deferred: longline, split and chirp import this module
    from .longline import WIDE
    if n in RADIX_SIZES.get(dtype, ()):
        return "long" if n in WIDE.get(dtype, {}) else "radix"
    from .chirp import takes
    from .longline import FACTORS as LONG
    from .split import takes as split_takes
    if n in LONG.get(dtype, {}):
        return "long"
    if split_takes(n, dtype):
        return "split"
    return "chirp" if takes(n, dtype) else "dense"


def bitrev(i: int, bits: int) -> int:
    """``i`` with its low ``bits`` bits reversed."""
    r = 0
    for _ in range(bits):
        r = (r << 1) | (i & 1)
        i >>= 1
    return r


def is_pow2(n: int) -> bool:
    return n > 0 and not n & (n - 1)


#: The odd radices of the mixed codelets, in chain order.
ODD_RADICES = (23, 19, 17, 13, 11, 7, 5, 3)


def radices(length: int) -> Tuple[int, ...]:
    """The radix chain of a codelet of ``length``, first stage first: 2s
    for a power of two (the radix-2 codelet); else the 23s, the 19s, the
    17s, the 13s, the 11s, the 7s, the 5s, the 3s, then the 4s and a last 2
    (``fft_radix.cuh``'s ``mixed_radix``).  Raises for a length below 2 or
    with a prime factor other than 2, 3, 5, 7, 11, 13, 17, 19 and 23."""
    if length >= 2 and is_pow2(length):
        return (2,) * (length.bit_length() - 1)
    rest, exps = length, {}
    for p in ODD_RADICES + (2,):
        exps[p] = 0
        while rest > 1 and rest % p == 0:
            rest //= p
            exps[p] += 1
    if rest != 1 or length < 2:
        raise ValueError(f"the radix path takes N >= 2 whose only prime "
                         f"factors are 2, 3, 5, 7, 11, 13, 17, 19 and 23, "
                         f"got "
                         f"{length}")
    a = exps[2]
    return (sum(((p,) * exps[p] for p in ODD_RADICES), ())
            + (4,) * (a // 2) + (2,) * (a % 2))


def digit_rev(i: int, chain: Tuple[int, ...]) -> int:
    """The register input ``i`` is loaded into: its digits in the mixed
    radix of ``chain``, the last stage's radix least significant, each
    digit weighted by the span of the stages before its own (bit reversal
    for a chain of 2s)."""
    p = 0
    for t in range(len(chain) - 1, -1, -1):
        p += (i % chain[t]) * math.prod(chain[:t])
        i //= chain[t]
    return p


def load_slot(i: int, length: int) -> int:
    """Where a codelet of ``length`` loads its input ``i``."""
    if is_pow2(length):
        return bitrev(i, length.bit_length() - 1)
    return digit_rev(i, radices(length))


Butterfly = Tuple[int, int, Optional[int]]   # (top, bottom, w index or None)
#: One r-point DFT of a mixed codelet: its registers b + j + q*m, q < r,
#: and per input the twiddle's table index (None where it is 1).
MixedButterfly = Tuple[Tuple[int, ...], Tuple[Optional[int], ...]]


def codelet(length: int, table: int) -> List[List[Butterfly]]:
    """The stages of a radix-2 codelet of ``length`` with twiddles from
    the ``table``-length table: per stage, (top, bottom, w index) per
    butterfly, the index None where the twiddle is 1."""
    stages = []
    m = 2
    while m <= length:
        h = m // 2
        stages.append([(b + j, b + j + h, j * (table // m) if j else None)
                       for b in range(0, length, m) for j in range(h)])
        m *= 2
    return stages


def mixed_codelet(length: int) -> List[List[MixedButterfly]]:
    """The stages of a mixed-radix codelet of ``length`` over
    :func:`radices`, twiddles from its own table of W_length^k, k <
    length."""
    stages, m = [], 1
    for r in radices(length):
        mt = m * r
        stages.append([
            (tuple(b + j + q * m for q in range(r)),
             tuple(j * q * (length // mt) or None for q in range(r)))
            for b in range(0, length, mt) for j in range(m)])
        m = mt
    return stages


@dataclasses.dataclass(frozen=True)
class RadixPlan:
    n: int
    n1: int
    n2: int
    column: list    # codelet of length n1
    row: list       # codelet of length n2

    @property
    def mixed(self) -> bool:
        """Not a power of two: each codelet has its own table, and one of
        a length that is not a power of two runs :func:`mixed_codelet`'s
        stages."""
        return not is_pow2(self.n)


def radix_plan(n: int) -> RadixPlan:
    """The factorization and both codelets of ``n``: radix-2 codelets on
    the shared table for a power of two; for a mixed ``n`` each factor's
    codelet on its own table (radix-2 where that factor is a power of
    two).  Raises for N < 2 or a prime factor other than 2, 3, 5, 7, 11,
    13, 17, 19 and 23."""
    radices(n)
    n1, n2 = factorize(n)
    if is_pow2(n):
        return RadixPlan(n, n1, n2, codelet(n1, n2), codelet(n2, n2))

    def own(length):
        return (codelet(length, length) if is_pow2(length)
                else mixed_codelet(length))
    return RadixPlan(n, n1, n2, own(n1), own(n2))


@dataclasses.dataclass(frozen=True)
class RadixTile:
    lines: int          # lines (or inner indices) per tile, a power of two
    strided: bool
    smem_bytes: int     # dynamic shared memory of one block


def table_elems(n: int) -> int:
    """The codelet tables' entries: N2/2 shared for a power of two, else
    the row codelet's N2 and the column codelet's N1."""
    n1, n2 = factorize(n)
    return n2 // 2 if is_pow2(n) else n2 + n1


def const_elems(n: int, twiddle: bool) -> int:
    """Constants the kernel keeps in shared memory: T (N), the codelet
    tables (:func:`table_elems`) and the optional output twiddle (N)."""
    return n + table_elems(n) + (n if twiddle else 0)


def tile_elems(n: int, lines: int, strided: bool) -> int:
    n1, n2 = factorize(n)
    return lines * n if strided else lines * n1 * (n2 + 1)


def radix_tile(n: int, itemsize: int, twiddle: bool,
               strided: bool) -> Optional[RadixTile]:
    """The tile of the radix kernel for lines of length ``n``, or None
    when the layout does not fit (strided tiles of N >= 2048 complex64,
    N >= 1024 complex128).

    Lines: as many lines as give every thread a row (the power of two at
    most THREADS / N1), halved until two blocks share an SM.  Strided:
    ``STRIDED_LINES`` inner indices, within the 227 KB of one block."""
    n1, _ = factorize(n)
    const = const_elems(n, twiddle)
    if strided:
        lines = STRIDED_LINES
        need = (const + tile_elems(n, lines, True)) * itemsize
        if need > SMEM_MAX_BYTES:
            return None
        return RadixTile(lines, True, need)
    lines = 1 << ((THREADS // n1).bit_length() - 1)
    while lines > 1 and (const + tile_elems(n, lines, False)) * itemsize \
            > SMEM_TARGET_BYTES:
        lines //= 2
    return RadixTile(lines, False,
                     (const + tile_elems(n, lines, False)) * itemsize)


def smem_strides(n: int, lines: int, strided: bool,
                 rows: bool = False) -> Tuple[int, int, int]:
    """(line, k1, m2) strides of the tile in shared memory, in elements;
    ``rows`` is the split route's pass B, whose tile is (k1, line, m2)
    with a row pitch of N2 + 1."""
    n1, n2 = factorize(n)
    if strided:
        return 1, n2 * lines, lines
    if rows:
        return n2 + 1, lines * (n2 + 1), 1
    return n1 * (n2 + 1), n2 + 1, 1


def column_item(c, lines: int, n2: int, strided: bool):
    """(line, m2) of column item ``c`` (a thread index, or a tensor)."""
    if strided:
        return c % lines, c // lines
    return c // n2, c % n2


def row_item(r, lines: int, n1: int, strided: bool):
    """(line, k1) of row item ``r``: the split route's pass B runs its
    threads along the line as the strided layout does."""
    if strided:
        return r % lines, r // lines
    return r // n1, r % n1


def _w_table(length: int, count: int, sign: float) -> np.ndarray:
    k = np.arange(count, dtype=np.float64)
    return np.exp(sign * 2j * np.pi * k / length)


def codelet_table(n: int, inverse: bool) -> np.ndarray:
    """The codelets' tables, built in float64: for a power of two w[k] =
    exp(sign*2*pi*i*k/N2), k < N2/2, shared by both codelets; for a mixed
    ``n`` the row codelet's W_N2^k, k < N2, then the column codelet's
    W_N1^k, k < N1."""
    n1, n2 = factorize(n)
    sign = 1.0 if inverse else -1.0
    if is_pow2(n):
        return _w_table(n2, n2 // 2, sign)
    return np.concatenate([_w_table(n2, n2, sign), _w_table(n1, n1, sign)])


def _run_codelet(v: list, stages, w: torch.Tensor) -> list:
    for stage in stages:
        for top, bot, wi in stage:
            t = v[bot] if wi is None else v[bot] * w[wi]
            v[top], v[bot] = v[top] + t, v[top] - t
    return v


#: The constant rotations of the radix-3 and radix-5 DFTs: sin(2*pi/3),
#: cos and sin of 2*pi/5 and 4*pi/5 (``fft_radix.cuh`` spells the same
#: digits).
_S3 = 0.86602540378443864676
_C51, _C52 = 0.30901699437494742410, -0.80901699437494742410
_S51, _S52 = 0.95105651629515357212, 0.58778525229247312917
#: cos(2*pi*j/P) and sin(2*pi*j/P), j = 1 .. (P-1)/2, of the radix-7, 11,
#: 13, 17, 19 and 23 DFTs (``fft_radix.cuh``'s ``odd_cos``/``odd_sin`` spell
#: the same digits).
_ODD_COS = {
    7: (0.62348980185873353053, -0.22252093395631440429,
        -0.90096886790241912624),
    11: (0.84125353283118116886, 0.41541501300188642553,
         -0.14231483827328514044, -0.65486073394528506406,
         -0.95949297361449738989),
    13: (0.88545602565320989590, 0.56806474673115580251,
         0.12053668025532305335, -0.35460488704253562597,
         -0.74851074817110109863, -0.97094181742605202716),
    17: (0.93247222940435580457, 0.73900891722065911592,
         0.44573835577653826740, 0.09226835946330199524,
         -0.27366299007208286354, -0.60263463637925638918,
         -0.85021713572961415213, -0.98297309968390177828),
    19: (0.94581724170063467902, 0.78914050939639359922,
         0.54694815812242687471, 0.24548548714079914892,
         -0.08257934547233232460, -0.40169542465296945752,
         -0.67728157162574107476, -0.87947375120648907139,
         -0.98636130340272237360),
    23: (0.96291728734779929502, 0.85441940454648855255,
         0.68255314321865408287, 0.46006503773115212604,
         0.20345601305263378988, -0.06824241336467097592,
         -0.33487961217098615196, -0.57668032211486714125,
         -0.77571129070441980704, -0.91721130150545301784,
         -0.99068594603633075234)}
_ODD_SIN = {
    7: (0.78183148246802980871, 0.97492791218182360702,
        0.43388373911755812048),
    11: (0.54064081745559758211, 0.90963199535451837141,
         0.98982144188093273238, 0.75574957435425828377,
         0.28173255684142969771),
    13: (0.46472317204376854566, 0.82298386589365639458,
         0.99270887409805399280, 0.93501624268541482344,
         0.66312265824079520238, 0.23931566428755776715),
    17: (0.36124166618715294874, 0.67369564364655721171,
         0.89516329135506232207, 0.99573417629503452187,
         0.96182564317281907041, 0.79801722728023950333,
         0.52643216287735580024, 0.18374951781657033157),
    19: (0.32469946920468348741, 0.61421271268966781744,
         0.83716647826252857481, 0.96940026593933041674,
         0.99658449300666984982, 0.91577332665505743992,
         0.73572391067313162477, 0.47594739303707354443,
         0.16459459028073389414),
    23: (0.26979677115702427125, 0.51958395003543357813,
         0.73083596427812410165, 0.88788521840237523498,
         0.97908408768232287563, 0.99766876919053919845,
         0.94226092211882049562, 0.81696989301044201697,
         0.63108794432605278937, 0.39840108984624145800,
         0.13616664909624659076)}


def _odd_cs(p: int, m: int) -> Tuple[float, float]:
    """cos and sin of 2*pi*m/P for any m, from the table by symmetry."""
    m %= p
    if m > p // 2:
        c, s = _odd_cs(p, p - m)
        return c, -s
    return _ODD_COS[p][m - 1], _ODD_SIN[p][m - 1]


def _dft_odd(a: list, sign: float) -> list:
    """The P-point DFT (P = 7, 11, 13, 17, 19, 23) in the symmetric-pair
    form: b_j = a_j + a_(P-j), d_j = a_j - a_(P-j) for j < P/2; out 0 =
    a_0 + sum b; outs k and P-k = e_k +- i*s*f_k with e_k = a_0 + sum_j
    b_j cos(2*pi*j*k/P), f_k = sum_j d_j sin(2*pi*j*k/P), each sum in the
    order of j."""
    p = len(a)
    h = (p - 1) // 2
    b = [a[j] + a[p - j] for j in range(1, h + 1)]
    d = [a[j] - a[p - j] for j in range(1, h + 1)]
    out = [None] * p
    y = a[0]
    for bj in b:
        y = y + bj
    out[0] = y
    for k in range(1, h + 1):
        e, f = a[0], None
        for j in range(1, h + 1):
            c, s = _odd_cs(p, j * k)
            e = e + b[j - 1] * c
            f = d[j - 1] * s if f is None else f + d[j - 1] * s
        f = _rot(f, sign)
        out[k], out[p - k] = e + f, e - f
    return out


def _rot(a, sign: float):
    """i*sign*a."""
    return a * complex(0.0, sign)


def _dft_small(a: list, sign: float) -> list:
    """The r-point DFT (r = 2, 3, 4, 5, 7, 11, 13, 17, 19, 23) of ``a`` with
    W_r = exp(sign*2*pi*i/r), as the kernel's butterflies compute it."""
    r = len(a)
    if r in _ODD_COS:
        return _dft_odd(a, sign)
    if r == 2:
        return [a[0] + a[1], a[0] - a[1]]
    if r == 3:
        t1, d = a[1] + a[2], _rot((a[1] - a[2]) * _S3, sign)
        t2 = a[0] - t1 * 0.5
        return [a[0] + t1, t2 + d, t2 - d]
    if r == 4:
        t0, t1 = a[0] + a[2], a[0] - a[2]
        t2, t3 = a[1] + a[3], _rot(a[1] - a[3], sign)
        return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]
    b1, b2, d1, d2 = a[1] + a[4], a[2] + a[3], a[1] - a[4], a[2] - a[3]
    e1 = a[0] + b1 * _C51 + b2 * _C52
    e2 = a[0] + b1 * _C52 + b2 * _C51
    f1 = _rot(d1 * _S51 + d2 * _S52, sign)
    f2 = _rot(d1 * _S52 - d2 * _S51, sign)
    return [a[0] + b1 + b2, e1 + f1, e2 + f2, e2 - f2, e1 - f1]


def _run_mixed(v: list, stages, w: torch.Tensor, sign: float) -> list:
    for stage in stages:
        for regs, tws in stage:
            a = [v[i] if e is None else v[i] * w[e]
                 for i, e in zip(regs, tws)]
            for i, y in zip(regs, _dft_small(a, sign)):
                v[i] = y
    return v


def run_codelet(v: list, length: int, stages, w: torch.Tensor,
                sign: float) -> list:
    """The codelet of ``length`` on ``v`` (loaded in :func:`load_slot`
    order): natural order out."""
    if is_pow2(length):
        return _run_codelet(v, stages, w)
    return _run_mixed(v, stages, w, sign)


def emulate(x: torch.Tensor, *, inverse: bool = False,
            twiddle: Optional[torch.Tensor] = None,
            pack_parts: Optional[int] = None,
            strided: bool = False,
            split_twiddle: Optional[Tuple[torch.Tensor, int]] = None,
            rows_per_line: Optional[int] = None) -> torch.Tensor:
    """Run the radix kernel's loops and index maps in torch, every tile at
    once: ``x`` is contiguous ``(B, N)`` lines, or with ``strided`` a
    contiguous ``(outer, N, inner)`` block transformed along dim 1.
    Returns what the kernel writes: ``(B, N)`` (or the ``(p, B, N/p)``
    buffer with ``pack_parts``), or ``(outer, N, inner)``.  For the tests:
    the kernel mirrors these index maps.

    The split route's two modes (``kernels/split.py``):
    ``split_twiddle=(tables, ql_log2)`` with ``strided`` is pass A: the
    store multiplies by TA[o, q % QL] * TB[o, q // QL] (``tables`` holds
    TA then TB; q is the inner index, o the output index) and never
    scales.  ``rows_per_line=P`` is pass B: the ``(B*P, N)`` rows are
    rows kp of ``B`` lines of P*N, stored transposed at out[b, kp + P*o]
    with the line's epilogues (``twiddle`` of P*N entries, 1/(P*N),
    ``pack_parts`` over P*N)."""
    cdt = x.dtype
    if strided:
        outer, n, inner = x.shape
    else:
        (outer, n), inner = x.shape, 1
    rows = rows_per_line is not None
    plan = radix_plan(n)
    n1, n2 = plan.n1, plan.n2
    tile = radix_tile(n, x.element_size(),
                      twiddle is not None and not rows, strided)
    lines = tile.lines
    sl, sr, sc = smem_strides(n, lines, strided, rows)
    n_line = n * rows_per_line if rows else n
    parts = pack_parts or 1
    seg = n_line // parts

    from .fft_matmul import _device_constants   # T as the dense path builds it
    t_tab = _device_constants(n1, n2, inverse, cdt, x.device)[2].reshape(-1)
    w = torch.from_numpy(codelet_table(n, inverse)).to(cdt).to(x.device)
    # a mixed N: the row codelet's table, then the column codelet's
    w_row, w_col = (w[:n2], w[n2:]) if plan.mixed else (w, w)
    sign = 1.0 if inverse else -1.0
    mem = x.reshape(-1)
    if strided:
        groups = -(-inner // lines)
        ntiles = outer * groups
    else:
        groups, ntiles = 1, -(-outer // lines)
    tiles = torch.arange(ntiles, device=x.device).unsqueeze(1)

    def line_of(t, l):
        """(valid, input base, element stride) of line l of tile t."""
        if strided:
            o_idx, i = t // groups, (t % groups) * lines + l
            return i < inner, o_idx * n * inner + i, inner
        line = t * lines + l
        return line < outer, line * n, 1

    # column pass: item c -> (l, m2), loads x[m1*N2 + m2] for m1 < N1
    c = torch.arange(lines * n2, device=x.device).unsqueeze(0)
    l, m2 = column_item(c, lines, n2, strided)
    valid, base, js = line_of(tiles, l)
    v = [None] * n1
    for m1 in range(n1):
        addr = torch.where(valid, base + (m1 * n2 + m2) * js, 0)
        v[load_slot(m1, n1)] = torch.where(valid, mem[addr], 0)
    v = run_codelet(v, n1, plan.column, w_col, sign)
    smem = torch.zeros((ntiles, tile_elems(n, lines, strided)), dtype=cdt,
                       device=x.device)
    for k1 in range(n1):
        idx = (l * sl + k1 * sr + m2 * sc).expand(ntiles, -1)
        smem.scatter_(1, idx, v[k1] * t_tab[k1 * n2 + m2])

    # row pass: item r -> (l, k1), reads the tile row, writes k1 + N1*k2
    r = torch.arange(lines * n1, device=x.device).unsqueeze(0)
    l, k1 = row_item(r, lines, n1, strided or rows)
    valid, base, js = line_of(tiles, l)
    v = [None] * n2
    for j in range(n2):
        idx = (l * sl + k1 * sr + j * sc).expand(ntiles, -1)
        v[load_slot(j, n2)] = smem.gather(1, idx)
    v = run_codelet(v, n2, plan.row, w_row, sign)
    out = torch.zeros(outer * n * inner, dtype=cdt, device=x.device)
    scale = 1.0 / n_line if inverse and split_twiddle is None else 1.0
    tw = None if twiddle is None else twiddle.to(x.device, cdt).reshape(-1)
    line = tiles * lines + l
    if split_twiddle is not None:
        tables, ql_log2 = split_twiddle
        ql, qh = 1 << ql_log2, inner >> ql_log2
        # the column q of each lane; a ragged last group's lanes past Q
        # are masked (the kernel skips them), so read column 0 there
        q = torch.where(valid, (tiles % groups) * lines + l, 0)
        ta, tb = tables[:n * ql], tables[n * ql:]
    if rows:
        b_idx, kp = line // rows_per_line, line % rows_per_line
        nb = outer // rows_per_line
    for k2 in range(n2):
        o = k1 + n1 * k2
        y = v[k2]
        if split_twiddle is not None:
            y = y * (ta[o * ql + q % ql] * tb[o * qh + q // ql])
        if rows:
            o = kp + rows_per_line * o
        if tw is not None:
            y = y * tw[o]
        y = y * scale
        if strided:
            addr = base + o * inner
        elif rows:
            addr = ((o // seg) * nb + b_idx) * seg + o % seg
        else:
            addr = ((o // seg) * outer + line) * seg + o % seg
        out[addr[valid.expand_as(addr)]] = y[valid.expand_as(y)]
    if strided:
        return out.reshape(outer, n, inner)
    nb = outer // rows_per_line if rows else outer
    if pack_parts is None:
        return out.reshape(nb, n_line)
    return out.reshape(parts, nb, seg)
