"""The long-line route of the four-step kernel: its plan, its shared-memory
layouts and their index maps, in Python.

Lines too long for the radix route's two in-register passes still fit whole
in one block's shared memory: the powers of two (complex64 N of 8192 and
16384, complex128 N of 2048 to 8192), the mixed lengths r*2^k, r in
``radix.EVERY_ROUTE_ODD`` = {3, 5, 7, 9, 11, 13, 15, 17, 19, 21, 23, 25,
27}, from past ``radix.RADIX_SIZES`` to the same 128 KB line (complex64 4352 to
15360, complex128 1088 to 7680), and every other even 13-smooth N past the
radix route up to that line that three codelets of at most 32 values take
(:func:`rule_factors`: odd parts 33 to 729, complex64 3168 to 16128,
complex128 792 to 8064).  On the CPU the route runs :func:`emulate`; on the
card one launch of ``fft_long.cuh``.  It also takes, on contiguous lines,
the radix route's wide lines (:data:`WIDE`: a factor past 32 values in
complex64, 16 in complex128), on ``fft_wide.cuh``'s tile kernel: a
:class:`WidePlan` of LT lines a block in rows at a padded pitch, the
mixed kernel's three in-place passes, :func:`wide_candidates` choosing
the split and the tile; :func:`emulate` runs that tile loop too.  The kernel (``csrc/fft_long.cuh``)
holds one line there and transforms it in three passes over N = R1*R2*R3,
each an in-register codelet of length at most 32 (:data:`FACTORS`).  With
the input index m = m1*(R2*R3) + m2*R3 + m3 and the output index k = k1 +
R1*k2 + R1*R2*k3 (decimation in frequency):

* pass 1 — item mb = m2*R3 + m3: the R1 values x[m1*(N/R1) + mb], a
  codelet of length R1, times W_N^(k1*mb) = TA[k1, m3] * TB[k1, m2],
  stored back where they were read;
* pass 2 — item (k1, m3): the R2 values of m2 at (k1, m2, m3), a codelet
  of length R2, times TC[k2, m3] = W_(R2*R3)^(k2*m3);
* pass 3 — item kA = k1 + R1*k2: the R3 values of m3 at (k1, k2, m3), a
  codelet of length R3, and out[kA + R1*R2*k3] with the epilogue (the
  output twiddle, 1/N, the ``pack_parts`` segment store).

TA (R1 x R3), TB (R1 x R2) and TC (R2 x R3) are the two-level factors of
the inter-pass twiddles; all are built in float64 (:func:`constants`).

A power of two runs radix-2 codelets on one table of RM/2 entries (RM the
largest factor, which every factor divides).  A block of N/RM threads
holds RM values each in every pass; pass 2 loads all of them before it
stores any, into the layout (m3, kA) with a row pitch of R1*R2 + 1, so
that pass 3 reads consecutive addresses, and pass 3 loads all of them
before the buffer is released to the next line's copy.

A mixed length has a mixed factor R1 = r*2^a, on the radix route's chain
of radix-23, 19, 17, 13, 11, 7, 5, 3, 4 and 2 codelets (``radix.radices``;
R1 = 17, 19 and 23 one butterfly each) on its own table of R1 entries, and
R3 a power of two (radix-2 codelets).  R2 is a
power of two where the odd part fits R1 alone (r in
``radix.EVERY_ROUTE_ODD``: the radix-2 codelets' table then has
max(R2, R3)/2 entries); where it does not (odd parts 33 to 63 and the
13-smooth ones from 65), R2 holds the rest of it and runs the mixed chain
too, on a table of R2 entries of its own, and the radix-2 table has
R3/2.  Its line is copied in R1 rows of N/R1 with a pitch of N/R1 plus
16 bytes (:attr:`LongPlan.pitch`), and every pass runs one item at a
time and stores it where it was read, (k1, m2, m3) then (k1, k2, m3), so
no pass holds more than one codelet: pass 3's reads of consecutive kA
then fall R1 rows apart, on distinct banks.

The thread count (:attr:`LongPlan.threads`).  A power of two: every pass's
items split evenly, N / RM threads holding RM values each in every pass.
A mixed length: a fixed count sized for occupancy, not by the factors --
256 threads for complex64; for complex128, whose codelets take up to 255
registers a thread, 128 where two blocks share an SM by shared memory and
256 where one block has it alone.  Each pass walks its items in rounds of
the block (``item = tid, tid + T, ...``), so the last round leaves some
threads idle; as every item is stored where it was read, no pass needs an
even split.  Both take a ring of two line buffers where two fit in one
block's 227 KB (:attr:`LongPlan.depth`), so the next line's copy overlaps
this one's passes.

:func:`emulate` runs exactly these passes and index maps in torch; it is
the kernel's plain version (``fft_matmul.fft_fourstep_plain`` takes it
for these N), and the CPU tests hold it against ``np.fft`` and the JAX
package's kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.transforms import factorize
from . import radix

#: The powers of two and the lengths with one mixed factor (R2 and R3 powers
#: of two), with their (R1, R2, R3), per complex dtype: lines past
#: ``radix.RADIX_SIZES`` whose whole line, 128 KB at most, fits in one
#: block's shared memory.  Codelets of at most 32 values: ptxas keeps 32
#: complex128 values in registers (the radix route's 32x32 instantiation
#: does), not 64.  A mixed length's mixed factor is R1, with as many 2s as
#: 32 allows (28 for 7*2^k, 22 for 11*2^k, 26 for 13*2^k; none for 17*2^k,
#: 19*2^k, 21*2^k, 23*2^k, 25*2^k and 27*2^k, whose R1 is odd), so the
#: power-of-two passes are as short as they can be.  :func:`rule_factors`
#: splits the rest.
_TABLE = {
    torch.complex64: {
        8192: (16, 16, 32), 16384: (16, 32, 32),
        4608: (18, 16, 16), 5120: (20, 16, 16), 6144: (24, 16, 16),
        7680: (30, 16, 16), 9216: (18, 16, 32), 10240: (20, 16, 32),
        12288: (24, 16, 32), 15360: (30, 16, 32),
        5632: (22, 16, 16), 7168: (28, 16, 16), 11264: (22, 16, 32),
        14336: (28, 16, 32), 6656: (26, 16, 16), 13312: (26, 16, 32),
        5376: (21, 16, 16), 10752: (21, 16, 32), 6400: (25, 16, 16),
        12800: (25, 16, 32), 6912: (27, 16, 16), 13824: (27, 16, 32),
        4352: (17, 16, 16), 8704: (17, 16, 32), 4864: (19, 16, 16),
        9728: (19, 16, 32), 5888: (23, 16, 16), 11776: (23, 16, 32)},
    torch.complex128: {
        2048: (8, 16, 16), 4096: (16, 16, 16), 8192: (16, 16, 32),
        1152: (18, 8, 8), 1280: (20, 8, 8), 1536: (24, 8, 8),
        1920: (30, 8, 8), 2304: (18, 8, 16), 2560: (20, 8, 16),
        3072: (24, 8, 16), 3840: (30, 8, 16), 4608: (18, 16, 16),
        5120: (20, 16, 16), 6144: (24, 16, 16), 7680: (30, 16, 16),
        1408: (22, 8, 8), 1792: (28, 8, 8), 2816: (22, 8, 16),
        3584: (28, 8, 16), 5632: (22, 16, 16), 7168: (28, 16, 16),
        1664: (26, 8, 8), 3328: (26, 8, 16), 6656: (26, 16, 16),
        1344: (21, 8, 8), 2688: (21, 8, 16), 5376: (21, 16, 16),
        1600: (25, 8, 8), 3200: (25, 8, 16), 6400: (25, 16, 16),
        1728: (27, 8, 8), 3456: (27, 8, 16), 6912: (27, 16, 16),
        1088: (17, 8, 8), 2176: (17, 8, 16), 4352: (17, 16, 16),
        1216: (19, 8, 8), 2432: (19, 8, 16), 4864: (19, 16, 16),
        1472: (23, 8, 8), 2944: (23, 8, 16), 5888: (23, 16, 16)},
}
#: The longest codelet of a long-line pass, in values.
PASS_MAX = 32
#: The longest line the route holds in one block, in bytes.
LINE_MAX_BYTES = 128 << 10


def _codelet_length(r: int) -> bool:
    return 2 <= r <= PASS_MAX and radix.smooth(r)


#: Bytes of one mbarrier.
_BARRIER_BYTES = 8
#: A mixed line's row padding: one 16-byte step, so that the bulk copies'
#: rows stay 16-byte aligned.
_ROW_PAD_BYTES = 16
#: Shared memory of one SM and what the runtime reserves per block
#: (``fft_long.cuh``'s ``kSmemPerSm``, ``kReserved``).
_SMEM_PER_SM = 233472
_SMEM_RESERVED = 1024


@dataclasses.dataclass(frozen=True)
class LongPlan:
    n: int
    r1: int
    r2: int
    r3: int
    itemsize: int

    @property
    def mixed(self) -> bool:
        """Not a power of two: R1 is the mixed factor."""
        return not radix.is_pow2(self.n)

    @property
    def mixed_r2(self) -> bool:
        """R2 is mixed too: it runs the mixed chain on its own table."""
        return self.mixed and not radix.is_pow2(self.r2)

    @property
    def rmax(self) -> int:
        return max(self.r1, self.r2, self.r3)

    @property
    def table(self) -> int:
        """Length whose W^j, j < table/2, the radix-2 codelets read: the
        largest factor, or the largest power-of-two factor of a mixed N."""
        if self.mixed_r2:
            return self.r3
        return max(self.r2, self.r3) if self.mixed else self.rmax

    @property
    def depth(self) -> int:
        """Line buffers in the block's ring: two where they fit in one
        block's shared memory, else one (``fft_long.cuh``'s
        ``long_depth`` and ``long_mixed_depth``)."""
        return 2 if smem_bytes(self, self.itemsize, 2) \
            <= radix.SMEM_MAX_BYTES else 1

    @property
    def blocks_per_sm(self) -> int:
        """Blocks an SM holds by shared memory, at :attr:`depth`."""
        per_block = smem_bytes(self, self.itemsize, self.depth) \
            + _SMEM_RESERVED
        return max(1, _SMEM_PER_SM // per_block)

    @property
    def threads(self) -> int:
        """Threads of one block.  A power of two: N / RM, so every pass's
        items split evenly and each thread holds RM values.  A mixed
        length: 256, its passes' items walked in rounds of the block; 128
        for complex128 where two blocks share an SM (one block of 256 at
        up to 255 registers a thread fills an SM's registers alone)."""
        if not self.mixed:
            return self.n // self.rmax
        return 128 if self.itemsize == 16 and self.blocks_per_sm >= 2 \
            else 256

    @property
    def pitch(self) -> int:
        """Row pitch of pass 2's output layout (m3, kA); for a mixed N of
        the line's R1 rows of N/R1."""
        if self.mixed:
            return self.r2 * self.r3 + _ROW_PAD_BYTES // self.itemsize
        return self.r1 * self.r2 + 1

    @property
    def line_elems(self) -> int:
        """Elements of one line buffer: N, plus the padding."""
        return (self.r1 if self.mixed else self.r3) * self.pitch

    @property
    def const_elems(self) -> int:
        """TA, TB, TC and the codelet tables."""
        r1, r2, r3 = self.r1, self.r2, self.r3
        return (r1 * r3 + r1 * r2 + r2 * r3 + self.table // 2
                + (r1 if self.mixed else 0) + (r2 if self.mixed_r2 else 0))


def long_plan(n: int, dtype: torch.dtype):
    """The plan of a line length the long route takes: a
    :class:`LongPlan` of :data:`FACTORS`, or a :class:`WidePlan` of
    :data:`WIDE`."""
    wide = WIDE.get(dtype, {}).get(n)
    if wide is not None:
        return WidePlan(n, *wide, dtype.itemsize)
    factors = FACTORS.get(dtype, {}).get(n)
    if factors is None:
        raise ValueError(f"the long route takes N in "
                         f"{sorted(FACTORS.get(dtype, {}))} and "
                         f"{sorted(WIDE.get(dtype, {}))} for {dtype}, "
                         f"got {n}")
    return LongPlan(n, *factors, dtype.itemsize)


@dataclasses.dataclass(frozen=True)
class LongTile:
    depth: int          # line buffers in the block's ring
    smem_bytes: int     # dynamic shared memory of one block


def smem_bytes(plan: LongPlan, itemsize: int, depth: int) -> int:
    """Dynamic shared memory of one block, in the kernel's order: the
    ring's line buffers, the constants, one mbarrier per buffer."""
    return ((depth * plan.line_elems + plan.const_elems) * itemsize
            + depth * _BARRIER_BYTES)


def long_tile(n: int, dtype: torch.dtype) -> LongTile:
    """The ring depth and the shared memory of one block: two line buffers
    where they fit (the next line loads while this one is transformed),
    else one (:attr:`LongPlan.depth`); a wide length's ring of two tiles
    (:attr:`WidePlan.smem_bytes`)."""
    plan = long_plan(n, dtype)
    if isinstance(plan, WidePlan):
        return LongTile(2, plan.smem_bytes)
    return LongTile(plan.depth, smem_bytes(plan, dtype.itemsize, plan.depth))


#: The lengths whose kernels the chirp route's folded load and store
#: also instantiate (``fft_long.cuh``'s ``long_chirp_kernel``: pass 1
#: reads the N-long input lines from global memory times the chirp,
#: zeros past N; pass 3 keeps the first N): the powers of two, per
#: complex dtype (``kernels/chirp.py`` picks M among them).
FOLD_SIZES = {torch.complex64: (8192, 16384),
              torch.complex128: (2048, 4096, 8192)}


def _pass3_fits(plan: LongPlan) -> bool:
    """Whether ptxas keeps a plan with a mixed R2 in registers: pass 3's
    radix-2 codelet of 32 values spills there (H100 build, ``nvcc -Xptxas
    -v``: every complex128 one at 255 registers a thread, and every
    complex64 one at the 128 that the launch bound leaves where two
    blocks share an SM; none of the complex64 ones whose block has an SM
    alone, at up to 255); R3 of 16 and less spills nowhere."""
    return plan.r3 < 32 or (plan.itemsize == 8 and plan.blocks_per_sm == 1)


def rule_factors(n: int, dtype: torch.dtype) -> Optional[tuple]:
    """(R1, R2, R3) with N = R1*R2*R3, R1 and R2 13-smooth codelet lengths
    of at most :data:`PASS_MAX` and R3 a power of two from 2: the largest
    R3 up to 32 for which such an R1 and R2 exist and whose largest such
    R1 (so R1 >= R2) gives a plan that stays in registers
    (:func:`_pass3_fits`); None where there is none."""
    for r3 in (32, 16, 8, 4, 2):
        if n % r3:
            continue
        rest = n // r3
        for r1 in range(PASS_MAX, 1, -1):
            r2 = rest // r1
            if rest % r1 == 0 and r2 <= r1 and _codelet_length(r1) \
                    and _codelet_length(r2):
                if _pass3_fits(LongPlan(n, r1, r2, r3, dtype.itemsize)):
                    return r1, r2, r3
                break
    return None


def _rule(dtype: torch.dtype) -> dict:
    """The rule's lengths: every even 13-smooth N past the radix route
    (not in ``radix.RADIX_SIZES``, nor one of ``radix._SPILLS``, which
    stay dense and, complex64 208, run as the split route's pass B on the
    radix kernel) with a line of at most :data:`LINE_MAX_BYTES` that
    :func:`rule_factors` splits, less the table's."""
    out, taken = {}, set(radix.RADIX_SIZES[dtype])
    for n in range(2, LINE_MAX_BYTES // dtype.itemsize + 1, 2):
        if n in _TABLE[dtype] or n in taken \
                or n in radix._SPILLS[dtype] or not radix.smooth(n):
            continue
        factors = rule_factors(n, dtype)
        if factors is not None:
            out[n] = factors
    return out


#: The lengths the route takes and their (R1, R2, R3), per complex dtype
#: (``radix.kernel_path`` reads this table): :data:`_TABLE`, then the
#: rule's (:func:`_rule`; 90 complex64 lengths from 3168 to 16128 and 135
#: complex128 ones from 792 to 8064, odd parts 33 to 729), whose R2 is
#: mixed too.
FACTORS = {dtype: {**table, **_rule(dtype)}
           for dtype, table in _TABLE.items()}


#: The radix route's lengths whose larger factor (``transforms.factorize``)
#: passes this many values, per complex dtype, are the wide lines: a
#: thread of ``radix_kernel`` holds that codelet in registers, 191-255 of
#: them, so one block fills an SM.
WIDE_FROM = {torch.complex64: 32, torch.complex128: 16}
#: The wide kernel's longest pass-3 codelet: a radix-2 pass of 32 values
#: spills at 128 registers a thread (:func:`_pass3_fits`).
WIDE_R3_MAX = 16
#: Registers a thread the wide kernel's launch bound aims at, per complex
#: element size: complex64 keeps a 32-value codelet in 128, complex128 in
#: up to 255 (``long_mixed_min_blocks``).
_WIDE_REGS = {8: 128, 16: 255}
_SM_REGISTERS = 65536
#: Threads of a wide block: 128, four blocks an SM (complex64) or two
#: (complex128).  The sweep (PERF.md §6) read 256 a block 0-15% slower
#: at complex64 and 3-40% slower at complex128 at most lengths: fewer,
#: larger blocks wait longer at each pass's barrier.
WIDE_THREADS = 128
#: The shortest row a bulk copy brings, in bytes (N/R1 elements), and the
#: shortest line a plan moves: below them the copies of a tile are many
#: and short, and the sweep read the wide kernel behind ``radix_kernel``
#: (complex128 68 to 320: 2-200% slower).
WIDE_ROW_MIN_BYTES = 320
WIDE_LINE_MIN_BYTES = 6144
#: Mixed first codelets the rule never takes: ptxas spilled 20 plans of
#: them at the register cap (PERF.md §6: 28 and 30 x 18-27 x 2-4 at
#: complex64's 128 registers a thread; 26 x 2-6 x 4-16, 28 x 2-16 x 2-16
#: and 30 x 5-13 x 2-4 at complex128's 255), pass 1 holding their values
#: beside its two twiddles; the same codelet in pass 2 (R2) spilled nowhere.
WIDE_R1_SPILLS = (26, 28, 30)
#: The longest first codelet the rule prefers, per complex element size:
#: complex128's codelets of 21 to 27 values in pass 1 read 2-12% slower
#: than a shorter R1 where N has one (c128 420: 21 x 5 x 4 0.4269 ms,
#: 15 x 14 x 2 0.3843 on an H100, PERF.md §6).
WIDE_R1_SOFT = {8: 32, 16: 20}
#: The most lines a tile holds.
WIDE_LT_MAX = 16
#: Wide lines whose pick read less than 1% faster than ``radix_kernel``
#: on the same lines (``route_times.py widepicks``, two readings each,
#: 512 MB on an H100, PERF.md §6): they keep the radix route.  Both
#: kernels run these lines at 1.22-1.28x the HBM bound; no plan or
#: factor feature the sweep saw sets them apart from lines that gain
#: (complex128 672 = 24 x 28 +2.8%, 700 = 25 x 28 -14.4%).
WIDE_RADIX_KEEPS = {torch.complex64: (1056, 1080, 1088),
                    torch.complex128: (512, 576, 624, 660, 672, 768)}


@dataclasses.dataclass(frozen=True)
class WidePlan:
    """A wide line's plan on ``fft_wide.cuh``'s ``wide_kernel``: N =
    R1*R2*R3 (R3 a power of two, R1 and R2 either), a tile of ``lt``
    lines, :data:`WIDE_THREADS` threads a block.  Each line of the tile
    sits in R1 rows of N/R1 at a pitch padded by 16 bytes, as a mixed long
    line's does; the names :func:`constants` reads mean what they mean on
    a :class:`LongPlan`."""
    n: int
    r1: int
    r2: int
    r3: int
    lt: int
    itemsize: int

    @property
    def threads(self) -> int:
        return WIDE_THREADS

    @property
    def mixed(self) -> bool:
        """R1 runs the mixed chain on its own table."""
        return not radix.is_pow2(self.r1)

    @property
    def mixed_r2(self) -> bool:
        """R2 runs the mixed chain on its own table."""
        return not radix.is_pow2(self.r2)

    @property
    def table(self) -> int:
        """The radix-2 codelets' table: the largest power-of-two factor."""
        return max(r for r in (self.r1, self.r2, self.r3)
                   if radix.is_pow2(r))

    @property
    def pitch(self) -> int:
        return self.r2 * self.r3 + _ROW_PAD_BYTES // self.itemsize

    @property
    def line_elems(self) -> int:
        return self.r1 * self.pitch

    @property
    def const_elems(self) -> int:
        r1, r2, r3 = self.r1, self.r2, self.r3
        return (r1 * r3 + r1 * r2 + r2 * r3 + self.table // 2
                + (r1 if self.mixed else 0) + (r2 if self.mixed_r2 else 0))

    @property
    def smem_bytes(self) -> int:
        """The ring's two tiles, the constants, two mbarriers
        (``wide_smem_bytes``)."""
        return ((2 * self.lt * self.line_elems + self.const_elems)
                * self.itemsize + 2 * _BARRIER_BYTES)

    @property
    def min_blocks(self) -> int:
        """The launch bound's blocks an SM: as many as registers allow at
        :data:`_WIDE_REGS` a thread and shared memory holds, at least 1."""
        by_regs = _SM_REGISTERS // (self.threads * _WIDE_REGS[self.itemsize])
        by_smem = _SMEM_PER_SM // (self.smem_bytes + _SMEM_RESERVED)
        return max(1, min(by_regs, by_smem))

    @property
    def items(self) -> tuple:
        """The items of a tile's three passes."""
        return (self.lt * self.r2 * self.r3, self.lt * self.r1 * self.r3,
                self.lt * self.r1 * self.r2)

    @property
    def fill(self) -> float:
        """The least share of the block that a pass's last round keeps
        busy."""
        return min((i - 1) % self.threads + 1 for i in self.items) \
            / self.threads


def _wide_splits(n: int):
    """Every (R1, R2, R3) of a wide line: R3 a power of two from 2 to
    :data:`WIDE_R3_MAX`, R1 >= R2 codelet lengths (``radix.
    codelet_length``) from 2 to :data:`PASS_MAX` (R1 and R2 swapped fill
    the block alike: pass 1 has N/R1 items, pass 2 N/R2)."""
    for r3 in (16, 8, 4, 2):
        if r3 > WIDE_R3_MAX or n % r3:
            continue
        rest = n // r3
        for r1 in range(PASS_MAX, 1, -1):
            r2 = rest // r1
            if rest % r1 == 0 and 2 <= r2 <= r1 \
                    and radix.codelet_length(r1) \
                    and radix.codelet_length(r2):
                yield r1, r2, r3


def _wide_key(plan: WidePlan) -> tuple:
    """The rule's order of plans, best first: an R1 within
    :data:`WIDE_R1_SOFT`; the largest share of the block's thread rounds
    that do work, each pass weighed by its codelet's
    length (a round of pass i costs about R_i loads, stores and
    butterflies a thread: 3*LT*N over the sum of rounds_i * threads *
    R_i); then the fullest last round (:attr:`WidePlan.fill`), the fewest
    lines, the largest R3, and the smallest R1 (the shorter codelets: at
    complex128 400, 10 x 10 x 4 read 0.3885 ms where 20 x 5 x 4 read
    0.4313 on an H100, PERF.md §6)."""
    t, lt = plan.threads, plan.lt
    items = plan.items
    rounds = (-(-items[0] // t) * plan.r1 + -(-items[1] // t) * plan.r2
              + -(-items[2] // t) * plan.r3)
    return (plan.r1 > WIDE_R1_SOFT[plan.itemsize],
            -round(3 * lt * plan.n / (t * rounds), 9), -plan.fill, lt,
            -plan.r3, plan.r1)


def wide_candidates(n: int, dtype: torch.dtype) -> list:
    """Every wide plan of ``n`` at :data:`WIDE_THREADS` a block, best first by
    :func:`_wide_key`: each split of :func:`_wide_splits` whose rows hold
    :data:`WIDE_ROW_MIN_BYTES` and whose R1 is not one of
    :data:`WIDE_R1_SPILLS`, each tile from one line up to the most
    with which an SM still holds the blocks its registers allow (and one
    block's 227 KB); none for a line shorter than
    :data:`WIDE_LINE_MIN_BYTES`."""
    size = dtype.itemsize
    if n * size < WIDE_LINE_MIN_BYTES:
        return []
    want = _SM_REGISTERS // (WIDE_THREADS * _WIDE_REGS[size])
    out = []
    for r1, r2, r3 in _wide_splits(n):
        if r2 * r3 * size < WIDE_ROW_MIN_BYTES or r1 in WIDE_R1_SPILLS:
            continue
        for lt in range(1, WIDE_LT_MAX + 1):
            plan = WidePlan(n, r1, r2, r3, lt, size)
            if lt > 1 and (plan.min_blocks < want
                           or plan.smem_bytes > radix.SMEM_MAX_BYTES):
                break
            out.append((_wide_key(plan), plan))
    return [plan for _, plan in sorted(out, key=lambda e: e[0])]


def _wide(dtype: torch.dtype) -> dict:
    """The wide lines: every length of ``radix.RADIX_SIZES`` whose larger
    factor passes :data:`WIDE_FROM` that has a plan
    (:func:`wide_candidates`) and that :data:`WIDE_RADIX_KEEPS` leaves
    to the radix route, with (R1, R2, R3, LT) of the best."""
    out = {}
    for n in radix.RADIX_SIZES[dtype]:
        if max(factorize(n)) <= WIDE_FROM[dtype] \
                or n in WIDE_RADIX_KEEPS[dtype]:
            continue
        cands = wide_candidates(n, dtype)
        if cands:
            p = cands[0]
            out[n] = (p.r1, p.r2, p.r3, p.lt)
    return out


#: The wide lines the long route takes from the radix route and their
#: (R1, R2, R3, LT), per complex dtype (``radix.kernel_path``
#: reads this table; the radix kernel keeps their strided layout and the
#: split route's rows of them).
WIDE = {dtype: _wide(dtype) for dtype in _TABLE}


def _w(n: int, e: np.ndarray, sign: float) -> np.ndarray:
    return np.exp(sign * 2j * np.pi * e / n)


def constants(n: int, dtype: torch.dtype, inverse: bool,
              plan=None) -> np.ndarray:
    """TA, TB, TC and the codelet tables, row-major, one complex128 array
    built in float64: TA[k1, m3] = W_N^(k1*m3), TB[k1, m2] =
    W_N^(k1*m2*R3), TC[k2, m3] = W_(R2*R3)^(k2*m3), W[j] = W_table^j
    (j < table/2, :attr:`LongPlan.table`), then for a mixed N the mixed
    codelet's own W_R1^j, j < R1, and where R2 is mixed too its own
    W_R2^j, j < R2 (a wide plan: W_R1 where R1 is mixed, W_R2 where R2
    is).  ``plan`` forces a plan of N in place of :func:`long_plan`'s."""
    p = plan or long_plan(n, dtype)
    sign = 1.0 if inverse else -1.0
    k1 = np.arange(p.r1, dtype=np.float64)[:, None]
    k2 = np.arange(p.r2, dtype=np.float64)[:, None]
    m2 = np.arange(p.r2, dtype=np.float64)[None, :]
    m3 = np.arange(p.r3, dtype=np.float64)[None, :]
    ta = _w(n, k1 * m3, sign)
    tb = _w(n, k1 * m2 * p.r3, sign)
    tc = _w(p.r2 * p.r3, k2 * m3, sign)
    w = _w(p.table, np.arange(p.table // 2, dtype=np.float64), sign)
    parts = [ta.reshape(-1), tb.reshape(-1), tc.reshape(-1), w]
    if p.mixed:
        parts.append(_w(p.r1, np.arange(p.r1, dtype=np.float64), sign))
    if p.mixed_r2:
        parts.append(_w(p.r2, np.arange(p.r2, dtype=np.float64), sign))
    return np.concatenate(parts)


def _codelet(values: list, length: int, plan: LongPlan, w: torch.Tensor,
             wm: Optional[torch.Tensor] = None, sign: float = -1.0) -> list:
    """Load order bit- (or digit-) reversed (``radix.load_slot``), then the
    radix-2 stages on the ``plan.table``-entry table ``w``, as
    ``fft_radix.cuh``'s ``fft_stages``, or a mixed length's chain on its
    own table ``wm`` (``mixed_stages``): natural order out."""
    v = [None] * length
    for i, val in enumerate(values):
        v[radix.load_slot(i, length)] = val
    if radix.is_pow2(length):
        return radix._run_codelet(v, radix.codelet(length, plan.table), w)
    return radix.run_codelet(v, length, radix.mixed_codelet(length), wm,
                             sign)


def _epilogue(v: list, plan: LongPlan, b: int, ka: torch.Tensor, *,
              inverse: bool, twiddle: Optional[torch.Tensor],
              pack_parts: Optional[int], scaled: bool) -> torch.Tensor:
    """Pass 3's store: out[kA + R1*R2*k3] = v[k3] times the output twiddle
    and 1/N, into the (parts, B, N/parts) buffer."""
    n, q = plan.n, plan.r1 * plan.r2
    cdt, dev = v[0].dtype, v[0].device
    parts = pack_parts or 1
    seg = n // parts
    scale = 1.0 / n if inverse and scaled else 1.0
    tw = None if twiddle is None else twiddle.to(dev, cdt).reshape(-1)
    out = torch.empty(parts * b * seg, dtype=cdt, device=dev)
    line = torch.arange(b, device=dev)[:, None]
    for k3 in range(plan.r3):
        o = ka + q * k3
        y = v[k3] if tw is None else v[k3] * tw[o]
        out[((o // seg) * b + line) * seg + o % seg] = y * scale
    if pack_parts is None:
        return out.reshape(b, n)
    return out.reshape(parts, b, seg)


def emulate(x: torch.Tensor, *, inverse: bool = False,
            twiddle: Optional[torch.Tensor] = None,
            pack_parts: Optional[int] = None,
            scaled: bool = True,
            plan: Optional[WidePlan] = None) -> torch.Tensor:
    """Run the long kernel's three passes and index maps in torch, every
    line (a wide length: every tile) at once: ``x`` is contiguous ``(B,
    N)``.  Returns what the kernel writes: ``(B, N)``, or the ``(p, B,
    N/p)`` buffer with ``pack_parts``.  ``scaled=False`` leaves out the
    inverse's 1/N, as the split route's pass B launches it
    (``kernels/split.py``); ``plan`` forces a wide plan of N (one of
    :func:`wide_candidates`) in place of :func:`long_plan`'s."""
    b, n = x.shape
    cdt, dev = x.dtype, x.device
    p = plan or long_plan(n, cdt)
    r1, r2, r3 = p.r1, p.r2, p.r3
    m1_stride, q = n // r1, r1 * r2
    consts = torch.from_numpy(constants(n, cdt, inverse, p)).to(dev, cdt)
    sizes = [r1 * r3, r1 * r2, r2 * r3, p.table // 2]
    ta, tb, tc, w, *wm = torch.split(
        consts, sizes + ([r1] if p.mixed else [])
        + ([r2] if p.mixed_r2 else []))
    epilogue = dict(inverse=inverse, twiddle=twiddle, pack_parts=pack_parts,
                    scaled=scaled)
    if p.mixed or isinstance(p, WidePlan):
        return _emulate_rows(x, p, ta, tb, tc, w,
                             wm[0] if p.mixed else None,
                             wm[-1] if p.mixed_r2 else None,
                             1.0 if inverse else -1.0, epilogue)
    # the line buffer, as the bulk copy leaves it: x in natural order
    s = torch.zeros((b, p.line_elems), dtype=cdt, device=dev)
    s[:, :n] = x

    # pass 1: item mb = m2*R3 + m3, in place
    mb = torch.arange(m1_stride, device=dev)
    m2, m3 = mb // r3, mb % r3
    v = _codelet([s[:, m1 * m1_stride + mb] for m1 in range(r1)], r1, p, w)
    for k1 in range(r1):
        y = v[k1] if k1 == 0 else v[k1] * (ta[k1 * r3 + m3] * tb[k1 * r2 + m2])
        s[:, k1 * m1_stride + mb] = y

    # pass 2: item (k1, m3); every value loaded before any is stored
    item = torch.arange(r1 * r3, device=dev)
    k1, m3 = item // r3, item % r3
    v = _codelet([s[:, k1 * m1_stride + m2 * r3 + m3] for m2 in range(r2)],
                 r2, p, w)
    for k2 in range(r2):
        y = v[k2] if k2 == 0 else v[k2] * tc[k2 * r3 + m3]
        s[:, m3 * p.pitch + k1 + r1 * k2] = y

    # pass 3: item kA = k1 + R1*k2, the epilogue on the store
    ka = torch.arange(q, device=dev)
    v = _codelet([s[:, m3 * p.pitch + ka] for m3 in range(r3)], r3, p, w)
    return _epilogue(v, p, b, ka, **epilogue)


def _emulate_rows(x: torch.Tensor, p, ta, tb, tc, w, wm1, wm2,
                  sign: float, epilogue: dict) -> torch.Tensor:
    """The mixed long kernel's passes (one line a block) and the wide
    kernel's (a tile of ``p.lt`` lines): each line in R1 rows of N/R1 at
    the padded pitch, every pass in place, item (line of the tile, item)
    by item.  ``wm1`` and ``wm2`` are the mixed codelets' own tables, W_R1
    and W_R2 (None for a power of two).  The last tile's lines past B are
    zeros here and their outputs are dropped (the kernel copies and walks
    only the lines it holds)."""
    b, n = x.shape
    r1, r2, r3, pitch, line = p.r1, p.r2, p.r3, p.pitch, p.line_elems
    lt = getattr(p, "lt", 1)
    m1n, q, dev = r2 * r3, r1 * r2, x.device
    tiles = -(-b // lt)
    xt = torch.zeros((tiles * lt, n), dtype=x.dtype, device=dev)
    xt[:b] = x
    # the tile buffer, as the row copies leave it
    s = torch.zeros((tiles, lt * line), dtype=x.dtype, device=dev)
    rows = (torch.arange(lt, device=dev)[:, None, None] * line
            + torch.arange(r1, device=dev)[None, :, None] * pitch
            + torch.arange(m1n, device=dev)[None, None, :])
    s[:, rows.reshape(-1)] = xt.reshape(tiles, lt * n)

    # pass 1: item (l, mb), mb = m2*R3 + m3, reads (l, m1, mb), writes
    # (l, k1, mb)
    it = torch.arange(lt * m1n, device=dev)
    mb = it % m1n
    at = (it // m1n) * line + mb
    m2, m3 = mb // r3, mb % r3
    v = _codelet([s[:, at + m1 * pitch] for m1 in range(r1)], r1, p, w,
                 wm1, sign)
    for k1 in range(r1):
        y = v[k1] if k1 == 0 else v[k1] * (ta[k1 * r3 + m3] * tb[k1 * r2 + m2])
        s[:, at + k1 * pitch] = y

    # pass 2: item (l, k1, m3) reads (l, k1, m2, m3), writes (l, k1, k2,
    # m3); a mixed R2 loads digit-reversed and runs its chain on W_R2
    it = torch.arange(lt * r1 * r3, device=dev)
    item = it % (r1 * r3)
    k1, m3 = item // r3, item % r3
    col = (it // (r1 * r3)) * line + k1 * pitch + m3
    v = _codelet([s[:, col + m2 * r3] for m2 in range(r2)], r2, p, w, wm2,
                 sign)
    for k2 in range(r2):
        y = v[k2] if k2 == 0 else v[k2] * tc[k2 * r3 + m3]
        s[:, col + k2 * r3] = y

    # pass 3: item (l, kA), kA = k1 + R1*k2, reads (l, k1, k2, m3)
    it = torch.arange(lt * q, device=dev)
    ka = it % q
    k2, k1 = ka // r1, ka % r1
    run = (it // q) * line + k1 * pitch + k2 * r3
    v = _codelet([s[:, run + m3] for m3 in range(r3)], r3, p, w)
    v = [vk.reshape(tiles * lt, q)[:b] for vk in v]
    return _epilogue(v, p, b, torch.arange(q, device=dev), **epilogue)
