"""The dense route of the four-step kernel: its plan, its shared-memory
layout and its plain version, in Python.

"dense" is the route's name (``radix.kernel_path``,
``fft_fourstep.path_launches``), kept from the dense DFT-matrix kernel it
replaced; the method is a mixed-radix FFT.  The route takes every N up to
:data:`DENSE_LIMIT` that the radix, long-line and split routes do not and
whose generic stages cost no more than the chirp route would (odd N, N
with small prime factors past 13, the even 13-smooth N that no codelets
of those routes hold, and ``radix._SPILLS``), and every other 13-smooth
N whose line and tables fit one block's shared memory (:func:`takes`:
complex64 to 28431, complex128 to 14196).  The chirp route takes the N
with dearer prime factors.  On the CPU it runs :func:`emulate`; on the
card one launch of ``csrc/fft_dense.cuh``.  The split route's general
plans (``split.general_factors``) run pass B on this route's launch and
pass A, where N has no power-of-two P, on the same kernel's column form
(:func:`column_plan`; :func:`emulate`'s ``columns=``).

A block holds ``lines`` whole lines in shared memory and transforms them
in place, by decimation in frequency, over the chain of
:func:`dense_plan` (the primes past 13 first, then the 13s, 11s, 7s, 5s
and 3s, then the 2s as 4s and a last 2: ``radix.radices``' order).  The
chain is the kernel's argument, so one kernel per dtype serves every
length.  Stage t of radix r and span s (the product of the radices after
it) does, for every block g of r*s values of a line and j < s, the
r-point DFT of v[g*r*s + j + q*s], q < r, and multiplies its output k by
W_N^(j*k*M), M the product of the radices before it (W_(r*s)^(j*k)); it
stores output k where input k was read.  After the last stage the output
X[k], k = k_0 + r_0*(k_1 + r_1*(k_2 + ...)), sits at sum_t k_t * s_t.

* A codelet stage (r = 2, 3, 4, 5, 7, 11, 13) holds each butterfly's r
  values in registers: the radix route's constant rotations
  (``radix._dft_small``; ``fft_radix.cuh``'s ``dft3``..``dft_odd``).
* A generic stage (a prime p past 13) computes each output as a p-term
  sum over its inputs with W_p^((q*k) mod p) from a table of p entries,
  into a second buffer, which then holds the line: O(N*p), where the
  dense matrices cost O(N*(N1+N2)) before.
* The twiddle W_N^e, e < N, is TA[e mod T] * TB[e div T], two tables of
  T = 2^t_log2 >= sqrt(N) and ceil(N / T) entries built in float64.
* The output permutation is two tables of ints, PL over the first stages'
  digits and PH over the rest: X[k] sits at PL[k mod L] + PH[k div L].
* The store walks k in natural order with the epilogues: the output
  twiddle (read from global memory), 1/N for the inverse, the
  ``pack_parts`` segment.

:func:`constants` builds the tables the kernel copies into shared memory:
a complex buffer (TA, TB, then the generic stages' W_p tables) and an
int32 buffer (per stage its radix, span, M and W_p offset; then PL, PH).
:func:`emulate` runs the same stages, index maps, twiddle products and
store order in torch, every butterfly of a stage at once.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import radix
from . import chirp

#: Threads of one block, per complex element size: (narrow, wide), the
#: wide count for a tile whose shared memory leaves no room for a second
#: block on its SM (``fft_dense.cuh``'s kDenseNarrow* and kDenseWide*).
THREADS = {8: (256, 512), 16: (128, 256)}
#: The longest chain the kernel's stage table takes.
MAX_STAGES = 16
#: Lines of at most this many elements share a block: the most lines (a
#: power of two) whose elements stay within it.
TILE_ELEMS = 4096
#: Columns of one tile of the split route's pass A on this kernel
#: (:func:`column_plan`), tried in order: 16 (a warp's loads and stores
#: then run over 128 bytes of complex64, 256 of complex128), halved until
#: the tile and its tables fit one block.
COLUMN_LINES = (16, 8, 4)
#: A generic stage sums its p terms in chunks of this many, each chunk's
#: sum then added to the total (``fft_dense.cuh``'s ``kGenericChunk``):
#: the error grows with p/16 + 16 additions, not p.
GENERIC_CHUNK = 16
#: The longest N of every length the route takes, per complex dtype: the
#: one-block limit of the dense DFT-matrix kernel this route replaced
#: (its W1, T, output twiddle, W2 and one line of G in 227 KB).  Up to it
#: the route takes every N whose generic stages cost no more than the
#: chirp route (:data:`GENERIC_COST`); past it only 13-smooth N
#: (:func:`takes`).  The chirp route takes the rest up to its limit.
DENSE_LIMIT = {torch.complex64: 4835, torch.complex128: 2419}
#: The costs that :func:`takes` compares, per complex dtype, in units of
#: the time that one unit of :func:`generic_sum` adds per element of an
#: even N (a generic stage of p sums p terms for each output): the dense
#: route's (base, weight) per parity of N, its time per element being
#: base + weight * generic_sum (complex128's generic stages ran slower in
#: odd N), and the chirp route's time per element of its M-long lines
#: ("chirp", ``chirp.route_cost``): its two transforms on the dense
#: route's kernel, a base per tile (lines of M sharing a block, "share",
#: or one line a block, "line") plus a weight per stage of M's chain and
#: one per share of a block's shared memory that a line of M fills
#: ("fill"), on the long-line route at its powers of two, or on a split
#: plan of M.
#: ``chirp.chirp_plan`` takes the M whose cost is least.  Fit on an H100
#: to both routes forced on the same lines (``scripts/route_times.py
#: generic``) and to the chirp forced at candidate M (``chirpm``), then
#: ``fit``; PERF.md has the readings.
GENERIC_COST = {
    torch.complex64: {"even": (19.00, 1), "odd": (15.03, 1.025),
                      "chirp": {"share": 20.29, "line": 18.97,
                                "stage": 3.35, "fill": 25.82,
                                "long": 20.55, "split": 74.05}},
    torch.complex128: {"even": (30.62, 1), "odd": (1.07, 1.747),
                       "chirp": {"share": 14.68, "line": 18.41,
                                 "stage": 7.57, "fill": 45.14,
                                 "long": 28.38, "split": 109.67}},
}
#: The chirp route takes an N up to :data:`DENSE_LIMIT` only where
#: :data:`GENERIC_COST` puts it this factor cheaper than the dense route:
#: over the swept lengths (``route_times.py fit`` over ``generic`` and
#: ``chirpm``) the factor whose worst loss either way is least: 3 lengths
#: left the dense route for a chirp at most 7.4% slower and 6 stayed on a
#: dense route at most 11.3% slower (at 1.0: 11.8% and 4.3%; at 1.15: none
#: and 25.7%).  No factor puts all 32 held-out lengths (``check``) on
#: their faster route (c64 4240 wants one below 0.907, c64 423 one above
#: 1.018).  At 1.1 c128 1504 keeps its dense route, 14.9% slower than a
#: chirp; 1.0, which moves it, also moves c128 1984, 235 and 536 to
#: chirps 6.5-11.8% slower than their dense route.
MOVE_MARGIN = 1.1


def chain(n: int) -> Tuple[int, ...]:
    """The radix chain of a line of ``n``, first stage first: the primes
    past 13, largest first, then ``radix.radices``' chain of the rest (the
    13s, 11s, 7s, 5s, 3s, then 4s and a last 2); () for N = 1."""
    rough, m, p = [], n, 2
    while p * p <= m:
        while m % p == 0:
            if p > 13:
                rough.append(p)
            m //= p
        p += 1
    if m > 13:
        rough.append(m)
    rest = n // math.prod(rough)
    if rest == 1:
        tail = ()
    elif radix.is_pow2(rest):
        # 4s and a last 2, as in a mixed chain
        a = rest.bit_length() - 1
        tail = (4,) * (a // 2) + (2,) * (a % 2)
    else:
        tail = radix.radices(rest)
    return tuple(sorted(rough, reverse=True)) + tail


@dataclasses.dataclass(frozen=True)
class DensePlan:
    n: int
    radices: Tuple[int, ...]    # the chain, first stage first
    spans: Tuple[int, ...]      # s_t: the product of the radices after t
    muls: Tuple[int, ...]       # M_t: the product of the radices before t
    t_log2: int                 # TA has 2^t_log2 entries
    lo: int                     # PL's entries: the first lo_stages' radices
    lo_stages: int
    lines: int                  # lines per block
    itemsize: int
    pitch: int = 0              # the tile's line pitch; 0: n

    @property
    def line_pitch(self) -> int:
        return self.pitch or self.n

    @property
    def tb_len(self) -> int:
        return -(-self.n >> self.t_log2) if self.n else 0

    @property
    def hi(self) -> int:
        return self.n // self.lo

    @property
    def generic(self) -> Tuple[int, ...]:
        """The stages past 13 (a prime each), by index."""
        return tuple(t for t, r in enumerate(self.radices) if r > 13)

    @property
    def buffers(self) -> int:
        """Tile buffers: one for a 13-smooth N, transformed in place; a
        generic stage writes a second."""
        return 2 if self.generic else 1

    @property
    def n_consts(self) -> int:
        """Complex constants: TA, TB and one W_p table per generic
        stage."""
        return (1 << self.t_log2) + self.tb_len + sum(
            self.radices[t] for t in self.generic)

    @property
    def n_ints(self) -> int:
        """Ints: four per stage (radix, span, M, W_p offset), PL, PH."""
        return 4 * len(self.radices) + self.lo + self.hi

    @property
    def buf_offset(self) -> int:
        """Byte offset of the tile: the constants, then the ints, each
        padded to 16 bytes."""
        return _pad16(self.n_consts * self.itemsize) + _pad16(4 * self.n_ints)

    @property
    def smem_bytes(self) -> int:
        return (self.buf_offset
                + self.buffers * self.lines * self.line_pitch
                * self.itemsize)

    @property
    def threads(self) -> int:
        """The block's threads: the narrow count where blocks share an SM,
        the wide one where one block has it alone."""
        narrow, wide = THREADS[self.itemsize]
        return wide if self.smem_bytes > radix.SMEM_TARGET_BYTES else narrow


def _pad16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _layout(n: int, itemsize: int, lines: int) -> DensePlan:
    rs = chain(n)
    if len(rs) > MAX_STAGES:
        raise ValueError(f"dense route: N={n} has {len(rs)} stages, more "
                         f"than the kernel's {MAX_STAGES}")
    spans = tuple(math.prod(rs[t + 1:]) for t in range(len(rs)))
    muls = tuple(math.prod(rs[:t]) for t in range(len(rs)))
    # PL over the first stages, PH over the rest: the split whose two
    # tables are the smallest
    lo_stages = min(range(len(rs) + 1),
                    key=lambda a: math.prod(rs[:a]) + n // math.prod(rs[:a]))
    return DensePlan(n=n, radices=rs, spans=spans, muls=muls,
                     t_log2=((n - 1).bit_length() + 1) // 2,
                     lo=math.prod(rs[:lo_stages]), lo_stages=lo_stages,
                     lines=lines, itemsize=itemsize)


def fits(n: int, dtype: torch.dtype) -> bool:
    """Whether one line of ``n`` with its tables fits one block."""
    if n < 1 or n * dtype.itemsize > radix.SMEM_MAX_BYTES:
        return False
    return _layout(n, dtype.itemsize, 1).smem_bytes <= radix.SMEM_MAX_BYTES


def generic_sum(n: int) -> int:
    """s: the sum of the primes past 13 in N's chain, each a generic stage
    that costs O(N*p); 0 for a 13-smooth N."""
    return sum(p for p in chain(n) if p > 13)


def takes(n: int, dtype: torch.dtype) -> bool:
    """Whether the route takes lines of ``n`` (``radix.kernel_path`` asks
    after the radix, long-line and split routes): every N up to
    :data:`DENSE_LIMIT` whose generic stages cost no more than the chirp
    route would, and past it the 13-smooth N whose line fits one block.

    The costs per line, in :data:`GENERIC_COST`'s units: N times the
    dense route's base plus its weight times :func:`generic_sum`, against
    :data:`MOVE_MARGIN` times M times the chirp route's cost per element
    of M (``chirp.chirp_plan``'s M and ``chirp.route_cost``)."""
    if dtype not in DENSE_LIMIT:
        return False
    if 1 <= n <= DENSE_LIMIT[dtype]:
        s = generic_sum(n)
        if s == 0:
            return True
        plan = chirp.chirp_plan(n, dtype)
        base, weight = GENERIC_COST[dtype]["odd" if n % 2 else "even"]
        return plan is None or (base + weight * s) * n <= (
            MOVE_MARGIN * chirp.route_cost(plan.m, plan.route, dtype)
            * plan.m)
    return radix.smooth(n) and fits(n, dtype)


@functools.lru_cache(maxsize=None)
def dense_plan(n: int, dtype: torch.dtype) -> DensePlan:
    """The chain, the tables' sizes and the tile of lines of ``n``: the
    most lines (a power of two) within :data:`TILE_ELEMS` elements, halved
    until two blocks share an SM; one line past that.  Raises
    ``ValueError`` past the route's domain (:func:`takes`)."""
    if not takes(n, dtype):
        raise ValueError(f"the dense route takes N up to "
                         f"{DENSE_LIMIT.get(dtype)} whose generic stages "
                         f"cost no more than the chirp route and the "
                         f"13-smooth N whose line fits one block, not "
                         f"N={n} ({dtype})")
    lines = 1 << (max(1, TILE_ELEMS // n).bit_length() - 1)
    plan = _layout(n, dtype.itemsize, lines)
    while plan.lines > 1 and plan.smem_bytes > radix.SMEM_TARGET_BYTES:
        plan = dataclasses.replace(plan, lines=plan.lines // 2)
    return plan


@functools.lru_cache(maxsize=None)
def column_plan(p: int, dtype: torch.dtype) -> Optional[DensePlan]:
    """Pass A's layout on this kernel for the split route's general plans
    (``split.general_factors``; ``fft_dense.cuh``'s
    ``dense_column_kernel``):
    the chain of P, a tile of :data:`COLUMN_LINES` consecutive columns of a
    ``(B, P, Q)`` block (the first count whose tile and tables fit one
    block), its lines P + 1 apart for an even P (P for an odd one) so that
    consecutive columns do not share a bank; None where no count fits or
    P is not 13-smooth."""
    if (p < 2 or not radix.smooth(p)
            or p * COLUMN_LINES[-1] * dtype.itemsize > radix.SMEM_MAX_BYTES):
        return None
    for lines in COLUMN_LINES:
        plan = dataclasses.replace(_layout(p, dtype.itemsize, lines),
                                   pitch=p | 1)
        if plan.smem_bytes <= radix.SMEM_MAX_BYTES:
            return plan
    return None


def _w(n: int, e: np.ndarray, sign: float) -> np.ndarray:
    return np.exp(sign * 2j * np.pi * e.astype(np.float64) / n)


def digits_position(k: int, radices: Tuple[int, ...],
                    spans: Tuple[int, ...]) -> int:
    """Where a stage chain leaves output ``k``: its digits in the chain's
    mixed radix, the first stage's least significant, each weighted by its
    stage's span."""
    pos = 0
    for r, s in zip(radices, spans):
        pos += (k % r) * s
        k //= r
    return pos


def constants(plan: DensePlan, inverse: bool
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(the complex tables, complex128 built in float64: TA[i] = W_N^i, i
    < T; TB[i] = W_N^(i*T); then W_p^m, m < p, per generic stage; the
    int32 tables: per stage radix, span, M and its W_p table's offset (0
    for a codelet stage), then PL and PH)."""
    n, sign = plan.n, 1.0 if inverse else -1.0
    t = 1 << plan.t_log2
    parts = [_w(n, np.arange(t), sign),
             _w(n, np.arange(plan.tb_len) * t, sign)]
    off, offsets = t + plan.tb_len, []
    for r in plan.radices:
        if r > 13:
            parts.append(_w(r, np.arange(r), sign))
            offsets.append(off)
            off += r
        else:
            offsets.append(0)
    rs, ss = plan.radices, plan.spans
    a = plan.lo_stages
    pl = [digits_position(k, rs[:a], ss[:a]) for k in range(plan.lo)]
    ph = [digits_position(k, rs[a:], ss[a:]) for k in range(plan.hi)]
    stages = [v for st in zip(rs, ss, plan.muls, offsets) for v in st]
    return (np.concatenate(parts),
            np.array(stages + pl + ph, dtype=np.int32))


def emulate(x: torch.Tensor, *, inverse: bool = False,
            twiddle: Optional[torch.Tensor] = None,
            pack_parts: Optional[int] = None,
            columns: Optional[Tuple[torch.Tensor, int]] = None
            ) -> torch.Tensor:
    """The kernel's stages, index maps, twiddle products and store order
    in torch on contiguous ``(B, N)`` lines, every butterfly of a stage at
    once.  Returns what the kernel writes: ``(B, N)``, or the ``(p, B,
    N/p)`` buffer with ``pack_parts``.

    The split route's pass A (``fft_dense.cuh``'s
    ``dense_column_kernel``): ``columns=(tables, w_log2)`` takes ``x`` as
    a contiguous ``(B, P, Q)`` block and transforms its P-long columns,
    output kp of column q times W_N^(kp*q) = WA[e mod W] * WB[e div W], e
    = kp*q, W = 2^w_log2, from ``tables`` (WA then WB), unscaled, in the
    same layout."""
    if columns is not None:
        tables, w_log2 = columns
        b, p, q = x.shape
        y = _chain(x.transpose(1, 2).reshape(b * q, p), inverse)
        e = (torch.arange(q, device=x.device)[:, None]
             * torch.arange(p, device=x.device)[None, :])
        w = tables[e & ((1 << w_log2) - 1)] * tables[(1 << w_log2)
                                                      + (e >> w_log2)]
        return (y.reshape(b, q, p) * w).transpose(1, 2).contiguous()
    b, n = x.shape
    cdt, dev = x.dtype, x.device
    y = _chain(x, inverse)
    if twiddle is not None:
        y = y * twiddle.to(device=dev, dtype=cdt).reshape(-1)
    if inverse:
        y = y * (1.0 / n)
    if pack_parts is None:
        return y
    return y.reshape(b, pack_parts, n // pack_parts).transpose(0, 1) \
        .contiguous()


def _chain(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The kernel's stages and store order on contiguous ``(B, N)`` lines,
    without the epilogues: ``(B, N)`` in natural order."""
    buf, pos = staged(x, inverse)
    return buf[:, pos]


def staged(x: torch.Tensor, inverse: bool
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's stages on contiguous ``(B, N)`` lines, in place, as
    they leave the lines in shared memory: ``(B, N)`` in the chain's
    order, and where output k of a line sits, PL[k mod lo] + PH[k div
    lo] (``(N,)``, int64)."""
    b, n = x.shape
    plan = dense_plan(n, x.dtype)
    cdt, dev = x.dtype, x.device
    cplx, ints = constants(plan, inverse)
    tabs = torch.from_numpy(cplx).to(device=dev, dtype=cdt)
    t = 1 << plan.t_log2
    ta, tb = tabs[:t], tabs[t:t + plan.tb_len]
    sign = 1.0 if inverse else -1.0
    buf = x
    for st, (r, s, mul) in enumerate(zip(plan.radices, plan.spans,
                                         plan.muls)):
        v = buf.reshape(b, n // (r * s), r, s)
        a = [v[:, :, q, :] for q in range(r)]
        if r > 13:
            # out k = sum_q a_q * W_p^((q*k) mod p), from the W_p table;
            # the sum in complex128, so that it stays a yardstick for the
            # kernel's (in chunks of GENERIC_CHUNK terms) at large p
            off = int(ints[4 * st + 3])
            q = np.arange(r)
            idx = torch.from_numpy((np.outer(q, q) % r).astype(np.int64))
            w = tabs[off:off + r][idx.to(dev)].to(torch.complex128)
            y = torch.matmul(torch.stack(a, dim=-1).to(torch.complex128),
                             w).to(cdt)
            out = [y[..., k] for k in range(r)]
        else:
            out = radix._dft_small(a, sign)
        if s > 1:
            j = torch.arange(s, device=dev)
            for k in range(1, r):
                e = j * (k * mul)
                out[k] = out[k] * (ta[e & (t - 1)] * tb[e >> plan.t_log2])
        buf = torch.stack(out, dim=2).reshape(b, n)
    k = torch.arange(n, device=dev)
    tabs_i = torch.from_numpy(ints.astype(np.int64)).to(dev)
    base = 4 * len(plan.radices)
    pl, ph = tabs_i[base:base + plan.lo], tabs_i[base + plan.lo:]
    return buf, pl[k % plan.lo] + ph[k // plan.lo]
