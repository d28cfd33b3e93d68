"""The radix path of the four-step kernel: its plan, its tiles and their
index maps, in Python.

For a power-of-two N = N1*N2 (``transforms.factorize``) the kernel
(``csrc/fft_radix.cuh``) computes the four steps with in-register
codelets instead of dense DFT-matrix products:

* column pass — a thread holds one (line, m2) column x[m1*N2 + m2],
  m1 < N1, in registers, transforms it with a radix-2 codelet of length
  N1, multiplies by T[k1, m2] = W_N^(k1*m2) and stores it in the tile in
  shared memory at (line, k1, m2);
* row pass — a thread holds one (line, k1) row of the tile, m2 < N2,
  transforms it with a codelet of length N2 and writes
  out[k1 + N1*k2] with the epilogue (the output twiddle, 1/N, the
  ``pack_parts`` segment store).

A codelet of length L is the iterative radix-2 decimation in time: the
input sits in bit-reversed order, and stage s (m = 2^s, h = m/2) does the
butterflies (b+j, b+j+h) for b a multiple of m and j < h, the lower
input multiplied by W_m^j = w[j * N2/m], where w[k] = W_N2^k for k < N2/2
is the one table both codelets share (N1 divides N2).  The loops unroll
fully in the kernel (N1 and N2 are template parameters), so every index
is a constant and the values stay in registers.

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
#: Lengths the kernel instantiates, per complex dtype.  complex128 stops at
#: 1024: a codelet of 64 complex128 values would take 256 registers and
#: spill, so 2048 and 4096 take the long-line route (three passes); N = 2,
#: whose complex128 kernel ptxas spills (4 bytes at 64 registers), stays
#: on the dense path.
RADIX_SIZES = {
    torch.complex64: tuple(2 ** k for k in range(1, 13)),
    torch.complex128: tuple(2 ** k for k in range(2, 11)),
}


def kernel_path(n: int, dtype: torch.dtype) -> str:
    """"radix" when the kernel has a codelet instantiation for ``n`` and
    ``dtype``, "long" for the longer power-of-two lines the long-line
    route takes (``longline.FACTORS``), "split" for the power-of-two lines
    longer than one block holds (``split.FACTORS``: two passes through
    HBM), else "dense" (the general four-step, any N)."""
    if n in RADIX_SIZES.get(dtype, ()):
        return "radix"
    # deferred: longline and split import this module
    from .longline import FACTORS as LONG
    from .split import FACTORS as SPLIT
    if n in LONG.get(dtype, {}):
        return "long"
    return "split" if n in SPLIT.get(dtype, {}) else "dense"


def bitrev(i: int, bits: int) -> int:
    """``i`` with its low ``bits`` bits reversed."""
    r = 0
    for _ in range(bits):
        r = (r << 1) | (i & 1)
        i >>= 1
    return r


Butterfly = Tuple[int, int, Optional[int]]   # (top, bottom, w index or None)


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


@dataclasses.dataclass(frozen=True)
class RadixPlan:
    n: int
    n1: int
    n2: int
    column: List[List[Butterfly]]   # codelet of length n1
    row: List[List[Butterfly]]      # codelet of length n2


def radix_plan(n: int) -> RadixPlan:
    """The factorization and both codelets of a power-of-two ``n``."""
    if n < 2 or n & (n - 1):
        raise ValueError(f"the radix path takes a power of two N >= 2, "
                         f"got {n}")
    n1, n2 = factorize(n)
    return RadixPlan(n, n1, n2, codelet(n1, n2), codelet(n2, n2))


@dataclasses.dataclass(frozen=True)
class RadixTile:
    lines: int          # lines (or inner indices) per tile, a power of two
    strided: bool
    smem_bytes: int     # dynamic shared memory of one block


def const_elems(n: int, twiddle: bool) -> int:
    """Constants the kernel keeps in shared memory: T (N), the codelet
    table (N2/2) and the optional output twiddle (N)."""
    _, n2 = factorize(n)
    return n + n2 // 2 + (n if twiddle else 0)


def tile_elems(n: int, lines: int, strided: bool) -> int:
    n1, n2 = factorize(n)
    return lines * n if strided else lines * n1 * (n2 + 1)


def radix_tile(n: int, itemsize: int, twiddle: bool,
               strided: bool) -> Optional[RadixTile]:
    """The tile of the radix kernel for lines of length ``n``, or None
    when the layout does not fit (strided tiles of N >= 2048 complex64,
    N >= 1024 complex128).

    Lines: as many lines as give every thread a row (THREADS / N1), halved
    until two blocks share an SM.  Strided: ``STRIDED_LINES`` inner
    indices, within the 227 KB of one block."""
    n1, _ = factorize(n)
    const = const_elems(n, twiddle)
    if strided:
        lines = STRIDED_LINES
        need = (const + tile_elems(n, lines, True)) * itemsize
        if need > SMEM_MAX_BYTES:
            return None
        return RadixTile(lines, True, need)
    lines = max(1, THREADS // n1)
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


def codelet_table(n: int, inverse: bool) -> np.ndarray:
    """w[k] = exp(sign*2*pi*i*k/N2), k < N2/2, built in float64."""
    _, n2 = factorize(n)
    sign = 1.0 if inverse else -1.0
    k = np.arange(n2 // 2, dtype=np.float64)
    return np.exp(sign * 2j * np.pi * k / n2)


def _run_codelet(v: list, stages, w: torch.Tensor) -> list:
    for stage in stages:
        for top, bot, wi in stage:
            t = v[bot] if wi is None else v[bot] * w[wi]
            v[top], v[bot] = v[top] + t, v[top] - t
    return v


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
    bits1 = int(math.log2(n1))
    v = [None] * n1
    for m1 in range(n1):
        addr = torch.where(valid, base + (m1 * n2 + m2) * js, 0)
        v[bitrev(m1, bits1)] = torch.where(valid, mem[addr], 0)
    v = _run_codelet(v, plan.column, w)
    smem = torch.zeros((ntiles, tile_elems(n, lines, strided)), dtype=cdt,
                       device=x.device)
    for k1 in range(n1):
        idx = (l * sl + k1 * sr + m2 * sc).expand(ntiles, -1)
        smem.scatter_(1, idx, v[k1] * t_tab[k1 * n2 + m2])

    # row pass: item r -> (l, k1), reads the tile row, writes k1 + N1*k2
    r = torch.arange(lines * n1, device=x.device).unsqueeze(0)
    l, k1 = row_item(r, lines, n1, strided or rows)
    valid, base, js = line_of(tiles, l)
    bits2 = int(math.log2(n2))
    v = [None] * n2
    for j in range(n2):
        idx = (l * sl + k1 * sr + j * sc).expand(ntiles, -1)
        v[bitrev(j, bits2)] = smem.gather(1, idx)
    v = _run_codelet(v, plan.row, w)
    out = torch.zeros(outer * n * inner, dtype=cdt, device=x.device)
    scale = 1.0 / n_line if inverse and split_twiddle is None else 1.0
    tw = None if twiddle is None else twiddle.to(x.device, cdt).reshape(-1)
    line = tiles * lines + l
    if split_twiddle is not None:
        tables, ql_log2 = split_twiddle
        ql, qh = 1 << ql_log2, inner >> ql_log2
        q = (tiles % groups) * lines + l
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
