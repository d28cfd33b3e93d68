"""The long-line route of the four-step kernel: its plan, its shared-memory
layouts and their index maps, in Python.

Power-of-two lines too long for the radix route's two in-register passes
(complex64 N of 8192 and 16384, complex128 N of 2048 to 8192) still fit
whole in one block's shared memory.  The kernel (``csrc/fft_long.cuh``)
holds one line there and transforms it in three passes over
N = R1*R2*R3, each an in-register radix-2 codelet of length at most 32
(:data:`FACTORS`).  With the input index m = m1*(R2*R3) + m2*R3 + m3 and
the output index k = k1 + R1*k2 + R1*R2*k3 (decimation in frequency):

* pass 1 — item mb = m2*R3 + m3: the R1 values x[m1*(N/R1) + mb], a
  codelet of length R1, times W_N^(k1*mb) = TA[k1, m3] * TB[k1, m2],
  stored back where they were read (k1*(N/R1) + mb);
* pass 2 — item (k1, m3): the R2 values at k1*(N/R1) + m2*R3 + m3, a
  codelet of length R2, times TC[k2, m3] = W_(R2*R3)^(k2*m3), stored at
  m3*PITCH + k1 + R1*k2 with PITCH = R1*R2 + 1, so that pass 3 reads
  along consecutive addresses;
* pass 3 — item kA = k1 + R1*k2: the R3 values at m3*PITCH + kA, a codelet
  of length R3, and out[kA + R1*R2*k3] with the epilogue (the output
  twiddle, 1/N, the ``pack_parts`` segment store).

TA (R1 x R3), TB (R1 x R2) and TC (R2 x R3) are the two-level factors of
the inter-pass twiddles, and W (RM/2 entries, RM the largest factor) the
codelets' table; all are built in float64 (:func:`constants`).  A block
of N/RM threads holds RM values each in every pass, so pass 2 loads all
of them before it stores any.

:func:`emulate` runs exactly these passes and index maps in torch; it is
the kernel's plain version (``fft_matmul.fft_fourstep_plain`` takes it
for these N), and the CPU tests hold it against ``np.fft`` and the JAX
package's kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from . import radix

#: The lengths the route takes and their (R1, R2, R3), per complex dtype:
#: power-of-two lines past ``radix.RADIX_SIZES`` whose whole line fits in
#: one block's shared memory (``radix.kernel_path`` reads this table).
#: Codelets of at most 32 values: ptxas keeps 32 complex128 values in
#: registers (the radix route's 32x32 instantiation does), not 64.
FACTORS = {
    torch.complex64: {8192: (16, 16, 32), 16384: (16, 32, 32)},
    torch.complex128: {2048: (8, 16, 16), 4096: (16, 16, 16),
                       8192: (16, 16, 32)},
}
#: Bytes of one mbarrier.
_BARRIER_BYTES = 8


@dataclasses.dataclass(frozen=True)
class LongPlan:
    n: int
    r1: int
    r2: int
    r3: int

    @property
    def rmax(self) -> int:
        return max(self.r1, self.r2, self.r3)

    @property
    def threads(self) -> int:
        """Threads of one block: each holds ``rmax`` values per pass."""
        return self.n // self.rmax

    @property
    def pitch(self) -> int:
        """Row pitch of pass 2's output layout (m3, kA)."""
        return self.r1 * self.r2 + 1

    @property
    def line_elems(self) -> int:
        """Elements of one line buffer: N, plus pass 2's padding."""
        return self.r3 * self.pitch

    @property
    def const_elems(self) -> int:
        """TA, TB, TC and the codelet table."""
        r1, r2, r3 = self.r1, self.r2, self.r3
        return r1 * r3 + r1 * r2 + r2 * r3 + self.rmax // 2


def long_plan(n: int, dtype: torch.dtype) -> LongPlan:
    """The three factors of a line length the long route takes."""
    factors = FACTORS.get(dtype, {}).get(n)
    if factors is None:
        raise ValueError(f"the long route takes N in "
                         f"{sorted(FACTORS.get(dtype, {}))} for {dtype}, "
                         f"got {n}")
    return LongPlan(n, *factors)


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
    else one.  ``fft_long.cuh``'s ``long_depth`` works out the same."""
    plan = long_plan(n, dtype)
    depth = 2 if smem_bytes(plan, dtype.itemsize, 2) <= radix.SMEM_MAX_BYTES \
        else 1
    return LongTile(depth, smem_bytes(plan, dtype.itemsize, depth))


def _w(n: int, e: np.ndarray, sign: float) -> np.ndarray:
    return np.exp(sign * 2j * np.pi * e / n)


def constants(n: int, dtype: torch.dtype, inverse: bool) -> np.ndarray:
    """TA, TB, TC and the codelet table, row-major, one complex128 array
    built in float64: TA[k1, m3] = W_N^(k1*m3), TB[k1, m2] =
    W_N^(k1*m2*R3), TC[k2, m3] = W_(R2*R3)^(k2*m3), W[j] = W_RM^j."""
    p = long_plan(n, dtype)
    sign = 1.0 if inverse else -1.0
    k1 = np.arange(p.r1, dtype=np.float64)[:, None]
    k2 = np.arange(p.r2, dtype=np.float64)[:, None]
    m2 = np.arange(p.r2, dtype=np.float64)[None, :]
    m3 = np.arange(p.r3, dtype=np.float64)[None, :]
    ta = _w(n, k1 * m3, sign)
    tb = _w(n, k1 * m2 * p.r3, sign)
    tc = _w(p.r2 * p.r3, k2 * m3, sign)
    w = _w(p.rmax, np.arange(p.rmax // 2, dtype=np.float64), sign)
    return np.concatenate([ta.reshape(-1), tb.reshape(-1), tc.reshape(-1),
                           w])


def _codelet(values: list, length: int, plan: LongPlan, w: torch.Tensor
             ) -> list:
    """Load order bit-reversed, then the radix-2 stages: natural order
    out, as ``fft_radix.cuh``'s ``fft_stages`` with the RM-entry table."""
    bits = int(math.log2(length))
    v = [None] * length
    for i, val in enumerate(values):
        v[radix.bitrev(i, bits)] = val
    return radix._run_codelet(v, radix.codelet(length, plan.rmax), w)


def emulate(x: torch.Tensor, *, inverse: bool = False,
            twiddle: Optional[torch.Tensor] = None,
            pack_parts: Optional[int] = None,
            scaled: bool = True) -> torch.Tensor:
    """Run the long kernel's three passes and index maps in torch, every
    line at once: ``x`` is contiguous ``(B, N)``.  Returns what the kernel
    writes: ``(B, N)``, or the ``(p, B, N/p)`` buffer with
    ``pack_parts``.  ``scaled=False`` leaves out the inverse's 1/N, as the
    split route's pass B launches it (``kernels/split.py``)."""
    b, n = x.shape
    cdt, dev = x.dtype, x.device
    p = long_plan(n, cdt)
    r1, r2, r3 = p.r1, p.r2, p.r3
    m1_stride, q = n // r1, r1 * r2
    consts = torch.from_numpy(constants(n, cdt, inverse)).to(dev, cdt)
    ta, tb, tc, w = torch.split(consts, [r1 * r3, r1 * r2, r2 * r3,
                                         p.rmax // 2])
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
    parts = pack_parts or 1
    seg = n // parts
    scale = 1.0 / n if inverse and scaled else 1.0
    tw = None if twiddle is None else twiddle.to(dev, cdt).reshape(-1)
    out = torch.empty(parts * b * seg, dtype=cdt, device=dev)
    line = torch.arange(b, device=dev)[:, None]
    for k3 in range(r3):
        o = ka + q * k3
        y = v[k3] if tw is None else v[k3] * tw[o]
        out[((o // seg) * b + line) * seg + o % seg] = y * scale
    if pack_parts is None:
        return out.reshape(b, n)
    return out.reshape(parts, b, seg)
