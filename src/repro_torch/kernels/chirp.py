"""The chirp-z route of the four-step kernel: every line length that no
other route takes, as Bluestein's convolution over two transforms of a
13-smooth length M that the dense or the split route runs.

The radix, long-line and split routes take every N = r*2^k, r in
``radix.EVERY_ROUTE_ODD`` = {3, 5, 7, 9, 11, 13, 15, 17, 19, 21, 23, 25,
27}, to their limits; the other 13-smooth odd parts (33 to 63, and from
65) run on the radix route where both factors of N fit a codelet
(``radix.RADIX_ODD``), on the long-line route up to its 128 KB line
where three codelets of at most 32 take N (``longline.rule_factors``)
and on the split route past one block (``split.rule_factors`` where a P
of its pass A and a radix or long-line row Q hold N = P*Q, and
``split.general_factors`` for every other 13-smooth N, and past the split
route's old limit ``split.nested_factors``, rows of any route); the dense
route takes every other N up to ``dense.DENSE_LIMIT`` (complex64 4835,
complex128 2419) whose generic stages, one per prime factor past 13,
cost no more than this route would (``dense.GENERIC_COST``), and every
other 13-smooth N whose line fits one block.  So
the lengths left here have a prime factor past 13 that no codelet and no
nested plan takes (such as the primes 4831, 10007, 20011 and 8388617,
3232 = 101*32, 7424 = 29*256 and 2^24 + 1 = 97*257*673).  On the CPU the
route runs :func:`emulate`; on the card two counted transforms.

For a length N that no other route takes (``takes``), the DFT with sign s
(-1 forward, +1 inverse) is, with 2nk = n^2 + k^2 - (k - n)^2 and the
chirp c[n] = exp(s*i*pi*n^2/N),

    X[k] = c[k] * sum_n (x[n] c[n]) * conj(c[k - n]),

a linear convolution of N values with a filter of 2N - 1, computed as a
cyclic one of M >= 2N - 1 (:func:`chirp_plan`) in two transforms:

1. the forward transform of M, whose load reads the N-long input lines
   at pitch N, multiplies them by the chirp and reads zeros past N, and
   whose ``twiddle`` epilogue multiplies by the transformed filter B =
   DFT_M(b), b[m] = conj(c[m]) at m and M - m for m < N;
2. the inverse transform of M (1/M), whose ``twiddle`` epilogue
   multiplies by the output chirp c[k] (1/N for the inverse direction,
   and the caller's own twiddle: :func:`post_twiddle`) and whose store
   keeps only k < N, at pitch N, in the ``pack_parts`` segments.

So the route moves about 2N + 2M elements a line, with no pass of glue.
M is the cheapest 13-smooth length at or above 2N - 1 that a route with
that load and store runs (``dense.GENERIC_COST``'s "chirp" costs per
element of M, fit on an H100 to the route forced at candidate M:
``scripts/route_times.py chirpm``, then ``fit``): the dense
route's kernel where one line of M fits a block (``fft_dense.cuh``'s
``dense_chirp_kernel``), the long-line route at its powers of two
(``longline.FOLD_SIZES``: ``fft_long.cuh``'s ``long_chirp_kernel``, pass
1 reading the input, pass 3 keeping the first N), else a split plan of
M = P*Q with pass A on the
dense kernel's column form (``dense_column_chirp_kernel``), the rows on
their own route and pass C ``split_transpose_keep_kernel``
(``split.any_factors``, dense columns only).  M stays within the
kernels' 32-bit line index (``split.LINE_MAX``), so N up to
``split.MAX_LENGTH`` = 2^30 but for the last N below it whose M would
pass 2^31 - 1.  The chirp's phase pi*n^2/N is taken with n^2 mod 2N in
integers and the tables built in float64 (:func:`constants`), so
complex64 keeps it at large N.

:func:`emulate` runs the same steps and index maps over the inner
routes' plain versions; it is this route's plain version.
"""
from __future__ import annotations

import bisect
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

@dataclasses.dataclass(frozen=True)
class ChirpPlan:
    n: int
    m: int
    route: str                  # M's route: "dense", "long" or "split"
    split: Optional[object] = None  # split.SplitPlan of M on "split"


@functools.lru_cache(maxsize=1)
def _smooth_lengths() -> Tuple[int, ...]:
    """Every 13-smooth length up to ``split.LINE_MAX``, ascending."""
    from .split import LINE_MAX
    out = [1]
    for p in (2, 3, 5, 7, 11, 13):
        grown = []
        for v in out:
            while v <= LINE_MAX:
                grown.append(v)
                v *= p
        out = grown
    return tuple(sorted(out))


def route_cost(m: int, route: str, dtype: torch.dtype) -> float:
    """The two transforms' cost per element of M on ``route``
    (``dense.GENERIC_COST[dtype]["chirp"]``): on the dense route's kernel
    a base per tile (lines of M sharing a block or one a block) plus a
    weight per stage of M's chain and one per share of a block's shared
    memory that a line of M fills; a constant on the long-line route and
    on a split plan."""
    from .dense import GENERIC_COST, chain, dense_plan
    from .radix import SMEM_MAX_BYTES
    cost = GENERIC_COST[dtype]["chirp"]
    if route == "dense":
        tile = "share" if dense_plan(m, dtype).lines > 1 else "line"
        return (cost[tile] + cost["stage"] * len(chain(m))
                + cost["fill"] * m * dtype.itemsize / SMEM_MAX_BYTES)
    return cost[route]


def inner_plan(n: int, m: int, dtype: torch.dtype) -> Optional[ChirpPlan]:
    """The route of the chirp's transforms of ``m`` for lines of ``n``:
    the dense route's kernel where one line of M fits a block, else a
    split plan of M with pass A on the dense kernel's columns
    (``split.any_factors``); None where neither takes M."""
    from . import dense, longline, radix, split
    if not radix.smooth(m) or m > split.LINE_MAX:
        return None
    if m in longline.FOLD_SIZES.get(dtype, ()):
        return ChirpPlan(n, m, "long")
    if dense.fits(m, dtype):
        return ChirpPlan(n, m, "dense")
    factors = split.any_factors(m, dtype, dense_only=True)
    if factors is None:
        return None
    p, q, col = factors
    return ChirpPlan(n, m, "split", split.SplitPlan(m, p, q, "any", col))


@functools.lru_cache(maxsize=1 << 16)
def chirp_plan(n: int, dtype: torch.dtype) -> Optional[ChirpPlan]:
    """M and its route for lines of ``n``: of the 13-smooth M from 2N - 1
    up to the next power of two (which always has a route), the one whose
    cost (M times :func:`route_cost`) is least, the least M of two as
    cheap.  None where no M within ``split.LINE_MAX`` has a route."""
    from .dense import GENERIC_COST
    from .radix import SMEM_MAX_BYTES
    if dtype not in GENERIC_COST or n < 1:
        return None
    per_m = GENERIC_COST[dtype]["chirp"]
    lengths = _smooth_lengths()
    lo = max(2 * n - 1, 2)
    best, best_cost = None, float("inf")
    for m in lengths[bisect.bisect_left(lengths, lo):]:
        # past one block's line only a split plan takes M
        cheapest = (min(per_m["long"], per_m["split"],
                        min(per_m["share"], per_m["line"]) + per_m["stage"])
                    if m * dtype.itemsize <= SMEM_MAX_BYTES
                    else per_m["split"])
        if m * cheapest >= best_cost or m > 2 * lo:
            break
        plan = inner_plan(n, m, dtype)
        if plan is None:
            continue
        cost = m * route_cost(m, plan.route, dtype)
        if cost < best_cost:
            best, best_cost = plan, cost
    return best


def max_chirp_length() -> int:
    """The longest N whose M (at least 2N - 1) stays within
    ``split.LINE_MAX``: half the longest 13-smooth length there."""
    return (_smooth_lengths()[-1] + 1) // 2


def chirp_length(n: int, dtype: torch.dtype = torch.complex64) -> int:
    """M of :func:`chirp_plan`, or 0 where no M has a route."""
    plan = chirp_plan(n, dtype)
    return plan.m if plan is not None else 0


def takes(n: int, dtype: torch.dtype) -> bool:
    """Whether the chirp route takes lines of ``n`` (``radix.kernel_path``
    asks after the radix, long-line and split routes, the split route's
    rule, general and nested plans included): every N up to
    ``split.MAX_LENGTH`` the dense route does not take (``dense.takes``:
    generic stages dearer than this route, past ``dense.DENSE_LIMIT`` a
    prime factor past 13) and the split route does not
    (``split.takes``), whose M has a route (:func:`chirp_plan`)."""
    from .dense import DENSE_LIMIT, takes as dense_takes
    from .split import MAX_LENGTH, takes as split_takes
    if dtype not in DENSE_LIMIT or not 1 <= n <= MAX_LENGTH:
        return False
    return (not dense_takes(n, dtype) and not split_takes(n, dtype)
            and chirp_plan(n, dtype) is not None)


def constants(n: int, inverse: bool, m: int
              ) -> Tuple[np.ndarray, ...]:
    """(the input chirp (N,), the transformed filter B (M,), the output
    chirp (N,)), complex128 built in float64: c[k] = exp(s*i*pi*(k^2 mod
    2N)/N); B = DFT_M of conj(c) placed at m and M - m; the output chirp
    c[k] (times 1/N for the inverse)."""
    sign = 1.0 if inverse else -1.0
    k = np.arange(n, dtype=np.int64)
    c = np.exp(sign * 1j * np.pi * ((k * k) % (2 * n)).astype(np.float64)
               / n)
    b = np.zeros(m, dtype=np.complex128)
    b[:n] = np.conj(c)
    b[m - n + 1:] = np.conj(c[1:])[::-1]
    return c, np.fft.fft(b), c / n if inverse else c


def post_twiddle(post: torch.Tensor, twiddle: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """The second transform's epilogue: the output chirp, times the
    caller's ``twiddle``."""
    return post if twiddle is None else post * twiddle


def folded_load(x: torch.Tensor, pre: torch.Tensor, m: int
                ) -> torch.Tensor:
    """The first transform's load on the dense route: ``(B, M)`` lines,
    index e < N read from x's lines at pitch N times ``pre``[e], zero
    past N."""
    b, n = x.shape
    a = torch.zeros((b, m), dtype=x.dtype, device=x.device)
    a[:, :n] = x * pre
    return a


def folded_store(y: torch.Tensor, n: int, pack_parts: Optional[int]
                 ) -> torch.Tensor:
    """The second transform's store on the dense route: outputs k < N of
    each ``(B, M)`` line, ``(B, N)`` or the ``(p, B, N/p)`` buffer with
    ``pack_parts``."""
    b = y.shape[0]
    if pack_parts is None:
        return y[:, :n].contiguous()
    p = pack_parts
    return y[:, :n].reshape(b, p, n // p).transpose(0, 1).contiguous()


def emulate(x: torch.Tensor, *, inverse: bool = False,
            twiddle: Optional[torch.Tensor] = None,
            pack_parts: Optional[int] = None,
            plan: Optional[ChirpPlan] = None) -> torch.Tensor:
    """The route's two transforms with their folded load and store over
    the inner routes' plain versions: ``x`` is contiguous ``(B, N)``.
    Returns what the route writes: ``(B, N)``, or the ``(p, B, N/p)``
    buffer with ``pack_parts``.  ``plan`` forces M and its route
    (:func:`inner_plan`)."""
    from . import dense, longline, split
    n = x.shape[1]
    plan = plan or chirp_plan(n, x.dtype)
    pre, filt, post = (torch.from_numpy(t).to(x.device, x.dtype)
                       for t in constants(n, inverse, plan.m))
    if twiddle is not None:
        twiddle = twiddle.to(x.device, x.dtype).reshape(-1)
    out_tw = post_twiddle(post, twiddle)
    if plan.route == "split":
        a = split.emulate_plan(x, plan.split, twiddle=filt, pre=pre)
        return split.emulate_plan(a, plan.split, inverse=True,
                                  twiddle=out_tw, pack_parts=pack_parts,
                                  keep=n)
    route = longline if plan.route == "long" else dense
    a = route.emulate(folded_load(x, pre, plan.m), twiddle=filt)
    tw_m = torch.zeros(plan.m, dtype=x.dtype, device=x.device)
    tw_m[:n] = out_tw
    y = route.emulate(a, inverse=True, twiddle=tw_m)
    return folded_store(y, n, pack_parts)
