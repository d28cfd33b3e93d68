"""The chirp-z route of the four-step kernel: every line length that no
other route takes, as Bluestein's convolution over the power-of-two
routes.

The radix, long-line and split routes take every N = r*2^k, r in
``radix.EVERY_ROUTE_ODD`` = {3, 5, 7, 9, 11, 13, 15, 17, 19, 21, 23, 25,
27}, to their limits; the other 13-smooth odd parts (33 to 63, and from
65) run on the radix route where both factors of N fit a codelet
(``radix.RADIX_ODD``), on the long-line route up to its 128 KB line
where three codelets of at most 32 take N (``longline.rule_factors``)
and on the split route past one block (``split.rule_factors`` where a P
of its pass A and a radix or long-line row Q hold N = P*Q, and
``split.general_factors`` for every other 13-smooth N); the dense route
takes every other N up to ``dense.DENSE_LIMIT`` (complex64
4835, complex128 2419) whose generic stages, one per prime factor past
13, cost no more than this route would (``dense.GENERIC_COST``: their
sum against M/N and M), and every other 13-smooth N whose line fits one
block (complex64 23040 = 45*512 and 16896 = 33*512).  So the lengths
left here have a prime factor past 13 that no codelet takes (such as the
primes 4831, 10007 and 20011, 3232 = 101*32, and 7424 = 29*256), and
none is 13-smooth.  On the CPU the route
runs :func:`emulate`; on the card two counted launches of the radix,
long-line or split route with the PyTorch glue around them.

For a length N that no other route takes (``takes``), the DFT with sign s
(-1 forward, +1 inverse) is, with 2nk = n^2 + k^2 - (k - n)^2 and the
chirp c[n] = exp(s*i*pi*n^2/N),

    X[k] = c[k] * sum_n (x[n] c[n]) * conj(c[k - n]),

a linear convolution of N values with a filter of 2N - 1, computed as a
cyclic one of M, the least power of two >= 2N - 1 (:func:`chirp_length`),
in four steps:

1. the input times the chirp, zero-padded to M (:func:`premultiply`,
   PyTorch glue);
2. the kernel's forward transform of the M-long lines, whose ``twiddle``
   epilogue multiplies by the transformed filter B = DFT_M(b), b[m] =
   conj(c[m]) at m and M - m for m < N;
3. the kernel's inverse transform (1/M), whose ``twiddle`` epilogue
   multiplies by the output chirp c[k] (1/N for the inverse direction,
   and the caller's own twiddle, :func:`post_twiddle`; 0 past N);
4. the first N of each line (:func:`trim`, glue), stored destination-major
   with ``pack_parts``.

M takes the radix route (a short N with a large prime factor, such as
complex64 101: M = 256), the long-line or the split route, so the route
reaches N up to half the split route's longest length: 2^23 for complex64,
2^21 for complex128 (:func:`max_length`).  The chirp's phase pi*n^2/N is
taken with n^2 mod 2N in integers and the tables built in float64
(:func:`constants`), so complex64 keeps it at large N.

Both transforms are launches of the port's kernel (``fft_matmul._launch``
counts each on the "chirp" path); only steps 1 and 4 are PyTorch.
:func:`emulate` runs the same steps over the inner routes' plain versions
(``fft_matmul.fft_fourstep_plain``); it is this route's plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def chirp_length(n: int) -> int:
    """M, the least power of two >= 2N - 1."""
    return 1 << (2 * n - 2).bit_length()


def max_length(dtype: torch.dtype) -> int:
    """The longest N the route takes: M within the split route's lengths."""
    from .split import FACTORS
    return max(FACTORS[dtype]) // 2 if dtype in FACTORS else 0


def takes(n: int, dtype: torch.dtype) -> bool:
    """Whether the chirp route takes lines of ``n`` (``radix.kernel_path``
    asks after the radix, long-line and split routes, the split route's
    rule and general plans included): every N the dense route does not
    take (``dense.takes``: generic stages dearer than this route, past
    ``dense.DENSE_LIMIT`` a prime factor past 13) and the split route's
    general plans do not (``split.general_factors``: every 13-smooth line
    past one block), up to :func:`max_length`."""
    from .dense import DENSE_LIMIT, takes as dense_takes
    from .split import general_factors
    if dtype not in DENSE_LIMIT:
        return False
    return (n <= max_length(dtype) and not dense_takes(n, dtype)
            and general_factors(n, dtype) is None)


def constants(n: int, inverse: bool) -> Tuple[np.ndarray, ...]:
    """(the input chirp (N,), the transformed filter B (M,), the output
    chirp (M,)), complex128 built in float64: c[k] = exp(s*i*pi*(k^2 mod
    2N)/N); B = DFT_M of conj(c) placed at m and M - m; the output chirp
    c[k] for k < N (times 1/N for the inverse), 0 after."""
    m = chirp_length(n)
    sign = 1.0 if inverse else -1.0
    k = np.arange(n, dtype=np.int64)
    c = np.exp(sign * 1j * np.pi * ((k * k) % (2 * n)).astype(np.float64)
               / n)
    b = np.zeros(m, dtype=np.complex128)
    b[:n] = np.conj(c)
    b[m - n + 1:] = np.conj(c[1:])[::-1]
    post = np.zeros(m, dtype=np.complex128)
    post[:n] = c / n if inverse else c
    return c, np.fft.fft(b), post


def premultiply(x: torch.Tensor, pre: torch.Tensor, m: int) -> torch.Tensor:
    """Step 1: ``(B, M)`` lines, x times the chirp, then zeros."""
    b, n = x.shape
    a = torch.empty((b, m), dtype=x.dtype, device=x.device)
    torch.mul(x, pre, out=a[:, :n])
    a[:, n:].zero_()
    return a


def post_twiddle(post: torch.Tensor, twiddle: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """Step 3's epilogue: the output chirp, times the caller's ``twiddle``
    on its first N entries."""
    if twiddle is None:
        return post
    n = twiddle.shape[0]
    out = post.clone()
    out[:n] *= twiddle
    return out


def trim(y: torch.Tensor, n: int, pack_parts: Optional[int]) -> torch.Tensor:
    """Step 4: the first N of each ``(B, M)`` line: ``(B, N)``, or the
    ``(p, B, N/p)`` buffer with ``pack_parts``."""
    b = y.shape[0]
    if pack_parts is None:
        return y[:, :n].contiguous()
    p = pack_parts
    return y[:, :n].reshape(b, p, n // p).transpose(0, 1).contiguous()


def emulate(x: torch.Tensor, *, inverse: bool = False,
            twiddle: Optional[torch.Tensor] = None,
            pack_parts: Optional[int] = None) -> torch.Tensor:
    """The route's four steps with the inner transforms' plain versions:
    ``x`` is contiguous ``(B, N)``.  Returns what the route writes: ``(B,
    N)``, or the ``(p, B, N/p)`` buffer with ``pack_parts``."""
    from .fft_matmul import fft_fourstep_plain    # it imports this module
    n = x.shape[1]
    m = chirp_length(n)
    pre, filt, post = (torch.from_numpy(t).to(x.device, x.dtype)
                       for t in constants(n, inverse))
    if twiddle is not None:
        twiddle = twiddle.to(x.device, x.dtype).reshape(-1)
    a = fft_fourstep_plain(premultiply(x, pre, m), twiddle=filt)
    y = fft_fourstep_plain(a, inverse=True,
                           twiddle=post_twiddle(post, twiddle))
    return trim(y, n, pack_parts)
