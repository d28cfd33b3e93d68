"""Local (on-device) 1-D C2C transforms on torch tensors.

Three interchangeable backends (``LOCAL_BACKENDS``), each the counterpart of
one of the JAX package's (``REFERENCE_BACKEND`` records the mapping):

* ``"cufft"``  — ``torch.fft.fft``/``ifft`` (cuFFT on the GPU, pocketfft on
  the CPU).  It plays the role ``jnp.fft`` (``"xla"``) plays in the
  reference: the library path and the numerical oracle.
* ``"matmul"`` — the four-step factorization N = N1*N2 as two small
  DFT-matrix contractions plus a twiddle, on separate real/imag planes,
  written with ``torch.einsum``.  float32 contractions run in full float32
  (``torch.backends.cuda.matmul.allow_tf32`` is False by default; TF32
  would keep only 10 mantissa bits).
* ``"kernel"`` — the same four-step algorithm as a hand-written CUDA kernel
  (``kernels/fft_matmul.py``, wrapped by ``kernels/ops.py``).  A CPU tensor
  runs the kernel's plain PyTorch version instead.

Only the C2C kinds (``fft``/``ifft``) are ported so far; R2C and R2R kinds
raise ``NotImplementedError``.  The complex working dtype follows the input:
float64/complex128 stay in double precision on every backend.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

C2C_KINDS = ("fft", "ifft")
R2C_KINDS = ("rfft", "irfft")
R2R_KINDS = ("dct2", "dct3", "dst2", "dst3")
ALL_KINDS = C2C_KINDS + R2C_KINDS + R2R_KINDS

#: Every local-FFT backend ``apply_1d`` accepts.
LOCAL_BACKENDS = ("cufft", "matmul", "kernel")

#: Port backend -> the JAX package's backend of the same role.
REFERENCE_BACKEND = {"cufft": "xla", "matmul": "matmul", "kernel": "pallas"}
#: The JAX package's backend -> the port's (reads reference wisdom records).
FROM_REFERENCE_BACKEND = {v: k for k, v in REFERENCE_BACKEND.items()}


def complex_dtype(dtype: torch.dtype) -> torch.dtype:
    """The complex dtype matching ``dtype``'s precision."""
    if dtype in (torch.float64, torch.complex128):
        return torch.complex128
    return torch.complex64


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The real dtype of a complex dtype's planes."""
    return torch.float64 if complex_dtype(dtype) == torch.complex128 \
        else torch.float32


def factorize(n: int) -> Tuple[int, int]:
    """Split n = n1*n2 with n1 <= n2, n1 as close to sqrt(n) as possible.

    Balanced factors minimize the four-step flop count n*(n1+n2).  A prime
    n degrades to (1, n) — a single dense DFT, still correct.
    """
    best = (1, n)
    for n1 in range(int(math.isqrt(n)), 0, -1):
        if n % n1 == 0:
            best = (n1, n // n1)
            break
    return best


@functools.lru_cache(maxsize=64)
def _dft_planes(n: int, sign: float, dtype: str) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) planes of the DFT matrix W[j,k] = exp(sign*2pi*i*j*k/n).

    Built in float64 and cast down so float32 runs see a well-rounded
    operand rather than accumulated single-precision phase error.
    """
    k = np.arange(n, dtype=np.float64)
    theta = (sign * 2.0 * np.pi / n) * np.outer(k, k)
    return (np.cos(theta).astype(dtype), np.sin(theta).astype(dtype))


@functools.lru_cache(maxsize=64)
def _twiddle_planes(n1: int, n2: int, sign: float, dtype: str):
    """T[k1, m2] = exp(sign*2pi*i*k1*m2/(n1*n2)) — the four-step twiddle."""
    n = n1 * n2
    k1 = np.arange(n1, dtype=np.float64)
    m2 = np.arange(n2, dtype=np.float64)
    theta = (sign * 2.0 * np.pi / n) * np.outer(k1, m2)
    return (np.cos(theta).astype(dtype), np.sin(theta).astype(dtype))


def _cmatmul(ar, ai, br, bi, *, side: str):
    """Complex matmul via 4 real contractions on (..., rows, cols) planes.

    side="left":  result = B @ A   (contract A's rows with B's cols)
    side="right": result = A @ B
    """
    if side == "left":
        rr = torch.einsum("kn,...nm->...km", br, ar)
        ri = torch.einsum("kn,...nm->...km", br, ai)
        ir = torch.einsum("kn,...nm->...km", bi, ar)
        ii = torch.einsum("kn,...nm->...km", bi, ai)
    else:
        rr = torch.einsum("...kn,nm->...km", ar, br)
        ri = torch.einsum("...kn,nm->...km", ar, bi)
        ir = torch.einsum("...kn,nm->...km", ai, br)
        ii = torch.einsum("...kn,nm->...km", ai, bi)
    return rr - ii, ri + ir


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(like.device)


def fourstep_fft_planes(xr: torch.Tensor, xi: torch.Tensor, *,
                        inverse: bool = False):
    """Four-step FFT along the last axis of real/imag planes (..., N).

    X[k1 + N1*k2] = sum_{m2} W_N2^{m2 k2} [ W_N^{m2 k1}
                        sum_{m1} x[m1*N2 + m2] W_N1^{m1 k1} ]
    """
    n = xr.shape[-1]
    n1, n2 = factorize(n)
    sign = 1.0 if inverse else -1.0
    dt = str(xr.dtype).removeprefix("torch.")

    w1r, w1i = (_const(p, xr) for p in _dft_planes(n1, sign, dt))
    w2r, w2i = (_const(p, xr) for p in _dft_planes(n2, sign, dt))
    tr, ti = (_const(p, xr) for p in _twiddle_planes(n1, n2, sign, dt))

    # (..., N) -> (..., N1, N2): row m1, col m2  (n = m1*N2 + m2)
    xr = xr.reshape(xr.shape[:-1] + (n1, n2))
    xi = xi.reshape(xi.shape[:-1] + (n1, n2))

    # step 1: DFT_N1 over m1 (left-multiply) -> F1[k1, m2]
    f1r, f1i = _cmatmul(xr, xi, w1r, w1i, side="left")
    # step 2: twiddle W_N^{k1 m2}
    g_r = f1r * tr - f1i * ti
    g_i = f1r * ti + f1i * tr
    # step 3: DFT_N2 over m2 (right-multiply, W2 symmetric) -> F2[k1, k2]
    f2r, f2i = _cmatmul(g_r, g_i, w2r, w2i, side="right")
    # step 4: X[k1 + N1*k2]  ->  layout [k2, k1], then flatten
    outr = f2r.transpose(-1, -2).reshape(xr.shape[:-2] + (n,))
    outi = f2i.transpose(-1, -2).reshape(xi.shape[:-2] + (n,))
    if inverse:
        outr = outr / n
        outi = outi / n
    return outr, outi


def _matmul_fft(x: torch.Tensor, *, inverse: bool) -> torch.Tensor:
    """Complex-in/complex-out last-axis FFT via the four-step matmul path."""
    rdt = real_dtype(x.dtype)
    if x.is_complex():
        xr, xi = x.real.to(rdt), x.imag.to(rdt)
    else:
        xr = x.to(rdt)
        xi = torch.zeros_like(xr)
    outr, outi = fourstep_fft_planes(xr, xi, inverse=inverse)
    return torch.complex(outr, outi)


def _c2c(x: torch.Tensor, axis: int, *, inverse: bool,
         backend: str) -> torch.Tensor:
    if backend == "cufft":
        x = x.to(complex_dtype(x.dtype))
        return (torch.fft.ifft if inverse else torch.fft.fft)(x, dim=axis)
    if backend == "kernel":
        # Deferred import: kernels/fft_matmul.py imports ``factorize`` from
        # this module, so a top-level import here would be circular.
        from ..kernels import ops
        return (ops.ifft1d if inverse else ops.fft1d)(x, axis)
    if backend != "matmul":
        raise ValueError(f"unknown backend {backend!r}; supported local-FFT "
                         f"backends: {LOCAL_BACKENDS}")
    axis = axis % x.dim()
    xm = x.movedim(axis, -1)
    out = _matmul_fft(xm, inverse=inverse)
    return out.movedim(-1, axis)


def apply_1d(x: torch.Tensor, axis: int, kind: str, *,
             backend: str = "cufft") -> torch.Tensor:
    """Apply one transform along ``axis``.  ``kind`` is "fft" or "ifft"."""
    if backend not in LOCAL_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; supported local-FFT "
                         f"backends: {LOCAL_BACKENDS}")
    if kind == "fft":
        return _c2c(x, axis, inverse=False, backend=backend)
    if kind == "ifft":
        return _c2c(x, axis, inverse=True, backend=backend)
    if kind in ALL_KINDS:
        raise NotImplementedError(
            f"transform kind {kind!r} is not ported yet; the port runs the "
            f"C2C kinds {C2C_KINDS}")
    raise ValueError(f"unknown transform kind {kind!r}")
