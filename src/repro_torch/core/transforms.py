"""Local (on-device) 1-D transforms on torch tensors: C2C, R2C and R2R
(DCT/DST).

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
  (``kernels/fft_matmul.py``, wrapped by ``kernels/ops.py``), whose
  ``twiddle`` epilogue applies the DCT-II phase in the same launch.  A CPU
  tensor runs the kernel's plain PyTorch version instead.

R2C and R2R transforms are composed from the complex FFT with the standard
even/odd reordering identities, so they inherit whichever backend is
selected.  R2R kinds on complex input transform the real and imaginary
planes separately.  The complex working dtype follows the input:
float64/complex128 stay in double precision on every backend.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

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


def _move_last(x: torch.Tensor, axis: int):
    axis = axis % x.dim()
    return x.movedim(axis, -1), axis


def _rfft(x: torch.Tensor, axis: int, backend: str) -> torch.Tensor:
    if backend == "cufft":
        return torch.fft.rfft(x, dim=axis)
    # Hermitian trim of the full C2C result (flop-wasteful but simple; the
    # distributed pipeline pads the frequency dim anyway).
    full = _c2c(x, axis, inverse=False, backend=backend)
    return full.narrow(axis, 0, x.shape[axis] // 2 + 1)


def _irfft(x: torch.Tensor, axis: int, n: int, backend: str) -> torch.Tensor:
    if backend == "cufft":
        return torch.fft.irfft(x, n=n, dim=axis)
    # rebuild the Hermitian spectrum, then a full inverse C2C, real part
    xm, ax = _move_last(x, axis)
    body = torch.flip(torch.conj(xm[..., 1:n - n // 2]), (-1,))
    full = torch.cat([xm, body], dim=-1)
    out = _c2c(full, -1, inverse=True, backend=backend)
    return out.real.movedim(-1, ax)


# ---------------------------------------------------------------------------
# R2R: DCT-II/III and DST-II/III via the even/odd FFT reordering identities.
# Unnormalized ("scipy norm=None") conventions:
#   dct2(x)[k] = 2 sum_n x[n] cos(pi k (2n+1) / (2N))
#   dct3(x)[k] = x[0] + 2 sum_{n>=1} x[n] cos(pi n (2k+1) / (2N))
#   dct3(dct2(x)) = 2N x
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _dct_phase(n: int, sign: float, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """exp(sign*i*pi*k/(2n)) for k < n, built in float64 and cast."""
    k = np.arange(n, dtype=np.float64)
    phase = np.exp(sign * 1j * np.pi * k / (2.0 * n))
    return torch.from_numpy(phase).to(device=device, dtype=dtype)


def _dct2(x: torch.Tensor, axis: int, backend: str) -> torch.Tensor:
    xm, ax = _move_last(x, axis)
    n = xm.shape[-1]
    v = torch.cat([xm[..., 0::2], torch.flip(xm[..., 1::2], (-1,))], dim=-1)
    cdt = complex_dtype(v.dtype)
    phase = _dct_phase(n, -1.0, cdt, v.device)
    if backend == "kernel":
        # The kernel's twiddle epilogue applies the phase in the same launch
        # instead of a separate elementwise pass over the FFT output.
        from ..kernels import ops
        pv = ops.fft1d(v, -1, twiddle=phase)
    else:
        pv = phase * _c2c(v.to(cdt), -1, inverse=False, backend=backend)
    out = 2.0 * pv.real
    return out.to(x.dtype).movedim(-1, ax)


def _dct3(x: torch.Tensor, axis: int, backend: str) -> torch.Tensor:
    """Unnormalized DCT-III (the unscaled inverse of _dct2)."""
    xm, ax = _move_last(x, axis)
    n = xm.shape[-1]
    phase = _dct_phase(n, 1.0, complex_dtype(xm.dtype), xm.device)
    # The complex spectrum whose IFFT reproduces the even/odd shuffle.
    shifted = torch.cat([torch.zeros_like(xm[..., :1]),
                         torch.flip(xm[..., 1:], (-1,))], dim=-1)
    spec = (xm - 1j * shifted) * phase
    v = (_c2c(spec, -1, inverse=True, backend=backend) * n).real
    half = (n + 1) // 2
    out = v.new_empty(v.shape)
    out[..., 0::2] = v[..., :half]
    out[..., 1::2] = torch.flip(v[..., half:], (-1,))
    return out.to(x.dtype).movedim(-1, ax)


def _alt_signs(x: torch.Tensor) -> torch.Tensor:
    signs = torch.ones(x.shape[-1], dtype=x.dtype, device=x.device)
    signs[1::2] = -1.0
    return x * signs


def _dst2(x: torch.Tensor, axis: int, backend: str) -> torch.Tensor:
    # DST-II(x)[k] = DCT-II(alt_signs(x))[N-1-k]
    xm, ax = _move_last(x, axis)
    out = torch.flip(_dct2(_alt_signs(xm), -1, backend), (-1,))
    return out.movedim(-1, ax)


def _dst3(x: torch.Tensor, axis: int, backend: str) -> torch.Tensor:
    # Inverse pairing of _dst2: dst3(dst2(x)) = 2N x
    xm, ax = _move_last(x, axis)
    out = _alt_signs(_dct3(torch.flip(xm, (-1,)), -1, backend))
    return out.movedim(-1, ax)


_R2R = {"dct2": _dct2, "dct3": _dct3, "dst2": _dst2, "dst3": _dst3}


def apply_1d(x: torch.Tensor, axis: int, kind: str, *,
             backend: str = "cufft",
             irfft_n: Optional[int] = None) -> torch.Tensor:
    """Apply one transform along ``axis``.  ``kind`` in ALL_KINDS;
    ``irfft`` needs ``irfft_n``, the original real length."""
    if backend not in LOCAL_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; supported local-FFT "
                         f"backends: {LOCAL_BACKENDS}")
    if kind == "fft":
        return _c2c(x, axis, inverse=False, backend=backend)
    if kind == "ifft":
        return _c2c(x, axis, inverse=True, backend=backend)
    if kind == "rfft":
        return _rfft(x, axis, backend)
    if kind == "irfft":
        if irfft_n is None:
            raise ValueError("irfft needs irfft_n (original real length)")
        return _irfft(x, axis, irfft_n, backend)
    if kind in R2R_KINDS:
        fn = _R2R[kind]
        if x.is_complex():
            # R2R transforms are linear over R: apply to the planes
            # separately (a C2C stage before a bounded-dim DCT stage, e.g.
            # the (Periodic, Periodic, Bounded) Poisson topology).
            return torch.complex(fn(x.real, axis, backend),
                                 fn(x.imag, axis, backend))
        return fn(x, axis, backend)
    raise ValueError(f"unknown transform kind {kind!r}")


def apply_nd(x: torch.Tensor, axes: Tuple[int, ...], kind: str, *,
             backend: str = "cufft") -> torch.Tensor:
    """Apply the same 1-D transform along several axes (slab stages)."""
    for ax in axes:
        x = apply_1d(x, ax, kind, backend=backend)
    return x
