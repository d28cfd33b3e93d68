"""Batched 1-D FFT by the four-step method: the CUDA kernel and its plain
version.

The port's counterpart of the JAX package's Pallas kernel
(``src/repro/kernels/fft_matmul.py``).  For lines of length N = N1*N2
(``transforms.factorize``)

    X[k1 + N1*k2] = sum_{m2} W_N2^{m2 k2} * W_N^{m2 k1}
                        * sum_{m1} x[m1*N2 + m2] * W_N1^{m1 k1}

is two dense DFT-matrix contractions with a twiddle between them.
:func:`fft_fourstep` takes a contiguous ``(B, N)`` complex tensor:

* on a CUDA tensor it launches the hand-written kernel
  ``csrc/fft_fourstep.cu`` (built at first use by ``kernels/build.py``),
  which reads and writes interleaved complex directly and keeps the
  constant matrices in shared memory — or raises;
* on a CPU tensor it runs :func:`fft_fourstep_plain`, the same four steps
  in ``torch.einsum`` on real/imag planes (``transforms.fourstep_fft_planes``).

Two epilogues ride on the same launch, as in the Pallas kernel:

* ``twiddle`` — a complex ``(N,)`` phase multiplied into the output (the
  DCT-II/DST-II phase: ``transforms._dct2`` on the kernel backend);
* ``pack_parts=p`` — the output stored destination-major as ``(p, B, N/p)``,
  the send buffer of the next hop's ``all_to_all``.  The wrapper returns
  the logical ``(B, p, N/p)`` tensor as a strided view of that buffer.

The kernel reads raw memory, so a lazily conjugated or negated view
(``x.conj()``, the ``.imag`` of one) is materialized before its pointer is
taken (:func:`_resolved`); the plain version reads ``.real``/``.imag``,
which honour those bits anyway.

Two paths, chosen from N and the dtype alone (:func:`radix.kernel_path`):
power-of-two N (2 to 4096 for complex64, 4 to 1024 for complex128) takes
the radix path — in-register radix-2 codelets, ``csrc/fft_radix.cuh``,
planned in ``kernels/radix.py`` — and every other N the general dense
kernel.  A failed build or launch raises; nothing falls back.

:func:`fft_fourstep_strided` takes a contiguous ``(outer, N, inner)``
block and transforms dim 1 on the radix path, writing the same layout:
the line wrapper (``kernels/ops.py``) uses it for a strided axis instead
of copying the lines contiguous.

Every launch, from either entry, adds one to ``fft_fourstep.launches``,
to its variant's entry of ``fft_fourstep.variant_launches`` ("fourstep",
"pack", "twiddle"), to its path's entry of ``fft_fourstep.path_launches``
("radix", "dense") and to its layout's entry of
``fft_fourstep.layout_launches`` ("lines", "strided"); nothing else
touches them.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.transforms import (_dft_planes, _twiddle_planes, factorize,
                               fourstep_fft_planes, real_dtype)
from . import radix
from .radix import SMEM_MAX_BYTES, SMEM_TARGET_BYTES

#: W2 larger than this streams from global memory (L2) instead.
W2_SMEM_MAX_BYTES = 48 * 1024
MAX_LINES_PER_BLOCK = 16
DTYPES = (torch.complex64, torch.complex128)


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    lines: int          # lines per block
    w2_in_smem: bool
    smem_bytes: int


def smem_bytes(n1: int, n2: int, itemsize: int, twiddle: bool,
               w2_in_smem: bool, lines: int) -> int:
    """Dynamic shared memory of one block, in the order the kernel carves
    it: W1, T, the output twiddle, W2, the staged lines, G (row pitch
    n2 + 1).  The launch passes this count to the kernel."""
    n = n1 * n2
    elems = (n1 * n1 + n + (n if twiddle else 0)
             + (n2 * n2 if w2_in_smem else 0)
             + lines * n + lines * n1 * (n2 + 1))
    return elems * itemsize


def launch_config(n: int, itemsize: int, twiddle: bool) -> LaunchConfig:
    """Lines per block and where W2 lives, for lines of length ``n``.

    ``itemsize`` is the complex element size (8 or 16).  The most lines
    (a power of two up to 16) that keep two blocks on an SM; else one line
    in up to 227 KB; else ``ValueError`` naming the largest N taken.
    """
    n1, n2 = factorize(n)
    w2_smem = n2 * n2 * itemsize <= W2_SMEM_MAX_BYTES
    lines = MAX_LINES_PER_BLOCK
    while lines > 1 and smem_bytes(n1, n2, itemsize, twiddle, w2_smem,
                                   lines) > SMEM_TARGET_BYTES:
        lines //= 2
    need = smem_bytes(n1, n2, itemsize, twiddle, w2_smem, lines)
    if need > SMEM_MAX_BYTES:
        raise ValueError(
            f"fft_fourstep: N={n} needs {need} bytes of shared memory for "
            f"one line (limit {SMEM_MAX_BYTES}); the kernel takes N up to "
            f"{max_line_length(itemsize, twiddle)} for {itemsize}-byte "
            f"complex elements")
    return LaunchConfig(lines=lines, w2_in_smem=w2_smem, smem_bytes=need)


def max_line_length(itemsize: int, twiddle: bool) -> int:
    """The largest N such that one line of every length up to N fits."""
    for n in range(1, SMEM_MAX_BYTES // itemsize):
        n1, n2 = factorize(n)
        w2 = n2 * n2 * itemsize <= W2_SMEM_MAX_BYTES
        if smem_bytes(n1, n2, itemsize, twiddle, w2, 1) > SMEM_MAX_BYTES:
            return n - 1
    return SMEM_MAX_BYTES // itemsize


_CONST_CACHE: "OrderedDict[tuple, Tuple[torch.Tensor, ...]]" = OrderedDict()
_CONST_CACHE_SIZE = 32
_CONST_LOCK = threading.Lock()


def _device_constants(n1: int, n2: int, inverse: bool, dtype: torch.dtype,
                      device: torch.device) -> Tuple[torch.Tensor, ...]:
    """W1, W2, T on ``device``, cached per (n1, n2, inverse, dtype, device).

    Complex forms of the plain version's cos/sin planes
    (``transforms._dft_planes``/``_twiddle_planes``): built in float64 and
    cast, so complex64 runs see well-rounded phases.
    """
    key = (n1, n2, bool(inverse), dtype, device)
    with _CONST_LOCK:
        hit = _CONST_CACHE.get(key)
        if hit is not None:
            _CONST_CACHE.move_to_end(key)
            return hit
    sign = 1.0 if inverse else -1.0
    planes = (_dft_planes(n1, sign, "float64"),
              _dft_planes(n2, sign, "float64"),
              _twiddle_planes(n1, n2, sign, "float64"))
    consts = tuple(torch.from_numpy(cos + 1j * sin).to(device=device,
                                                       dtype=dtype)
                   for cos, sin in planes)
    with _CONST_LOCK:
        _CONST_CACHE[key] = consts
        while len(_CONST_CACHE) > _CONST_CACHE_SIZE:
            _CONST_CACHE.popitem(last=False)
    return consts


def _radix_constants(n: int, inverse: bool, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    """The radix kernel's constants on ``device``: T (N1 x N2, row-major)
    then the codelet table (``radix.codelet_table``), one buffer, cached
    with the dense path's constants."""
    key = ("radix", n, bool(inverse), dtype, device)
    with _CONST_LOCK:
        hit = _CONST_CACHE.get(key)
        if hit is not None:
            _CONST_CACHE.move_to_end(key)
            return hit[0]
    n1, n2 = factorize(n)
    sign = 1.0 if inverse else -1.0
    cos, sin = _twiddle_planes(n1, n2, sign, "float64")
    host = np.concatenate([(cos + 1j * sin).reshape(-1),
                           radix.codelet_table(n, inverse)])
    consts = torch.from_numpy(host).to(device=device, dtype=dtype)
    with _CONST_LOCK:
        _CONST_CACHE[key] = (consts,)
        while len(_CONST_CACHE) > _CONST_CACHE_SIZE:
            _CONST_CACHE.popitem(last=False)
    return consts


def _check(x: torch.Tensor, twiddle: Optional[torch.Tensor],
           pack_parts: Optional[int]) -> None:
    if x.dim() != 2:
        raise ValueError(f"fft_fourstep takes (B, N) lines, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"fft_fourstep takes complex64 or complex128, got "
                         f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fft_fourstep takes contiguous lines")
    n = x.shape[1]
    if pack_parts is not None and (pack_parts < 1 or n % pack_parts):
        raise ValueError(
            f"pack_parts={pack_parts} does not evenly split N={n}")
    if twiddle is not None and tuple(twiddle.shape) != (n,):
        raise ValueError(f"twiddle must have shape ({n},), got "
                         f"{tuple(twiddle.shape)}")


def _packed(out: torch.Tensor, pack_parts: Optional[int]) -> torch.Tensor:
    """(B, N) -> the (B, p, N/p) view of a destination-major buffer."""
    if pack_parts is None:
        return out
    b, n = out.shape
    buf = out.reshape(b, pack_parts, n // pack_parts).transpose(0, 1)
    return buf.contiguous().transpose(0, 1)


def fft_fourstep_plain(x: torch.Tensor, *, inverse: bool = False,
                       twiddle: Optional[torch.Tensor] = None,
                       pack_parts: Optional[int] = None) -> torch.Tensor:
    """The kernel's plain PyTorch version: same inputs, same output layout.

    The four steps run as ``torch.einsum`` contractions on real/imag planes
    (``transforms.fourstep_fft_planes``).  Used for CPU tensors and, on the
    card, as the kernel's yardstick.
    """
    _check(x, twiddle, pack_parts)
    b, n = x.shape
    if b == 0:
        return _packed(torch.zeros_like(x), pack_parts)
    rdt = real_dtype(x.dtype)
    outr, outi = fourstep_fft_planes(x.real.to(rdt), x.imag.to(rdt),
                                     inverse=inverse)
    out = torch.complex(outr, outi)
    if twiddle is not None:
        out = out * twiddle.to(device=x.device, dtype=x.dtype)
    return _packed(out, pack_parts)


def _resolved(x: torch.Tensor, twiddle: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The operands as the kernel reads them: conjugate and negative bits
    materialized, the twiddle on ``x``'s device and dtype and contiguous."""
    x = x.resolve_conj().resolve_neg()
    if twiddle is not None:
        twiddle = (twiddle.to(device=x.device, dtype=x.dtype)
                   .resolve_conj().resolve_neg().contiguous())
    return x, twiddle


def _launch(x: torch.Tensor, tw: Optional[torch.Tensor], *, inverse: bool,
            pack_parts: Optional[int] = None,
            strided: bool = False) -> torch.Tensor:
    """Launch the kernel on ``(B, N)`` lines, or with ``strided`` on a
    contiguous ``(outer, N, inner)`` block, and count the launch."""
    from . import build
    lib = build.load("fft_fourstep")
    _declare(lib)
    n = x.shape[1]
    parts = pack_parts if pack_parts is not None else 1
    if strided:
        buf = out = torch.empty_like(x)
    else:
        buf = torch.empty((parts, x.shape[0], n // parts), dtype=x.dtype,
                          device=x.device)
        out = buf[0] if pack_parts is None else buf.transpose(0, 1)
    if x.numel() == 0:
        return out
    path = radix.kernel_path(n, x.dtype)
    c64 = x.dtype == torch.complex64
    twp = tw.data_ptr() if tw is not None else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if path == "radix":
            tile = radix.radix_tile(n, x.element_size(), tw is not None,
                                    strided)
            consts = _radix_constants(n, inverse, x.dtype, x.device)
            outer, inner = (x.shape[0], x.shape[2]) if strided \
                else (x.shape[0], 1)
            fn = lib.repro_fft_radix_c64 if c64 else lib.repro_fft_radix_c128
            err = fn(x.data_ptr(), buf.data_ptr(), consts.data_ptr(), twp,
                     outer, inner, n, int(inverse),
                     (n // parts).bit_length() - 1,
                     tile.lines.bit_length() - 1, int(strided),
                     tile.smem_bytes, stream)
        else:
            n1, n2 = factorize(n)
            cfg = launch_config(n, x.element_size(), tw is not None)
            w1, w2, t = _device_constants(n1, n2, inverse, x.dtype, x.device)
            fn = (lib.repro_fft_fourstep_c64 if c64
                  else lib.repro_fft_fourstep_c128)
            err = fn(x.data_ptr(), buf.data_ptr(), w1.data_ptr(),
                     w2.data_ptr(), t.data_ptr(), twp, x.shape[0], n1, n2,
                     int(inverse), parts, cfg.lines, int(cfg.w2_in_smem),
                     cfg.smem_bytes, stream)
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"fft_fourstep ({path} path) launch failed for "
                           f"shape {tuple(x.shape)}, {x.dtype}: CUDA error "
                           f"{err} ({msg})")
    fft_fourstep.launches += 1
    variant = ("pack" if pack_parts is not None
               else "twiddle" if tw is not None else "fourstep")
    fft_fourstep.variant_launches[variant] += 1
    fft_fourstep.path_launches[path] += 1
    fft_fourstep.layout_launches["strided" if strided else "lines"] += 1
    return out


def _declare(lib) -> None:
    import ctypes
    if getattr(lib, "_repro_declared", False):
        return
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.repro_fft_fourstep_c64, lib.repro_fft_fourstep_c128):
        fn.argtypes = [p, p, p, p, p, p, ll, i, i, i, i, i, i, i, p]
        fn.restype = i
    for fn in (lib.repro_fft_radix_c64, lib.repro_fft_radix_c128):
        fn.argtypes = [p, p, p, p, ll, ll, i, i, i, i, i, i, p]
        fn.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    lib._repro_declared = True


def fft_fourstep(x: torch.Tensor, *, inverse: bool = False,
                 twiddle: Optional[torch.Tensor] = None,
                 pack_parts: Optional[int] = None) -> torch.Tensor:
    """Last-axis FFT of contiguous complex ``(B, N)`` lines.

    Returns ``(B, N)``, or with ``pack_parts=p`` the ``(B, p, N/p)`` view of
    a destination-major ``(p, B, N/p)`` buffer.  A CUDA tensor launches the
    kernel on the path :func:`radix.kernel_path` names; a CPU tensor runs
    :func:`fft_fourstep_plain`; any other device raises.  ``B == 0``
    returns an empty result without a launch.
    """
    _check(x, twiddle, pack_parts)
    if x.device.type == "cuda":
        return _launch(*_resolved(x, twiddle), inverse=inverse,
                       pack_parts=pack_parts)
    if x.device.type == "cpu":
        return fft_fourstep_plain(x, inverse=inverse, twiddle=twiddle,
                                  pack_parts=pack_parts)
    raise ValueError(f"fft_fourstep runs on cuda (the kernel) or cpu (its "
                     f"plain version), not {x.device}")


def strided_supported(n: int, dtype: torch.dtype, twiddle: bool) -> bool:
    """Whether :func:`fft_fourstep_strided` takes lines of length ``n``:
    the radix path, with a strided tile inside one block's shared
    memory."""
    return (dtype in DTYPES and radix.kernel_path(n, dtype) == "radix"
            and radix.radix_tile(n, dtype.itemsize, twiddle, True)
            is not None)


def _check_strided(x: torch.Tensor, twiddle: Optional[torch.Tensor]) -> None:
    if x.dim() != 3:
        raise ValueError(f"fft_fourstep_strided takes an (outer, N, inner) "
                         f"block, got shape {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"fft_fourstep_strided takes complex64 or "
                         f"complex128, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fft_fourstep_strided takes a contiguous block")
    n = x.shape[1]
    if not strided_supported(n, x.dtype, twiddle is not None):
        raise ValueError(f"fft_fourstep_strided: no strided radix tile for "
                         f"N={n}, {x.dtype}")
    if twiddle is not None and tuple(twiddle.shape) != (n,):
        raise ValueError(f"twiddle must have shape ({n},), got "
                         f"{tuple(twiddle.shape)}")


def fft_fourstep_strided_plain(x: torch.Tensor, *, inverse: bool = False,
                               twiddle: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """The strided entry's plain version: the lines copied contiguous,
    :func:`fft_fourstep_plain`, and the result in the ``(outer, N,
    inner)`` layout again."""
    _check_strided(x, twiddle)
    outer, n, inner = x.shape
    lines = x.transpose(1, 2).reshape(-1, n).contiguous()
    out = fft_fourstep_plain(lines, inverse=inverse, twiddle=twiddle)
    return out.reshape(outer, inner, n).transpose(1, 2).contiguous()


def fft_fourstep_strided(x: torch.Tensor, *, inverse: bool = False,
                         twiddle: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """FFT along dim 1 of a contiguous complex ``(outer, N, inner)`` block,
    returned in the same layout, on the radix path (``strided_supported``
    names the N it takes).  A CUDA tensor launches the kernel; a CPU
    tensor runs :func:`fft_fourstep_strided_plain`; any other device
    raises."""
    _check_strided(x, twiddle)
    if x.device.type == "cuda":
        return _launch(*_resolved(x, twiddle), inverse=inverse, strided=True)
    if x.device.type == "cpu":
        return fft_fourstep_strided_plain(x, inverse=inverse, twiddle=twiddle)
    raise ValueError(f"fft_fourstep_strided runs on cuda (the kernel) or cpu "
                     f"(its plain version), not {x.device}")


fft_fourstep.launches = 0
fft_fourstep.variant_launches = {"fourstep": 0, "pack": 0, "twiddle": 0}
fft_fourstep.path_launches = {"radix": 0, "dense": 0}
fft_fourstep.layout_launches = {"lines": 0, "strided": 0}


def reset_launch_counts() -> None:
    fft_fourstep.launches = 0
    for counts in (fft_fourstep.variant_launches, fft_fourstep.path_launches,
                   fft_fourstep.layout_launches):
        for k in counts:
            counts[k] = 0
