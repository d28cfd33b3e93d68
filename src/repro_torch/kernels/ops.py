"""Public wrappers around the four-step kernel: transform along any axis.

``fft1d`` / ``ifft1d`` take complex (or real) tensors of any rank and
transform along ``axis`` with :func:`~.fft_matmul.fft_fourstep`.  They are
the routing target of ``backend="kernel"``: ``core/transforms.apply_1d``
sends every complex FFT of that backend here, the ones inside its R2C and
R2R kinds included (the DCT-II with ``twiddle=``).  A CUDA tensor launches
the kernel; a CPU tensor runs its plain version.

``_apply`` works in ``x``'s physical order when ``x`` is dense (contiguous,
or a permutation of a contiguous block, as a previous stage leaves it):
with ``inner`` the elements physically inside the transformed axis, it
launches the kernel once on the ``(outer, N, inner)`` block — as ``(B,
N)`` lines when ``inner == 1``, else through the strided entry
(:func:`~.fft_matmul.fft_fourstep_strided`) when that takes N and
``inner`` holds at least a strided tile — and returns the result with
``x``'s strides, with no copy.  Everything else (``pack_parts`` on a
strided axis, a general-path N on a strided axis, ``inner`` narrower than
a tile, a non-dense view) moves ``axis`` last and copies the lines
contiguous first, and each such copy adds one to ``copies["lines"]``.
The output dtype follows the input: complex64 for single precision,
complex128 for float64/complex128.

:func:`packed_fft1d` is the pipeline's form of the ``pack_parts`` epilogue:
it returns the kernel's destination-major buffer itself, shaped as the
next hop's send buffer (``core/redistribute.py``), with no copy.
"""
from __future__ import annotations

import math
import threading
from typing import List, Optional, Tuple

import torch

from ..core.transforms import complex_dtype
from . import radix
from .fft_matmul import fft_fourstep, fft_fourstep_strided, strided_supported

#: Line copies ``_apply`` made because the kernel could not read the axis
#: where it lies (see the module docstring).  Updated under a lock: the
#: executor's pool mode transforms from several threads.
copies = {"lines": 0}
_COPIES_LOCK = threading.Lock()


def dense_layout(x: torch.Tensor, axis: int
                 ) -> Optional[Tuple[List[int], int, int]]:
    """``(perm, outer, inner)`` when ``x`` is dense and non-overlapping:
    ``x.permute(perm)`` is contiguous, and ``outer``/``inner`` count the
    elements before/after ``axis`` in that order.  None otherwise."""
    perm = sorted(range(x.dim()), key=lambda d: (-x.stride(d), d))
    if not x.permute(perm).is_contiguous():
        return None
    p = perm.index(axis)
    outer = math.prod(x.shape[d] for d in perm[:p])
    inner = math.prod(x.shape[d] for d in perm[p + 1:])
    return perm, outer, inner


def _in_place_layout(x: torch.Tensor, axis: int, twiddle: bool):
    """The layout the kernel reads ``x`` in without a copy, or None."""
    layout = dense_layout(x, axis)
    if layout is None or layout[2] == 1:
        return layout
    if not strided_supported(x.shape[axis], x.dtype, twiddle):
        return None
    return layout if layout[2] >= radix.STRIDED_LINES else None


def _apply(x: torch.Tensor, axis: int, *, inverse: bool,
           twiddle: Optional[torch.Tensor] = None,
           pack_parts: Optional[int] = None,
           send_layout: bool = False) -> torch.Tensor:
    axis = axis % x.dim()
    cdt = complex_dtype(x.dtype)
    xm = x.movedim(axis, -1)
    lead = tuple(xm.shape[:-1])
    n = xm.shape[-1]
    if xm.numel() == 0:
        # Empty batch (or empty line): nothing to transform.  Checked before
        # the flatten: reshape(-1, 0) is itself an error.
        if send_layout:
            return torch.zeros((pack_parts,) + lead + (n // pack_parts,),
                               dtype=cdt, device=x.device)
        return torch.zeros(lead + (n,), dtype=cdt,
                           device=x.device).movedim(-1, axis)
    tw = None
    if twiddle is not None:
        tw = torch.as_tensor(twiddle).reshape(-1)
    xc = x.to(cdt)
    layout = None if pack_parts is not None else \
        _in_place_layout(xc, axis, tw is not None)
    if layout is not None:
        perm, outer, inner = layout
        xp = xc.permute(perm)
        if inner == 1:
            out = fft_fourstep(xp.reshape(outer, n), inverse=inverse,
                               twiddle=tw)
        else:
            out = fft_fourstep_strided(xp.reshape(outer, n, inner),
                                       inverse=inverse, twiddle=tw)
        inv = [perm.index(d) for d in range(x.dim())]
        return out.reshape(xp.shape).permute(inv)
    xm = xc.movedim(axis, -1)
    if not xm.is_contiguous():
        with _COPIES_LOCK:
            copies["lines"] += 1
    flat = xm.reshape(-1, n).contiguous()
    out = fft_fourstep(flat, inverse=inverse, twiddle=tw,
                       pack_parts=pack_parts)
    if send_layout:
        # (B, p, n/p) view of the (p, B, n/p) buffer -> the buffer itself,
        # with the batch unflattened: (p, *lead, n/p), no copy.
        return out.transpose(0, 1).view((pack_parts,) + lead
                                        + (n // pack_parts,))
    return out.reshape(lead + (n,)).movedim(-1, axis)


def fft1d(x: torch.Tensor, axis: int = -1, *,
          twiddle: Optional[torch.Tensor] = None,
          pack_parts: Optional[int] = None) -> torch.Tensor:
    """Forward FFT along ``axis`` through the four-step kernel.

    ``twiddle`` — optional complex ``(n,)`` phase applied in the kernel's
    epilogue (the result is ``twiddle * fft(x)`` along ``axis``).
    ``pack_parts`` — the kernel stores the transformed axis pre-split into
    ``pack_parts`` destination-major blocks; the tensor returned here still
    has the logical shape (assembling it costs a copy; the pipeline uses
    :func:`packed_fft1d` instead).
    """
    return _apply(x, axis, inverse=False, twiddle=twiddle,
                  pack_parts=pack_parts)


def ifft1d(x: torch.Tensor, axis: int = -1, *,
           twiddle: Optional[torch.Tensor] = None,
           pack_parts: Optional[int] = None) -> torch.Tensor:
    """Inverse FFT along ``axis``; the same epilogues as :func:`fft1d`."""
    return _apply(x, axis, inverse=True, twiddle=twiddle,
                  pack_parts=pack_parts)


def packed_fft1d(x: torch.Tensor, axis: int, parts: int, *,
                 inverse: bool = False) -> torch.Tensor:
    """FFT along ``axis`` stored as the send buffer of a split of ``axis``.

    Returns the kernel's output buffer viewed as ``(parts, *others, n/parts)``
    — ``others`` are the remaining dims in order — which is the layout
    ``redistribute.send_buffer`` builds for a move splitting ``axis`` over
    ``parts`` ranks: block ``i`` is what rank ``i`` receives.
    """
    return _apply(x, axis, inverse=inverse, pack_parts=parts,
                  send_layout=True)
