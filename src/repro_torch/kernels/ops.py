"""Public wrappers around the four-step kernel: transform along any axis.

``fft1d`` / ``ifft1d`` take complex (or real) tensors of any rank and
transform along ``axis`` with :func:`~.fft_matmul.fft_fourstep`.  They are
the routing target of ``backend="kernel"``: ``core/transforms.apply_1d``
sends every complex FFT of that backend here, the ones inside its R2C and
R2R kinds included (the DCT-II with ``twiddle=``).  A CUDA tensor launches
the kernel; a CPU tensor runs its plain version.

``_apply`` moves ``axis`` to the end and copies the lines contiguous (a
full pass over the array when ``axis`` is not already last — the cost of a
strided axis), launches the kernel once, and moves the axis back as a
view.  The output dtype follows the input: complex64 for single precision,
complex128 for float64/complex128.

:func:`packed_fft1d` is the pipeline's form of the ``pack_parts`` epilogue:
it returns the kernel's destination-major buffer itself, shaped as the
next hop's send buffer (``core/redistribute.py``), with no copy.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.transforms import complex_dtype
from .fft_matmul import fft_fourstep


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
    flat = xm.to(cdt).reshape(-1, n).contiguous()
    tw = None
    if twiddle is not None:
        tw = torch.as_tensor(twiddle).reshape(-1)
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
