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
strided axis, an N off the radix path (dense, long-line or split) on a
strided axis, ``inner`` narrower than a tile, a non-dense view) moves
``axis`` last and copies the lines contiguous first, and each such copy
adds one to ``copies["lines"]``: a split length (lines longer than one
block, two launches through HBM) or a chirp length (two transforms of
lines of M) on a strided axis is copied so, as a long-line length is.
The chirp route's second transform stores the ``pack_parts`` segments
itself, so a chirp length with ``pack_parts`` adds none.
The output dtype follows the input: complex64 for single precision,
complex128 for float64/complex128.

:func:`packed_fft1d` is the pipeline's form of the ``pack_parts`` epilogue:
it returns the kernel's destination-major buffer itself, shaped as the
next hop's send buffer (``core/redistribute.py``), with no copy.

Gradients: :func:`fft1d` and :func:`ifft1d` without an epilogue go through
:class:`LineTransform`, a ``torch.autograd.Function`` whose backward is the
adjoint transform launched through the same kernel (on the CPU, through
its plain version).  The kernel's output is a fresh buffer with no
``grad_fn``, so without the Function autograd would cut the graph there
and say nothing.  The ``twiddle`` and ``pack_parts`` epilogues have no
backward: under grad mode, with an operand that requires grad, they raise
``NotImplementedError`` instead of returning a result with no graph.
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


def count_copy() -> None:
    """Add one line copy to ``copies``."""
    with _COPIES_LOCK:
        copies["lines"] += 1


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
        count_copy()
    flat = xm.reshape(-1, n).contiguous()
    out = fft_fourstep(flat, inverse=inverse, twiddle=tw,
                       pack_parts=pack_parts)
    if send_layout:
        # (B, p, n/p) view of the (p, B, n/p) buffer -> the buffer itself,
        # with the batch unflattened: (p, *lead, n/p), no copy.
        return out.transpose(0, 1).view((pack_parts,) + lead
                                        + (n // pack_parts,))
    return out.reshape(lead + (n,)).movedim(-1, axis)


class LineTransform(torch.autograd.Function):
    """A line transform (no epilogue) with its adjoint as the backward.

    PyTorch's complex autograd hands back ``A^H g`` for ``y = A x``.  The
    unnormalized forward DFT has ``A^H = N * IDFT``, so its backward is one
    inverse launch times N; the inverse (``1/N`` times the conjugate DFT)
    has ``A^H = DFT / N``, one forward launch over N.  ``torch.fft.fft``'s
    own backward is the same definition, and the tests hold the two
    against each other.  The backward runs on the stream autograd gives
    it (``_launch`` reads ``torch.cuda.current_stream()``) and counts its
    launches as any other.  A real operand gets the real part back.
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor, axis: int, inverse: bool):
        ctx.axis, ctx.inverse = axis, inverse
        ctx.real_input = not x.is_complex()
        return _apply(x, axis, inverse=inverse)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        n = grad.shape[ctx.axis]
        adj = LineTransform.apply(grad, ctx.axis, not ctx.inverse)
        adj = adj / n if ctx.inverse else adj * n
        return (adj.real if ctx.real_input else adj), None, None


def _refuse_grad(name: str, *operands: Optional[torch.Tensor]) -> None:
    """Raise when an epilogue would drop a gradient: it has no backward."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in operands):
        raise NotImplementedError(
            f"the {name} epilogue has no backward: it is not on a training "
            f"path; transform without it, or under torch.no_grad()")


def fft1d(x: torch.Tensor, axis: int = -1, *,
          twiddle: Optional[torch.Tensor] = None,
          pack_parts: Optional[int] = None) -> torch.Tensor:
    """Forward FFT along ``axis`` through the four-step kernel.

    ``twiddle`` — optional complex ``(n,)`` phase applied in the kernel's
    epilogue (the result is ``twiddle * fft(x)`` along ``axis``).
    ``pack_parts`` — the kernel stores the transformed axis pre-split into
    ``pack_parts`` destination-major blocks; the tensor returned here still
    has the logical shape (assembling it costs a copy; the pipeline uses
    :func:`packed_fft1d` instead).  Without an epilogue the transform is
    differentiable (:class:`LineTransform`).
    """
    return _transform(x, axis, inverse=False, twiddle=twiddle,
                      pack_parts=pack_parts)


def ifft1d(x: torch.Tensor, axis: int = -1, *,
           twiddle: Optional[torch.Tensor] = None,
           pack_parts: Optional[int] = None) -> torch.Tensor:
    """Inverse FFT along ``axis``; the same epilogues as :func:`fft1d`."""
    return _transform(x, axis, inverse=True, twiddle=twiddle,
                      pack_parts=pack_parts)


def _transform(x: torch.Tensor, axis: int, *, inverse: bool,
               twiddle: Optional[torch.Tensor],
               pack_parts: Optional[int]) -> torch.Tensor:
    if twiddle is None and pack_parts is None:
        return LineTransform.apply(x, axis, inverse)
    _refuse_grad("twiddle" if twiddle is not None else "pack_parts", x,
                 twiddle if isinstance(twiddle, torch.Tensor) else None)
    return _apply(x, axis, inverse=inverse, twiddle=twiddle,
                  pack_parts=pack_parts)


def packed_fft1d(x: torch.Tensor, axis: int, parts: int, *,
                 inverse: bool = False) -> torch.Tensor:
    """FFT along ``axis`` stored as the send buffer of a split of ``axis``.

    Returns the kernel's output buffer viewed as ``(parts, *others, n/parts)``
    — ``others`` are the remaining dims in order — which is the layout
    ``redistribute.send_buffer`` builds for a move splitting ``axis`` over
    ``parts`` ranks: block ``i`` is what rank ``i`` receives.
    """
    _refuse_grad("pack_parts", x)
    return _apply(x, axis, inverse=inverse, pack_parts=parts,
                  send_layout=True)
