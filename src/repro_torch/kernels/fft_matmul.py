"""Batched 1-D FFT by the four-step method: the CUDA kernel and its plain
version.

The port's counterpart of the JAX package's Pallas kernel
(``src/repro/kernels/fft_matmul.py``).  For lines of length N = N1*N2
(``transforms.factorize``)

    X[k1 + N1*k2] = sum_{m2} W_N2^{m2 k2} * W_N^{m2 k1}
                        * sum_{m1} x[m1*N2 + m2] * W_N1^{m1 k1}

is two dense DFT-matrix contractions with a twiddle between them there;
the port's routes compute the same transform with codelets instead.
:func:`fft_fourstep` takes a contiguous ``(B, N)`` complex tensor:

* on a CUDA tensor it launches the hand-written kernels of
  ``csrc/fft_fourstep.cu`` (built at first use by ``kernels/build.py``),
  which read and write interleaved complex directly — or raises;
* on a CPU tensor it runs :func:`fft_fourstep_plain`, the route's plain
  version.

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

Five routes, chosen from N and the dtype alone (:func:`radix.kernel_path`):
every even N whose only prime factors are 2, 3, 5, 7, 11 and 13, and
every 17*2^k, 19*2^k and 23*2^k, whose two factors both fit a codelet of
``radix.CODELET_MAX`` values, so that the codelets stay in registers —
power-of-two N (2 to 4096 for complex64, 4 to 1024 for complex128) and
the mixed N = r*2^k, r in ``radix.RADIX_ODD`` (3 to 1701 for complex64, 3
to 405 for complex128: ``radix.RADIX_SIZES``) — takes the radix path —
two passes of in-register codelets (radix 2, or a chain of radix 2, 3,
4, 5, 7, 11, 13, 17, 19 and 23), ``csrc/fft_radix.cuh``, planned in
``kernels/radix.py`` — but for its wide lines (a factor past 32 values in
complex64, 16 in complex128: ``longline.WIDE``), whose contiguous lines
take the long-line path's tile kernel (``csrc/fft_wide.cuh``: tiles of
LT lines by TMA, three passes of codelets of at most 32 values; the
radix kernel keeps their strided layout); the longer N whose line fits in one block's shared
memory (powers of two 8192 and 16384 for complex64, 2048 to 8192 for
complex128; the mixed lengths 4352 to 15360 and 1088 to 7680 whose odd
part is in ``radix.EVERY_ROUTE_ODD``, and the other even 13-smooth N
past the radix route that three codelets of at most 32 values take,
3168 to 16128 and 792 to 8064: ``longline.rule_factors``) take the
long-line path — three such passes over a line loaded by TMA,
``csrc/fft_long.cuh``, planned in ``kernels/longline.py``, whose
``emulate`` is this path's plain version; the powers of two and those
mixed lengths beyond one block (to 2^24 for complex64, 2^22 for
complex128), and every other 13-smooth N or 23*2^k there whose N = P*Q
a radix or long-line row holds (``split.rule_factors``), and every other
13-smooth N past one block (``split.general_factors``), take the split
route — N = P*Q through HBM, a strided radix launch on the P-long
columns (P a power of two; for a general plan without one, the dense
kernel's column form) with the inter-step twiddle in its store, then the
Q-long rows stored transposed with the line's epilogues: on the radix
route, or on the long-line or dense route's stages through a
thread-block cluster (a nested plan's rows on another route: stored in
natural order and moved by a transpose launch that carries the
epilogues) —
planned in ``kernels/split.py``, whose ``emulate`` is that route's plain
version; every other N up to ``dense.DENSE_LIMIT`` (complex64 4835,
complex128 2419) whose generic stages (one per prime factor past 13)
cost no more than the chirp route's (``dense.GENERIC_COST``; odd N, the
even 13-smooth N that neither the radix nor the long-line route takes,
such as complex64 2730 = 42 x 65)
and every other 13-smooth N whose line fits one block (complex64 to
28431, complex128 to 14196) takes the dense route — named for the dense
DFT-matrix kernel it replaced, now a mixed-radix FFT over a chain chosen
at run time, the lines in shared memory, ``csrc/fft_dense.cuh``, planned
in ``kernels/dense.py``, whose ``emulate`` is that route's plain
version; past the split route's limit every N with a 13-smooth P on a
column pass and rows on another route takes its nested plans (the rows'
own launch, ``split.nested_factors``); every other N (dearer prime
factors, or a prime factor past 13 that no codelet or nested plan
takes) takes the chirp route — Bluestein's convolution as two
transforms of M, the cheapest 13-smooth length from 2N - 1, on the
dense route's kernel, the long-line route's powers of two or a split
plan, the first one's load reading the input times the chirp and the
second one's store keeping the first N, the filter and the output chirp
in their ``twiddle`` epilogues, planned in ``kernels/chirp.py``, whose
``emulate`` is that route's plain version (N up to 2^30, M within the
kernels' 32-bit line index); past that N raises on the card
(``launch_config``).  A failed build or launch raises; nothing falls
back.

:func:`fft_fourstep_strided` takes a contiguous ``(outer, N, inner)``
block and transforms dim 1 on the radix path, writing the same layout:
the line wrapper (``kernels/ops.py``) uses it for a strided axis instead
of copying the lines contiguous.

Every launch, from either entry, adds one to ``fft_fourstep.launches``,
to its variant's entry of ``fft_fourstep.variant_launches`` ("fourstep",
"pack", "twiddle"), to its route's entry of ``fft_fourstep.path_launches``
(the five names :func:`radix.kernel_path` gives) and to its layout's
entry of ``fft_fourstep.layout_launches`` ("lines", "strided"); nothing
else touches them.  A split call is two launches (pass A, the rows' own
launches and pass C where a plan's rows keep pass C), each counted on "split" and the layout it runs
(pass A: "strided", "fourstep"; passes B and C: "lines"; the last carries
the call's variant), and adds one to ``fft_fourstep.split_calls`` (a
nested plan's rows count on "split" with no call of their own); a pass B
with pass C folded in adds one to ``fft_fourstep.fold_launches``'
"dense" or "long".  A chirp call
is two inner transforms (one launch each on the dense or the long-line
route, a split plan's two launches, or pass A, the rows' and pass C), every
launch counted on "chirp" and its layout, and adds one to
``fft_fourstep.chirp_calls``.  A long-path line that does not start on
16 bytes (the bulk copies' alignment) is cloned first and adds one to
``fft_fourstep.aligned_copies``.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.transforms import (_dft_planes, _twiddle_planes, factorize,
                               fourstep_fft_planes, real_dtype)
from . import chirp, dense, longline, radix, split
from .radix import SMEM_MAX_BYTES

DTYPES = (torch.complex64, torch.complex128)


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    lines: int          # lines per block
    buffers: int        # tile buffers: 2 where a generic stage runs
    smem_bytes: int


def launch_config(n: int, itemsize: int) -> LaunchConfig:
    """The dense route's layout for lines of length ``n``
    (``dense.dense_plan``): lines per block, tile buffers and the
    dynamic shared memory of one block.

    ``itemsize`` is the complex element size (8 or 16); the output
    twiddle is read from global memory, so it does not change the layout.
    Past the route's domain (``dense.takes``) a ``ValueError`` names what
    each route takes.
    """
    dtype = torch.complex64 if itemsize == 8 else torch.complex128
    if not dense.takes(n, dtype):
        raise ValueError(
            f"fft_fourstep: N={n} is on no route for {itemsize}-byte "
            f"complex elements: the kernels index a line with 32-bit ints "
            f"(split.LINE_MAX = {split.LINE_MAX}), so the routes take N up "
            f"to {split.MAX_LENGTH} (split.MAX_LENGTH) but for the N past "
            f"{chirp.max_chirp_length()} with no 13-smooth plan, whose "
            f"chirp's M (at least 2N - 1) would pass that line index.  The "
            f"dense route takes N up to {dense.DENSE_LIMIT[dtype]} whose "
            f"generic stages cost no more than the chirp route and the "
            f"13-smooth N whose line fits one block's {SMEM_MAX_BYTES} "
            f"bytes of shared memory; the split route the powers of two "
            f"and r*2^k, r in {radix.EVERY_ROUTE_ODD} (its table and "
            f"split.rule_factors), every other 13-smooth N past one block "
            f"up to {split.LIMIT.get(dtype)} (split.general_factors) and "
            f"past that every N with a 13-smooth P on a column pass and "
            f"rows on another route (split.nested_factors); the chirp "
            f"route every other N whose M has a route (chirp.chirp_plan)")
    plan = dense.dense_plan(n, dtype)
    return LaunchConfig(lines=plan.lines, buffers=plan.buffers,
                        smem_bytes=plan.smem_bytes)


_CONST_CACHE: "OrderedDict[tuple, Tuple[torch.Tensor, ...]]" = OrderedDict()
_CONST_CACHE_SIZE = 32
_CONST_LOCK = threading.Lock()


def _cached(key: tuple, build: Callable[[], object]):
    """The constants cached under ``key``, built by ``build()`` on a miss;
    the least recently used entry goes past ``_CONST_CACHE_SIZE``."""
    with _CONST_LOCK:
        hit = _CONST_CACHE.get(key)
        if hit is not None:
            _CONST_CACHE.move_to_end(key)
            return hit
    value = build()
    with _CONST_LOCK:
        _CONST_CACHE[key] = value
        while len(_CONST_CACHE) > _CONST_CACHE_SIZE:
            _CONST_CACHE.popitem(last=False)
    return value


def _device_constants(n1: int, n2: int, inverse: bool, dtype: torch.dtype,
                      device: torch.device) -> Tuple[torch.Tensor, ...]:
    """W1, W2, T on ``device``, cached per (n1, n2, inverse, dtype, device).

    Complex forms of the plain version's cos/sin planes
    (``transforms._dft_planes``/``_twiddle_planes``): built in float64 and
    cast, so complex64 runs see well-rounded phases.
    """
    def build():
        sign = 1.0 if inverse else -1.0
        planes = (_dft_planes(n1, sign, "float64"),
                  _dft_planes(n2, sign, "float64"),
                  _twiddle_planes(n1, n2, sign, "float64"))
        return tuple(torch.from_numpy(cos + 1j * sin).to(device=device,
                                                         dtype=dtype)
                     for cos, sin in planes)
    return _cached((n1, n2, bool(inverse), dtype, device), build)


def _radix_constants(n: int, inverse: bool, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    """The radix kernel's constants on ``device``: T (N1 x N2, row-major)
    then the codelet table (``radix.codelet_table``), one buffer, cached
    with the other paths' constants."""
    def build():
        n1, n2 = factorize(n)
        sign = 1.0 if inverse else -1.0
        cos, sin = _twiddle_planes(n1, n2, sign, "float64")
        host = np.concatenate([(cos + 1j * sin).reshape(-1),
                               radix.codelet_table(n, inverse)])
        return torch.from_numpy(host).to(device=device, dtype=dtype)
    return _cached(("radix", n, bool(inverse), dtype, device), build)


def _dense_constants(n: int, inverse: bool, dtype: torch.dtype,
                     device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The dense kernel's tables on ``device``: the complex ones and the
    int32 ones (``dense.constants``, built in float64), cached with the
    other paths' constants."""
    def build():
        cplx, ints = dense.constants(dense.dense_plan(n, dtype), inverse)
        return (torch.from_numpy(cplx).to(device=device, dtype=dtype),
                torch.from_numpy(ints).to(device=device))
    return _cached(("dense", n, bool(inverse), dtype, device), build)


def _long_constants(n: int, inverse: bool, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """The long-line kernel's constants on ``device``: TA, TB, TC and the
    codelet table (``longline.constants``, built in float64), one buffer,
    cached with the other paths' constants."""
    return _cached(("long", n, bool(inverse), dtype, device),
                   lambda: torch.from_numpy(longline.constants(
                       n, dtype, inverse)).to(device=device, dtype=dtype))


def _split_constants(plan: split.SplitPlan, inverse: bool,
                     dtype: torch.dtype, device: torch.device
                     ) -> torch.Tensor:
    """Pass A's twiddle tables on ``device``: TA then TB, or on a dense
    pass A WA then WB (``split.constants``, built in float64), one buffer,
    cached with the other paths' constants under (P, Q, pass A's
    route)."""
    return _cached(("split", plan.n, plan.p, plan.q, plan.col_path,
                    bool(inverse), dtype, device),
                   lambda: torch.from_numpy(split.constants(
                       plan, inverse)).to(device=device, dtype=dtype))


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

    On the long-line path's N (powers of two and mixed), that path's three
    passes (``longline.emulate``); on the split route's N, its two passes
    (``split.emulate``); on the chirp route's N, its four steps over the
    inner routes' plain versions (``chirp.emulate``); on the dense route's
    N, its mixed-radix stages (``dense.emulate``); on the radix route's N
    the four steps as ``torch.einsum`` contractions on real/imag planes
    (``transforms.fourstep_fft_planes``).  Used for CPU tensors and, on the
    card, as the kernel's yardstick.
    """
    _check(x, twiddle, pack_parts)
    b, n = x.shape
    if b == 0:
        return _packed(torch.zeros_like(x), pack_parts)
    path = radix.kernel_path(n, x.dtype)
    route = {"long": longline, "split": split, "chirp": chirp,
             "dense": dense}.get(path)
    if route is not None:
        buf = route.emulate(x, inverse=inverse, twiddle=twiddle,
                            pack_parts=pack_parts)
        return buf if pack_parts is None else buf.transpose(0, 1)
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


def _out_buffers(x: torch.Tensor, pack_parts: Optional[int]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(buffer the kernel writes, the tensor returned) for ``(B, N)``
    lines: ``(p, B, N/p)`` and its ``(B, p, N/p)`` view."""
    n = x.shape[1]
    parts = pack_parts if pack_parts is not None else 1
    buf = torch.empty((parts, x.shape[0], n // parts), dtype=x.dtype,
                      device=x.device)
    return buf, (buf[0] if pack_parts is None else buf.transpose(0, 1))


def _raise_on(err: int, lib, path: str, x: torch.Tensor) -> None:
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"fft_fourstep ({path} path) launch failed for "
                           f"shape {tuple(x.shape)}, {x.dtype}: CUDA error "
                           f"{err} ({msg})")


def _count(path: str, layout: str, variant: str, split_call: bool = False,
           fold: Optional[str] = None) -> None:
    # The executor's pool mode launches from several threads.
    with _COUNT_LOCK:
        fft_fourstep.launches += 1
        fft_fourstep.variant_launches[variant] += 1
        fft_fourstep.path_launches[path] += 1
        fft_fourstep.layout_launches[layout] += 1
        fft_fourstep.split_calls += int(split_call)
        if fold is not None:
            fft_fourstep.fold_launches[fold] += 1


def _seg_arg(n: int, parts: int) -> int:
    """The kernels' ``pack_parts`` segment argument for lines of ``n``:
    its log2 for a power-of-two N (the kernels shift), its length for a
    mixed N (they divide)."""
    seg = n // parts
    return seg.bit_length() - 1 if radix.is_pow2(n) else seg


def _variant(tw: Optional[torch.Tensor], pack_parts: Optional[int]) -> str:
    return ("pack" if pack_parts is not None
            else "twiddle" if tw is not None else "fourstep")


def _launch(x: torch.Tensor, tw: Optional[torch.Tensor], *, inverse: bool,
            pack_parts: Optional[int] = None,
            strided: bool = False,
            count_as: Optional[str] = None) -> torch.Tensor:
    """Launch the kernel on ``(B, N)`` lines, or with ``strided`` on a
    contiguous ``(outer, N, inner)`` block, and count the launch on its
    path, or on ``count_as`` (the rows of a nested split plan, the chirp
    route's inner transforms: their caller's path, and no call of their
    own)."""
    n = x.shape[1]
    path = "radix" if strided else radix.kernel_path(n, x.dtype)
    if path == "split":
        return _launch_split(x, tw, inverse=inverse, pack_parts=pack_parts,
                             plan=split.split_plan(n, x.dtype),
                             count_as=count_as or "split",
                             call=count_as is None)
    if path == "chirp":
        return _launch_chirp(x, tw, inverse=inverse, pack_parts=pack_parts)
    from . import build
    lib = build.load("fft_fourstep")
    _declare(lib)
    parts = pack_parts if pack_parts is not None else 1
    if strided:
        buf = out = torch.empty_like(x)
    else:
        buf, out = _out_buffers(x, pack_parts)
    if x.numel() == 0:
        return out
    c64 = x.dtype == torch.complex64
    twp = tw.data_ptr() if tw is not None else None
    with torch.cuda.device(x.device):
        current = torch.cuda.current_stream(x.device)
        stream = current.cuda_stream
        if path == "radix":
            tile = radix.radix_tile(n, x.element_size(), tw is not None,
                                    strided)
            consts = _radix_constants(n, inverse, x.dtype, x.device)
            # The cached constants outlive this call: the allocator must
            # not reuse them (after an eviction) while this stream reads.
            consts.record_stream(current)
            outer, inner = (x.shape[0], x.shape[2]) if strided \
                else (x.shape[0], 1)
            fn = lib.repro_fft_radix_c64 if c64 else lib.repro_fft_radix_c128
            err = fn(x.data_ptr(), buf.data_ptr(), consts.data_ptr(), twp,
                     outer, inner, n, int(inverse), _seg_arg(n, parts),
                     tile.lines.bit_length() - 1, int(strided),
                     tile.smem_bytes, stream)
        elif path == "long":
            tile = longline.long_tile(n, x.dtype)
            consts = _long_constants(n, inverse, x.dtype, x.device)
            consts.record_stream(current)
            if x.data_ptr() % 16:
                x = x.clone()      # the bulk copy reads 16-byte aligned lines
                with _COUNT_LOCK:
                    fft_fourstep.aligned_copies += 1
            wide = n in longline.WIDE[x.dtype]
            fn = getattr(lib, ("repro_fft_wide_" if wide else
                               "repro_fft_long_") + ("c64" if c64 else "c128"))
            err = fn(x.data_ptr(), buf.data_ptr(), consts.data_ptr(), twp,
                     x.shape[0], n, int(inverse),
                     n // parts if wide else _seg_arg(n, parts),
                     tile.smem_bytes, stream)
        else:
            launch_config(n, x.element_size())    # raises past the domain
            plan = dense.dense_plan(n, x.dtype)
            consts, ints = _dense_constants(n, inverse, x.dtype, x.device)
            for c in (consts, ints):
                c.record_stream(current)
            if x.data_ptr() % x.element_size():
                x = x.clone()      # the copies read whole aligned elements
            fn = lib.repro_fft_dense_c64 if c64 else lib.repro_fft_dense_c128
            err = fn(x.data_ptr(), buf.data_ptr(), consts.data_ptr(),
                     ints.data_ptr(), twp, x.shape[0], n, len(plan.radices),
                     plan.lines, plan.t_log2, plan.lo, plan.n_consts,
                     plan.n_ints, plan.buf_offset, int(inverse), n // parts,
                     plan.threads, plan.smem_bytes, stream)
    _raise_on(err, lib, path, x)
    _count(count_as or path, "strided" if strided else "lines",
           _variant(tw, pack_parts))
    return out


def _chirp_constants(n: int, m: int, inverse: bool, dtype: torch.dtype,
                     device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The chirp route's input chirp (N,), transformed filter (M,) and
    output chirp (N,) on ``device`` (``chirp.constants``, built in
    float64), cached with the other paths' constants under (N, M)."""
    def build():
        return tuple(torch.from_numpy(t).to(device=device, dtype=dtype)
                     for t in chirp.constants(n, inverse, m))
    return _cached(("chirp", n, m, bool(inverse), dtype, device), build)


def _launch_dense_chirp(x: torch.Tensor, out: torch.Tensor, m: int,
                        tw: Optional[torch.Tensor],
                        pre: Optional[torch.Tensor], n_out: int, seg: int,
                        *, inverse: bool) -> None:
    """One of the chirp route's transforms on the dense route's kernel
    (``repro_fft_dense_chirp_*``): lines of M read from ``x``'s rows at
    their pitch (zeros past it), times ``pre`` where given; the outputs k
    < ``n_out`` stored into ``out``, segment ``seg``; counted on
    "chirp"."""
    from . import build
    lib = build.load("fft_fourstep")
    _declare(lib)
    b, n_in = x.shape
    cdt, dev = x.dtype, x.device
    plan = dense.dense_plan(m, cdt)
    with torch.cuda.device(dev):
        current = torch.cuda.current_stream(dev)
        consts, ints = _dense_constants(m, inverse, cdt, dev)
        for c in (consts, ints):
            c.record_stream(current)
        if x.data_ptr() % x.element_size():
            x = x.clone()          # the copies read whole aligned elements
        fn = getattr(lib, "repro_fft_dense_chirp_"
                     + ("c64" if cdt == torch.complex64 else "c128"))
        err = fn(x.data_ptr(), out.data_ptr(), consts.data_ptr(),
                 ints.data_ptr(), tw.data_ptr() if tw is not None else None,
                 pre.data_ptr() if pre is not None else None, b, m, n_in,
                 n_out, len(plan.radices), plan.lines, plan.t_log2, plan.lo,
                 plan.n_consts, plan.n_ints, plan.buf_offset, int(inverse),
                 seg, plan.threads, plan.smem_bytes, current.cuda_stream)
    _raise_on(err, lib, "chirp", x)
    _count("chirp", "lines", _variant(tw, None))


def _launch_long_chirp(x: torch.Tensor, out: torch.Tensor, m: int,
                       tw: Optional[torch.Tensor],
                       pre: Optional[torch.Tensor], n_out: int, seg: int,
                       *, inverse: bool) -> None:
    """One of the chirp route's transforms of a power-of-two M on the
    long-line route (``repro_fft_long_chirp_*``): with ``pre`` the first
    (pass 1 reads ``x``'s rows at their pitch times ``pre``, zeros past
    it; every output of M stored), else the second (lines of M in; the
    outputs k < ``n_out`` stored into ``out``, segment ``seg``); counted
    on "chirp"."""
    from . import build
    lib = build.load("fft_fourstep")
    _declare(lib)
    b, n_in = x.shape
    cdt, dev = x.dtype, x.device
    with torch.cuda.device(dev):
        current = torch.cuda.current_stream(dev)
        consts = _long_constants(m, inverse, cdt, dev)
        consts.record_stream(current)
        fold = 1 if pre is not None else 2
        if fold == 2 and x.data_ptr() % 16:
            x = x.clone()          # the bulk copy reads 16-byte aligned lines
        fn = getattr(lib, "repro_fft_long_chirp_"
                     + ("c64" if cdt == torch.complex64 else "c128"))
        err = fn(x.data_ptr(), out.data_ptr(), consts.data_ptr(),
                 tw.data_ptr() if tw is not None else None,
                 pre.data_ptr() if pre is not None else None, b, m, fold,
                 int(inverse), m.bit_length() - 1, n_in, n_out, seg,
                 longline.long_tile(m, cdt).smem_bytes, current.cuda_stream)
    _raise_on(err, lib, "chirp", x)
    _count("chirp", "lines", _variant(tw, None))


def _launch_chirp(x: torch.Tensor, tw: Optional[torch.Tensor], *,
                  inverse: bool, pack_parts: Optional[int]) -> torch.Tensor:
    """The chirp route on contiguous ``(B, N)`` lines
    (``kernels/chirp.py``): the forward transform of M, its load reading
    the N-long lines times the input chirp (zeros past N), the transformed
    filter as its twiddle; then the inverse of M with the output chirp
    (and ``tw``) as its twiddle, its store keeping the first N of each
    line in the ``pack_parts`` segments.  M on the dense route's kernel or
    the long-line route (two launches) or a split plan (pass A's load and
    pass C's store folded); all on the current stream, every launch
    counted on "chirp";
    the call adds one to ``fft_fourstep.chirp_calls``."""
    b, n = x.shape
    buf, out = _out_buffers(x, pack_parts)
    if x.numel() == 0:
        return out
    cplan = chirp.chirp_plan(n, x.dtype)
    if cplan is None:
        launch_config(n, x.element_size())      # raises with the domain
    m, parts = cplan.m, pack_parts or 1
    pre, filt, post = _chirp_constants(n, m, inverse, x.dtype, x.device)
    with torch.cuda.device(x.device):
        current = torch.cuda.current_stream(x.device)
        for c in (pre, filt, post):
            # cached: the allocator must not reuse them while this reads
            c.record_stream(current)
        out_tw = chirp.post_twiddle(post, tw)
        if cplan.route in ("dense", "long"):
            one = (_launch_dense_chirp if cplan.route == "dense"
                   else _launch_long_chirp)
            a = torch.empty((b, m), dtype=x.dtype, device=x.device)
            one(x, a, m, filt, pre, m, m, inverse=False)
            one(a, buf, m, out_tw, None, n, n // parts, inverse=True)
        else:
            a = _launch_split(x, filt, inverse=False, pack_parts=None,
                              plan=cplan.split, count_as="chirp",
                              call=False, pre=pre)
            _launch_split(a, out_tw, inverse=True, pack_parts=pack_parts,
                          plan=cplan.split, count_as="chirp", call=False,
                          keep=n, into=buf)
    with _COUNT_LOCK:
        fft_fourstep.chirp_calls += 1
    return out


def _launch_split(x: torch.Tensor, tw: Optional[torch.Tensor], *,
                  inverse: bool, pack_parts: Optional[int],
                  plan: split.SplitPlan, count_as: str = "split",
                  call: bool = True, pre: Optional[torch.Tensor] = None,
                  keep: Optional[int] = None,
                  into: Optional[torch.Tensor] = None,
                  fold: Optional[split.FoldLayout] = None) -> torch.Tensor:
    """The split route on contiguous ``(B, N)`` lines, N = P*Q
    (``kernels/split.py``): pass A, the strided radix launch on the
    ``(B, P, Q)`` block with the inter-step twiddle (or the dense kernel's
    column form, for a general or nested plan's dense pass A), into a
    scratch block; pass B, the Q-long rows: on the radix route, and on the
    long-line route's or the dense route's stages through a thread-block
    cluster (``split.fold_layout``, :func:`_launch_fold`; counted on
    ``fold_launches`` too), stored transposed into the output with the
    line's epilogues; for a plan whose rows keep pass C (row path "any":
    a nested plan's rows on another route, rows too long for the folded
    kernel's slot and tile), the rows' own launch in natural order into a
    second scratch block that pass C transposes into the output with the
    epilogues.  All on the current stream; each
    counted on ``count_as`` ("split", or "chirp" inside the chirp route)
    and its layout, and with ``call`` the call on ``split_calls``.

    The chirp route's folded load and store (a plan with dense pass A):
    with ``pre`` ``x`` is ``(B, n_in)``, read as the first n_in of each
    (P, Q) block times ``pre``, zeros past them; with ``keep`` the last
    store (pass B's on dense rows, else pass C's) keeps only the outputs of
    index < ``keep`` (the ``pack_parts`` segments of ``keep``) into
    ``into``, the ``(p, B, keep/p)`` buffer.  ``fold`` forces the folded
    pass B's layout (a sweep's; by default ``split.fold_layout``'s)."""
    from . import build
    lib = build.load("fft_fourstep")
    _declare(lib)
    b = x.shape[0]
    n = plan.n
    if into is not None:
        buf = out = into
    elif pre is not None:
        buf = torch.empty((1, b, n), dtype=x.dtype, device=x.device)
        out = buf[0]
    else:
        buf, out = _out_buffers(x, pack_parts)
    if x.numel() == 0:
        return out
    c64 = x.dtype == torch.complex64
    suffix = "c64" if c64 else "c128"
    kept = n if keep is None else keep
    parts = pack_parts if pack_parts is not None else 1
    dev, cdt = x.device, x.dtype
    fold = fold or split.fold_layout(plan, cdt)
    with torch.cuda.device(dev):
        current = torch.cuda.current_stream(dev)
        stream = current.cuda_stream
        # pass A: (B, P, Q) -> (B, P, Q), the P-long columns; 16 bytes of
        # room past the block, which the folded dense rows' bulk copy may
        # read into from a complex64 row that ends 8 bytes off 16
        y = torch.empty(b * n + 16 // x.element_size(), dtype=cdt,
                        device=dev)[:b * n].view(b, plan.p, plan.q)
        ctile = split.column_tile(plan, cdt)
        tables = _split_constants(plan, inverse, cdt, dev)
        tables.record_stream(current)
        if plan.col_path == "dense":
            if x.data_ptr() % x.element_size():
                x = x.clone()      # the copies read whole aligned elements
            pconsts, pints = _dense_constants(plan.p, inverse, cdt, dev)
            for c in (pconsts, pints):
                c.record_stream(current)
            head = (x.data_ptr(), y.data_ptr(), pconsts.data_ptr(),
                    pints.data_ptr(), tables.data_ptr())
            tail = (len(ctile.radices), ctile.lines, ctile.line_pitch,
                    ctile.t_log2, ctile.lo, ctile.n_consts, ctile.n_ints,
                    ctile.buf_offset, int(inverse), plan.w_log2,
                    ctile.threads, ctile.smem_bytes, stream)
            if pre is not None:
                err = getattr(lib, f"repro_fft_split_a_dense_chirp_{suffix}")(
                    *head, pre.data_ptr(), b, plan.p, plan.q, x.shape[1],
                    *tail)
            else:
                err = getattr(lib, f"repro_fft_split_a_dense_{suffix}")(
                    *head, b, plan.p, plan.q, *tail)
        else:
            pconsts = _radix_constants(plan.p, inverse, cdt, dev)
            pconsts.record_stream(current)
            err = getattr(lib, f"repro_fft_split_a_{suffix}")(
                x.data_ptr(), y.data_ptr(), pconsts.data_ptr(),
                tables.data_ptr(), b, plan.p, plan.q, int(inverse),
                ctile.lines.bit_length() - 1, plan.ql_log2,
                ctile.smem_bytes, stream)
        _raise_on(err, lib, "split pass A", x)
        _count(count_as, "strided", "fourstep")
        # pass B: the Q-long rows, stored transposed at kp + P*kq (radix
        # rows, or long-line and dense rows through a cluster) or in
        # natural order (rows that keep pass C)
        seg_arg = _seg_arg(n, parts)
        twp = tw.data_ptr() if tw is not None else None
        variant = _variant(tw, pack_parts)
        if plan.row_path == "radix":
            rtile = split.row_tile(plan, cdt)
            qconsts = _radix_constants(plan.q, inverse, cdt, dev)
            qconsts.record_stream(current)
            err = getattr(lib, f"repro_fft_split_b_radix_{suffix}")(
                y.data_ptr(), buf.data_ptr(), qconsts.data_ptr(), twp,
                b * plan.p, plan.q, int(inverse), seg_arg,
                rtile.lines.bit_length() - 1, plan.p_log2,
                rtile.smem_bytes, stream)
            _raise_on(err, lib, "split pass B", x)
            _count(count_as, "lines", variant, split_call=call)
            return out
        if fold is not None:
            # pass B with pass C folded in: a cluster's rows stored
            # transposed with the epilogues
            err = _launch_fold(lib, y, buf, twp, plan, fold,
                               inverse=inverse, seg=kept // parts,
                               keep=keep, stream=stream, current=current)
            _raise_on(err, lib, "split pass B", x)
            _count(count_as, "lines", variant, split_call=call,
                   fold=fold.rows)
            return out
        # the rows that keep pass C ("any"): their own launch on their
        # route, the inverse's 1/Q included; pass C applies the 1/P
        z = _launch(y.view(b * plan.p, plan.q), None, inverse=inverse,
                    count_as=count_as)
        # pass C: (B, P, Q) rows to out[b, kp + P*kq], with the epilogues
        if keep is not None:
            err = getattr(lib, f"repro_fft_split_c_keep_{suffix}")(
                z.data_ptr(), buf.data_ptr(), twp, b, plan.p, plan.q, kept,
                kept // parts, int(inverse), stream)
        else:
            err = getattr(lib, f"repro_fft_split_c_any_{suffix}")(
                z.data_ptr(), buf.data_ptr(), twp, b, plan.p, plan.q,
                n // parts, int(inverse), stream)
    _raise_on(err, lib, "split pass C", x)
    _count(count_as, "lines", variant, split_call=call)
    return out


def _launch_fold(lib, y: torch.Tensor, buf: torch.Tensor,
                 twp: Optional[int], plan: split.SplitPlan,
                 fold: split.FoldLayout, *, inverse: bool, seg: int,
                 keep: Optional[int], stream: int, current) -> int:
    """Pass B of ``plan`` with pass C folded in (``split.fold_layout``):
    the rows of ``y``, pass A's ``(B, P, Q)`` blocks, through a cluster
    of ``fold.cluster`` blocks into ``buf`` with the epilogues, segment
    ``seg``; on the dense route's stages (``repro_fft_split_b_dense_*``,
    the outputs of < ``keep`` where given) or the long-line route's
    (``repro_fft_split_b_long_*``).  Returns the CUDA error code."""
    b, p, q = y.shape
    cdt, dev = y.dtype, y.device
    suffix = "c64" if cdt == torch.complex64 else "c128"
    if fold.rows == "long":
        consts = _long_constants(q, inverse, cdt, dev)
        consts.record_stream(current)
        return getattr(lib, f"repro_fft_split_b_long_{suffix}")(
            y.data_ptr(), buf.data_ptr(), consts.data_ptr(), twp, b * p, q,
            int(inverse), plan.p_log2, seg, fold.cluster, fold.smem_bytes,
            stream)
    rows = dense.dense_plan(q, cdt)
    consts, ints = _dense_constants(q, inverse, cdt, dev)
    for c in (consts, ints):
        c.record_stream(current)
    return getattr(lib, f"repro_fft_split_b_dense_{suffix}")(
        y.data_ptr(), buf.data_ptr(), consts.data_ptr(), ints.data_ptr(),
        twp, b, p, q, len(rows.radices), fold.lines.bit_length() - 1,
        rows.t_log2, rows.lo, rows.n_consts, rows.n_ints, rows.buf_offset,
        fold.slot_elems, fold.depth, fold.tile_pitch, int(inverse), seg,
        keep or 0, fold.cluster, fold.threads, fold.smem_bytes, stream)


def _declare(lib) -> None:
    import ctypes
    if getattr(lib, "_repro_declared", False):
        return
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.repro_fft_dense_c64, lib.repro_fft_dense_c128):
        fn.argtypes = [p, p, p, p, p, ll] + [i] * 12 + [p]
        fn.restype = i
    for fn in (lib.repro_fft_radix_c64, lib.repro_fft_radix_c128):
        fn.argtypes = [p, p, p, p, ll, ll, i, i, i, i, i, i, p]
        fn.restype = i
    for fn in (lib.repro_fft_long_c64, lib.repro_fft_long_c128,
               lib.repro_fft_wide_c64, lib.repro_fft_wide_c128):
        fn.argtypes = [p, p, p, p, ll, i, i, i, i, p]
        fn.restype = i
    for fn in (lib.repro_fft_split_a_c64, lib.repro_fft_split_a_c128):
        fn.argtypes = [p, p, p, p, ll, i, i, i, i, i, i, p]
        fn.restype = i
    for fn in (lib.repro_fft_split_b_radix_c64,
               lib.repro_fft_split_b_radix_c128):
        fn.argtypes = [p, p, p, p, ll, i, i, i, i, i, i, p]
        fn.restype = i
    for fn in (lib.repro_fft_split_c_any_c64,
               lib.repro_fft_split_c_any_c128):
        fn.argtypes = [p, p, p, ll, i, i, i, i, p]
        fn.restype = i
    for fn in (lib.repro_fft_split_b_long_c64,
               lib.repro_fft_split_b_long_c128):
        fn.argtypes = [p, p, p, p, ll, i, i, i, i, i, i, p]
        fn.restype = i
    for fn in (lib.repro_fft_split_b_dense_c64,
               lib.repro_fft_split_b_dense_c128):
        fn.argtypes = [p, p, p, p, p, ll] + [i] * 18 + [p]
        fn.restype = i
    for fn in (lib.repro_fft_split_a_dense_c64,
               lib.repro_fft_split_a_dense_c128):
        fn.argtypes = [p, p, p, p, p, ll] + [i] * 14 + [p]
        fn.restype = i
    for fn in (lib.repro_fft_dense_chirp_c64, lib.repro_fft_dense_chirp_c128):
        fn.argtypes = [p, p, p, p, p, p, ll] + [i] * 14 + [p]
        fn.restype = i
    for fn in (lib.repro_fft_split_a_dense_chirp_c64,
               lib.repro_fft_split_a_dense_chirp_c128):
        fn.argtypes = [p, p, p, p, p, p, ll] + [i] * 15 + [p]
        fn.restype = i
    for fn in (lib.repro_fft_long_chirp_c64, lib.repro_fft_long_chirp_c128):
        fn.argtypes = [p, p, p, p, p, ll] + [i] * 8 + [p]
        fn.restype = i
    for fn in (lib.repro_fft_split_c_keep_c64, lib.repro_fft_split_c_keep_c128):
        fn.argtypes = [p, p, p, ll, i, i, i, i, i, p]
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
    the radix kernel's lengths (``radix.RADIX_SIZES``, the wide lines that
    contiguous lines take to the long route too), with a strided tile
    inside one block's shared memory."""
    return (dtype in DTYPES and n in radix.RADIX_SIZES.get(dtype, ())
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


_COUNT_LOCK = threading.Lock()
fft_fourstep.launches = 0
fft_fourstep.variant_launches = {"fourstep": 0, "pack": 0, "twiddle": 0}
fft_fourstep.path_launches = {"radix": 0, "dense": 0, "long": 0,
                              "split": 0, "chirp": 0}
fft_fourstep.layout_launches = {"lines": 0, "strided": 0}
fft_fourstep.split_calls = 0
fft_fourstep.fold_launches = {"dense": 0, "long": 0}
fft_fourstep.chirp_calls = 0
fft_fourstep.aligned_copies = 0


def launch_counts() -> Dict[str, int]:
    """One consistent snapshot of the launch counters, flat: ``launches``
    and one entry per variant, path and layout, ``split_calls`` (the
    split route's calls, two launches each, three where a nested plan's
    rows keep pass C), ``fold_dense`` and ``fold_long`` (the split route's
    pass B with pass C folded in, on dense or long-line rows, on any
    path), ``chirp_calls`` (the chirp route's, two inner transforms each)
    and ``aligned_copies`` (long-route lines cloned because they did not
    start on 16 bytes, as the bulk copies need)."""
    with _COUNT_LOCK:
        return {"launches": fft_fourstep.launches,
                **fft_fourstep.variant_launches,
                **fft_fourstep.path_launches,
                **fft_fourstep.layout_launches,
                "split_calls": fft_fourstep.split_calls,
                "fold_dense": fft_fourstep.fold_launches["dense"],
                "fold_long": fft_fourstep.fold_launches["long"],
                "chirp_calls": fft_fourstep.chirp_calls,
                "aligned_copies": fft_fourstep.aligned_copies}


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        fft_fourstep.launches = 0
        fft_fourstep.split_calls = 0
        fft_fourstep.chirp_calls = 0
        fft_fourstep.aligned_copies = 0
        for counts in (fft_fourstep.variant_launches,
                       fft_fourstep.path_launches,
                       fft_fourstep.layout_launches,
                       fft_fourstep.fold_launches):
            for k in counts:
                counts[k] = 0
