"""The dense route of the four-step kernel (``kernels/dense.py``,
``csrc/fft_dense.cuh``): a mixed-radix FFT over a chain chosen at run
time, whole lines in shared memory.  Its plain version, ``dense.emulate``
(the wrapper runs it for CPU tensors), runs the kernel's stages, index
maps, twiddle products and store order; it is held against ``np.fft`` at
one length per family -- odd 13-smooth N (complex64 75, 4725), the even
13-smooth N that no codelets of the radix or long-line route hold
(complex64 2730, 3430, 4050, complex128 990), the spill lengths
(complex64 208, complex128 22), N with a prime factor past 13 that
``dense.GENERIC_COST`` keeps (816 = 17*48) and such a prime (17), and the
13-smooth lengths past the old
one-block limit that left the chirp route (complex128 2420, 8448,
complex64 16896) -- both directions, the twiddle and ``pack_parts``
epilogues, and against the JAX package's Pallas kernel in interpret mode
on the same numpy inputs at the short ones (complex128 in one x64
subprocess), at the reference's tolerances (``tests/test_kernels.py:27``:
5e-6 max-scaled in complex64, 1e-12 in complex128).  Then the plan (the
chain, the output permutation, the tables) and the route's domain.  The
CUDA kernel itself is tested in ``test_torch_cuda.py`` and
``chip_smoke.py``."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft_matmul as jfm
from repro_torch.kernels import chirp, dense, longline, ops, radix
from repro_torch.kernels import fft_matmul as tfm
from torch_harness import (assert_scaled_close, dense_keeps,
                           pallas_lines_c128)

TOL = {torch.complex64: 5e-6, torch.complex128: 1e-12}
NP = {torch.complex64: np.complex64, torch.complex128: np.complex128}
c64, c128 = torch.complex64, torch.complex128
LENGTHS = [(c64, 75), (c64, 4725), (c64, 2730), (c64, 3430), (c64, 4050),
           (c128, 990), (c64, 208), (c128, 22), (c64, 816), (c64, 17),
           (c128, 2420), (c128, 8448), (c64, 16896)]
#: Where the Pallas kernel runs here in seconds: its dense DFT matrices
#: grow with N1 and N2.
PALLAS = {75, 208, 22, 816, 17, 990, 2730}


def _variants(n):
    """(batch, inverse, twiddle, pack_parts): both directions, each
    epilogue; a segment that is not a power of two where 3 divides N."""
    parts = 3 if n % 3 == 0 else 2 if n % 2 == 0 else None
    return [(2, False, False, None), (1, True, True, None),
            (3, False, True, parts), (1, True, False, parts)]


CASES = [(dtype, n, *v) for dtype, n in LENGTHS for v in _variants(n)]


def _case_id(case):
    dtype, n, b, inv, tw, parts = case
    return (f"{str(dtype).removeprefix('torch.')}-{n}-b{b}-"
            f"{'inv' if inv else 'fwd'}-tw{int(tw)}-p{parts}")


def _inputs(case):
    dtype, n, b, inv, tw, parts = case
    r = np.random.default_rng(n + 10 * b + int(inv) + 100 * int(tw))
    x = (r.standard_normal((b, n)) + 1j * r.standard_normal((b, n))
         ).astype(NP[dtype])
    t = np.exp(-1j * np.pi * np.arange(n) / (2 * n)).astype(NP[dtype]) \
        if tw else None
    return x, t


def _numpy_ref(case, x, t):
    dtype, n, b, inv, tw, parts = case
    y = (np.fft.ifft if inv else np.fft.fft)(x.astype(np.complex128),
                                             axis=-1)
    if t is not None:
        y = t * y
    return y if parts is None else y.reshape(b, parts, n // parts)


@pytest.fixture(scope="module")
def pallas_c128(tmp_path_factory):
    """The Pallas kernel's complex128 results (interpret mode under
    ``jax_enable_x64``, every case in one fresh process)."""
    cases = {}
    for case in CASES:
        if case[0] != c128 or case[1] not in PALLAS:
            continue
        x, t = _inputs(case)
        cases[_case_id(case).replace("-", "_")] = (x, t, case[3], case[5])
    return pallas_lines_c128(cases,
                             str(tmp_path_factory.mktemp("dense_x64")))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_dense_route_matches_numpy_and_pallas(case, request):
    """The route's plain version, through the wrapper on CPU tensors,
    against np.fft and (at the short lengths) the Pallas kernel on the
    same inputs; no launch is counted on the CPU."""
    dtype, n, b, inv, tw, parts = case
    assert radix.kernel_path(n, dtype) == "dense"
    x, t = _inputs(case)
    tfm.reset_launch_counts()
    got = tfm.fft_fourstep(torch.from_numpy(x), inverse=inv,
                           twiddle=None if t is None else torch.from_numpy(t),
                           pack_parts=parts)
    assert tfm.launch_counts()["launches"] == 0
    assert got.dtype == dtype
    assert tuple(got.shape) == ((b, n) if parts is None
                                else (b, parts, n // parts))
    if parts is not None:       # destination-major (p, B, N/p) storage
        assert got.transpose(0, 1).is_contiguous()
    got = got.numpy()
    assert_scaled_close(got, _numpy_ref(case, x, t), TOL[dtype])
    if n not in PALLAS:
        return
    if dtype == c64:
        twp = None if t is None else (jnp.asarray(t.real),
                                      jnp.asarray(t.imag))
        yr, yi = jfm.fft1d_planes(jnp.asarray(x.real), jnp.asarray(x.imag),
                                  inverse=inv, twiddle=twp, pack_parts=parts)
        assert yr.dtype == jnp.float32
        pallas = np.asarray(yr) + 1j * np.asarray(yi)
    else:
        pallas = request.getfixturevalue("pallas_c128")[
            _case_id(case).replace("-", "_")]
    assert_scaled_close(got, pallas, TOL[dtype])


#: Lengths of every chain shape: N = 1, a prime, codelet stages only, 4s
#: and a last 2, one and two generic stages, the longest lines.
PLAN_LENGTHS = [1, 2, 9, 22, 75, 208, 289, 323, 504, 17, 816, 990, 2730,
                4050, 4725, 4199, 8448, 16896, 23040, 28028, 28431]


@pytest.mark.parametrize("n", PLAN_LENGTHS)
def test_dense_plan_chain_permutation_and_tables(n):
    """The chain multiplies out to N, every radix is a prime or 4 (the
    primes past 13 first, then 13, 11, 7, 5, 3, 4, 2 in that order, at
    most one 2 and it last); the spans and M's are the products after and
    before each stage; the output permutation PL[k mod L] + PH[k div L]
    is each output's digit position and a bijection of range(N); the
    tables are W_N^i, W_N^(i*T) and W_p^m; the layout holds one buffer
    for a 13-smooth N and two with a generic stage, and a block of the
    wide thread count where it has its SM alone."""
    dtype = c64 if n * 8 <= radix.SMEM_MAX_BYTES else c128
    plan = dense.dense_plan(n, dtype)
    rs = plan.radices
    assert math.prod(rs) == n
    for r in rs:
        assert r == 4 or (r > 1 and all(r % p for p in range(2, r)))
    order = [13, 11, 7, 5, 3, 4, 2]
    rough = [r for r in rs if r > 13]
    assert list(rs[:len(rough)]) == sorted(rough, reverse=True)
    tail = [order.index(r) for r in rs[len(rough):]]
    assert tail == sorted(tail) and rs.count(2) <= 1
    assert 2 not in rs[:-1]
    for t in range(len(rs)):
        assert plan.spans[t] == math.prod(rs[t + 1:])
        assert plan.muls[t] == math.prod(rs[:t])
    cplx, ints = dense.constants(plan, inverse=False)
    assert len(cplx) == plan.n_consts and len(ints) == plan.n_ints
    base = 4 * len(rs)
    pl, ph = ints[base:base + plan.lo], ints[base + plan.lo:]
    k = np.arange(n)
    pos = pl[k % plan.lo] + ph[k // plan.lo]
    assert sorted(pos.tolist()) == list(range(n))
    for kk in {0, n // 2, n - 1}:
        assert pos[kk] == dense.digits_position(kk, rs, plan.spans)
    t = 1 << plan.t_log2
    assert t * t >= n and plan.tb_len * t >= n
    w = np.exp(-2j * np.pi * np.arange(n) / n)
    np.testing.assert_allclose(cplx[:t], w[:t], atol=1e-15)
    np.testing.assert_allclose(cplx[t:t + plan.tb_len],
                               np.exp(-2j * np.pi * np.arange(plan.tb_len)
                                      * t / n), atol=1e-15)
    for st, r in enumerate(rs):
        assert tuple(ints[4 * st:4 * st + 3]) == (r, plan.spans[st],
                                                  plan.muls[st])
        if r > 13:
            off = ints[4 * st + 3]
            np.testing.assert_allclose(
                cplx[off:off + r], np.exp(-2j * np.pi * np.arange(r) / r),
                atol=1e-15)
    assert plan.buffers == (2 if rough else 1)
    assert plan.smem_bytes <= radix.SMEM_MAX_BYTES
    # the wide block where one block has the SM alone
    narrow, wide = dense.THREADS[dtype.itemsize]
    assert plan.threads == (wide if plan.smem_bytes
                            > radix.SMEM_TARGET_BYTES else narrow)


@pytest.mark.parametrize("dtype,count,first,last", [
    (c64, 508, 4840, 28431), (c128, 372, 2420, 14196)])
def test_dense_route_takes_the_smooth_lines_that_fit_one_block(
        dtype, count, first, last):
    """Every N up to ``dense.DENSE_LIMIT`` that no other route takes stays
    "dense" while its generic stages cost no more than the chirp route
    (``dense.GENERIC_COST``) and takes the chirp route past it; past the limit the route takes exactly
    the 13-smooth N that no other route takes and whose line and tables
    fit one block (``dense.fits``), the split route's general plans the
    other 13-smooth N, and the chirp route every other N up to its limit:
    no N with a prime factor past 13 leaves the chirp there, and none of
    the radix, long-line and split lengths moves."""
    from repro_torch.kernels import longline, split
    limit = dense.DENSE_LIMIT[dtype]
    taken = []
    for n in range(1, 2 * radix.SMEM_MAX_BYTES // dtype.itemsize):
        path = radix.kernel_path(n, dtype)
        other = (n in radix.RADIX_SIZES[dtype]
                 or n in longline.FACTORS[dtype]
                 or n in split.FACTORS[dtype])
        if other:
            assert path != "dense" and path != "chirp", n
        elif n <= limit:
            want = ("dense" if dense_keeps(n, dense.GENERIC_COST[dtype],
                                           dense.MOVE_MARGIN,
                                           longline.FOLD_SIZES[dtype], dtype.itemsize)
                    else "chirp")
            assert path == want, n
        elif radix.smooth(n) and dense.fits(n, dtype):
            assert path == "dense", n
            taken.append(n)
        elif radix.smooth(n):
            assert path == "split" and not chirp.takes(n, dtype), n
        else:
            assert path == "chirp" and chirp.takes(n, dtype), n
    assert len(taken) == count and taken[0] == first and taken[-1] == last
    plan = dense.dense_plan(last, dtype)
    assert plan.lines == 1 and plan.buffers == 1
    assert plan.smem_bytes <= radix.SMEM_MAX_BYTES
    nxt = next(m for m in range(last + 1, 2 * last) if radix.smooth(m))
    assert not dense.fits(nxt, dtype)


def test_dense_lines_along_any_axis_and_their_gradient():
    """``ops.fft1d`` on a dense N: contiguous lines in place, a strided
    axis copied contiguous first (``ops.copies``); the transform's
    gradient (``LineTransform``: the adjoint on the same route) against
    ``torch.fft``'s, both directions."""
    n = 4725
    r = np.random.default_rng(6)
    x = (r.standard_normal((2, n, 3)) + 1j * r.standard_normal(
        (2, n, 3))).astype(np.complex64)
    ops.copies["lines"] = 0
    got = ops.fft1d(torch.from_numpy(x), 1)
    assert ops.copies["lines"] == 1
    assert_scaled_close(got.numpy(), np.fft.fft(x, axis=1), 5e-6)
    lines = torch.from_numpy(np.ascontiguousarray(x[:, :, 0]))
    got = ops.ifft1d(lines, -1)
    assert ops.copies["lines"] == 1
    assert_scaled_close(got.numpy(), np.fft.ifft(x[:, :, 0], axis=-1), 5e-6)
    g = torch.from_numpy(r.standard_normal((2, n)).astype(np.complex64))
    for fns in ((ops.fft1d, torch.fft.fft), (ops.ifft1d, torch.fft.ifft)):
        grads = []
        for fn in fns:
            xx = lines.clone().requires_grad_(True)
            (fn(xx) * g).real.sum().backward()
            grads.append(xx.grad.numpy())
        assert_scaled_close(grads[0], grads[1], 5e-6)
