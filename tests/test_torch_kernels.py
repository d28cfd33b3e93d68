"""The port's four-step kernel module (``repro_torch/kernels``): every case
of ``tests/test_kernels.py`` on the wrappers, which run the kernel's plain
version for CPU tensors, held against the JAX package's Pallas kernel in
interpret mode (or ``np.fft``, as the reference test does), and the launch
sizing, and the build's parallel units (with a stand-in ``nvcc``).  The
CUDA kernel itself is tested in ``test_torch_cuda.py``."""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # hermetic container: fixed-seed shim
    from _propcheck import given, settings, strategies as st

from repro.kernels import fft_matmul as jfm
from repro.kernels import ops as jops
from repro_torch.kernels import fft_matmul as tfm
from repro_torch.kernels import ops, radix, ref
from repro_torch.core.redistribute import send_buffer
from torch_harness import assert_scaled_close, cplx

rng = np.random.default_rng(7)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("b,n", [(1, 16), (4, 64), (8, 128), (3, 96),
                                 (130, 512), (2, 33), (5, 1024)])
def test_forward_sweep_matches_pallas(b, n):
    x = cplx((b, n), 100 + n)
    got = ops.fft1d(_t(x)).numpy()
    want = np.asarray(jops.fft1d(jnp.asarray(x)))
    assert_scaled_close(got, want, 5e-6)
    assert_scaled_close(got, ref.fft1d_ref(_t(x)).numpy(), 5e-6)


@pytest.mark.parametrize("b,n", [(4, 64), (2, 256)])
def test_inverse_sweep_matches_pallas(b, n):
    x = cplx((b, n), 200 + n)
    got = ops.ifft1d(_t(x)).numpy()
    assert_scaled_close(got, np.asarray(jops.ifft1d(jnp.asarray(x))), 5e-6)
    assert_scaled_close(got, ref.ifft1d_ref(_t(x)).numpy(), 5e-6)


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
def test_axis_handling(axis):
    x = cplx((4, 6, 8), 3)
    got = ops.fft1d(_t(x), axis).numpy()
    np.testing.assert_allclose(got, np.fft.fft(x, axis=axis),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plane_dtypes(dtype):
    xr = rng.standard_normal((4, 32)).astype(dtype)
    xi = rng.standard_normal((4, 32)).astype(dtype)
    cdt = torch.complex64 if dtype == np.float32 else torch.complex128
    out = tfm.fft_fourstep(torch.complex(_t(xr), _t(xi)).to(cdt))
    assert out.dtype == cdt
    refr, refi = ref.fft1d_planes_ref(_t(xr), _t(xi))
    np.testing.assert_allclose(out.real.numpy(), refr.numpy(),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(out.imag.numpy(), refi.numpy(),
                               rtol=1e-3, atol=1e-3)


def test_batch_not_a_tile_multiple():
    for b in (1, 127, 129, 300):
        x = cplx((b, 64), b)
        np.testing.assert_allclose(ops.fft1d(_t(x)).numpy(),
                                   np.fft.fft(x, axis=-1),
                                   rtol=1e-4, atol=1e-3)


@settings(max_examples=15, deadline=None)
@given(b=st.integers(1, 9), n=st.sampled_from([8, 16, 32, 48, 64, 128]),
       inverse=st.booleans(), seed=st.integers(0, 2**31 - 1))
def test_property_roundtrip(b, n, inverse, seed):
    x = cplx((b, n), seed)
    fwd = ops.fft1d(_t(x)) if not inverse else ops.ifft1d(_t(x))
    back = ops.ifft1d(fwd) if not inverse else ops.fft1d(fwd)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n", [13, 17, 31])
@pytest.mark.parametrize("inverse", [False, True])
def test_prime_n_degenerate(n, inverse):
    x = cplx((4, n), n)
    fn, want = (ops.ifft1d, np.fft.ifft) if inverse else (ops.fft1d,
                                                           np.fft.fft)
    np.testing.assert_allclose(fn(_t(x)).numpy(), want(x, axis=-1),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("axis", [0, 1, 2, -1, -2])
@pytest.mark.parametrize("inverse", [False, True])
def test_every_axis_both_directions(axis, inverse):
    x = cplx((3, 5, 8), 17)
    fn, want = (ops.ifft1d, np.fft.ifft) if inverse else (ops.fft1d,
                                                           np.fft.fft)
    np.testing.assert_allclose(fn(_t(x), axis).numpy(), want(x, axis=axis),
                               rtol=1e-4, atol=1e-4)


def test_complex128_parity():
    r = np.random.default_rng(3)
    x = r.standard_normal((5, 48)) + 1j * r.standard_normal((5, 48))
    y = ops.fft1d(_t(x))
    assert y.dtype == torch.complex128
    np.testing.assert_allclose(y.numpy(), np.fft.fft(x, axis=-1),
                               rtol=1e-10, atol=1e-9)
    yi = ops.ifft1d(_t(x), 0)
    np.testing.assert_allclose(yi.numpy(), np.fft.ifft(x, axis=0),
                               rtol=1e-10, atol=1e-9)


def test_empty_batch():
    out = tfm.fft_fourstep(torch.zeros((0, 16), dtype=torch.complex64))
    assert out.shape == (0, 16) and out.dtype == torch.complex64
    packed = tfm.fft_fourstep(torch.zeros((0, 16), dtype=torch.complex64),
                              pack_parts=4)
    assert packed.shape == (0, 4, 4)
    y = ops.fft1d(torch.zeros((0, 8, 16), dtype=torch.complex64), -1)
    assert y.shape == (0, 8, 16) and y.dtype == torch.complex64
    y2 = ops.ifft1d(torch.zeros((4, 0, 16), dtype=torch.complex64), 1)
    assert y2.shape == (4, 0, 16)
    send = ops.packed_fft1d(torch.zeros((0, 8), dtype=torch.complex64), 1, 2)
    assert send.shape == (2, 0, 4)


@pytest.mark.parametrize("inverse", [False, True])
def test_twiddle_epilogue_matches_pallas(inverse):
    x = cplx((6, 24), 21)
    t = np.exp(-1j * np.pi * np.arange(24) / 48).astype(np.complex64)
    fn, jfn = (ops.ifft1d, jops.ifft1d) if inverse else (ops.fft1d,
                                                          jops.fft1d)
    got = fn(_t(x), twiddle=_t(t)).numpy()
    want = np.asarray(jfn(jnp.asarray(x), twiddle=jnp.asarray(t)))
    assert_scaled_close(got, want, 5e-6)
    base = np.fft.ifft if inverse else np.fft.fft
    np.testing.assert_allclose(got, t * base(x, axis=-1), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("parts", [2, 4, 8])
def test_pack_parts_epilogue_matches_pallas(parts):
    x = cplx((5, 32), 30 + parts)
    got = tfm.fft_fourstep(_t(x), pack_parts=parts)
    assert tuple(got.shape) == (5, parts, 32 // parts)
    # destination-major storage: the (p, B, N/p) buffer is contiguous
    assert got.transpose(0, 1).is_contiguous()
    jr, ji = jfm.fft1d_planes(jnp.asarray(x.real), jnp.asarray(x.imag),
                              pack_parts=parts)
    assert_scaled_close(got.numpy(), np.asarray(jr) + 1j * np.asarray(ji),
                        5e-6)
    np.testing.assert_allclose(ops.fft1d(_t(x), pack_parts=parts).numpy(),
                               np.fft.fft(x, axis=-1), rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError, match="pack_parts"):
        tfm.fft_fourstep(torch.zeros((2, 32), dtype=torch.complex64),
                         pack_parts=5)


@pytest.mark.parametrize("axis,parts", [(0, 2), (1, 4), (2, 2)])
def test_packed_fft1d_is_the_send_buffer(axis, parts):
    """The pipeline's packed store is exactly the send buffer redistribute
    would build from the logical result — as a view of the kernel output."""
    x = _t(cplx((8, 4, 8), 40 + axis))
    send = ops.packed_fft1d(x, axis, parts)
    logical = ops.fft1d(x, axis)
    assert torch.equal(send, send_buffer(logical, axis, parts))
    assert send.is_contiguous()
    ifft_send = ops.packed_fft1d(x, axis, parts, inverse=True)
    assert torch.equal(ifft_send,
                       send_buffer(ops.ifft1d(x, axis), axis, parts))


def test_constant_planes_match_reference():
    """The kernel's complex constants equal the Pallas kernel's planes."""
    for n1, n2, inv in ((16, 32, False), (1, 13, True), (4, 6, False)):
        consts = tfm._device_constants(n1, n2, inv, torch.complex128,
                                       torch.device("cpu"))
        j = jfm._planes(n1, n2, inv, "float64")
        for got, (re, im) in zip(consts, (j[0:2], j[2:4], j[4:6])):
            np.testing.assert_allclose(got.numpy(), re + 1j * im, atol=1e-12)


def test_launch_config_fits_shared_memory():
    """The dense route's layout (``dense.dense_plan``): the most lines (a
    power of two) within 4096 elements, two blocks an SM where they fit
    (a 13-smooth N in one buffer, in place; a generic stage writes a
    second), one line of every length up to the route's limit within 227
    KB, and a ``ValueError`` past the route's domain naming the chirp's
    limit."""
    from repro_torch.kernels import dense
    cfg = tfm.launch_config(75, 8)
    plan = dense.dense_plan(75, torch.complex64)
    assert (cfg.lines, cfg.buffers) == (32, 1) == (plan.lines, plan.buffers)
    assert cfg.smem_bytes == plan.smem_bytes == plan.buf_offset + \
        32 * 75 * 8 <= tfm.SMEM_MAX_BYTES // 2
    generic = tfm.launch_config(816, 8)              # 816 = 17*48
    assert generic.buffers == 2 and generic.lines == 4   # a generic stage
    assert generic.smem_bytes <= radix.SMEM_TARGET_BYTES
    c128 = tfm.launch_config(990, 16)
    assert (c128.lines, c128.buffers) == (4, 1)
    assert c128.smem_bytes <= radix.SMEM_TARGET_BYTES
    for dtype, limit in dense.DENSE_LIMIT.items():
        item = dtype.itemsize
        # the longest lines the route keeps up to its limit (the longer
        # ones whose generic stages cost more are the chirp's)
        near = [m for m in range(limit, 0, -1) if dense.takes(m, dtype)]
        for n in near[:2] + [4725, 4199]:
            if n > limit:
                continue
            one = tfm.launch_config(n, item)
            assert one.smem_bytes <= tfm.SMEM_MAX_BYTES
            assert one.lines >= 1 and one.lines & (one.lines - 1) == 0
        big = tfm.launch_config(28431 if item == 8 else 14196, item)
        assert big.lines == 1 and big.buffers == 1
        assert big.smem_bytes <= tfm.SMEM_MAX_BYTES
        # past the limit, a prime factor past 13 (complex64 4836 =
        # 4*3*13*31, complex128 2421 = 9*269) is the chirp's
        rough = next(m for m in range(limit + 1, 2 * limit)
                     if not radix.smooth(m))
        with pytest.raises(ValueError, match=f"N up to {limit}"):
            tfm.launch_config(rough, item)
    # the radix path's tiles: a row per thread at N = 512, two blocks per
    # SM for contiguous lines, one block's 227 KB for strided tiles
    main = radix.radix_tile(512, 8, False, strided=False)
    assert main.lines == 16 and main.smem_bytes == 8 * (
        512 + 16 + 16 * 16 * 33)
    assert main.lines * 16 == radix.THREADS
    strided = radix.radix_tile(512, 8, True, strided=True)
    assert strided.lines == radix.STRIDED_LINES
    assert strided.smem_bytes == 8 * (512 + 16 + 512 + 16 * 512)
    for dtype, sizes in radix.RADIX_SIZES.items():
        item = dtype.itemsize
        for n in sizes:
            for tw in (False, True):
                tile = radix.radix_tile(n, item, tw, strided=False)
                assert tile.smem_bytes <= radix.SMEM_TARGET_BYTES
                assert tile.lines & (tile.lines - 1) == 0
                st = radix.radix_tile(n, item, tw, strided=True)
                need = item * (radix.const_elems(n, tw) + radix.tile_elems(
                    n, radix.STRIDED_LINES, True))
                assert (st is None) == (need > tfm.SMEM_MAX_BYTES)
                if radix.is_pow2(n):
                    assert (st is None) == (n * item > 8 * 1024)
                if st is not None:
                    assert st.smem_bytes == need <= tfm.SMEM_MAX_BYTES
    assert not tfm.strided_supported(2048, torch.complex64, False)
    assert not tfm.strided_supported(1024, torch.complex128, False)
    assert not tfm.strided_supported(3840, torch.complex64, False)
    assert tfm.strided_supported(96, torch.complex64, False)    # mixed
    assert not tfm.strided_supported(33, torch.complex64, False)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="complex64 or complex128"):
        tfm.fft_fourstep(torch.zeros((2, 8)))
    with pytest.raises(ValueError, match="contiguous"):
        tfm.fft_fourstep(torch.zeros((8, 2), dtype=torch.complex64).T)
    with pytest.raises(ValueError, match=r"\(B, N\)"):
        tfm.fft_fourstep(torch.zeros((2, 2, 8), dtype=torch.complex64))
    with pytest.raises(ValueError, match="twiddle"):
        tfm.fft_fourstep(torch.zeros((2, 8), dtype=torch.complex64),
                         twiddle=torch.ones(4, dtype=torch.complex64))
    with pytest.raises(ValueError, match="meta"):
        tfm.fft_fourstep(torch.zeros((2, 8), dtype=torch.complex64,
                                     device="meta"))


def test_cpu_runs_the_plain_version_without_counting_launches():
    tfm.reset_launch_counts()
    ops.fft1d(_t(cplx((4, 16), 1)))
    assert tfm.fft_fourstep.launches == 0
    assert set(tfm.fft_fourstep.variant_launches) == {"fourstep", "pack",
                                                      "twiddle"}
    assert tfm.fft_fourstep.path_launches == {"radix": 0, "dense": 0,
                                              "long": 0, "split": 0,
                                              "chirp": 0}
    assert tfm.fft_fourstep.layout_launches == {"lines": 0, "strided": 0}


def test_kernel_operands_are_resolved():
    """The kernel reads raw memory: a lazily conjugated operand or twiddle
    (and a negated view) is materialized before its pointer is taken."""
    x = _t(cplx((3, 16), 50))
    tw = _t(np.exp(-1j * np.pi * np.arange(16) / 32).astype(np.complex64))
    assert x.conj().is_conj() and x.conj().imag.is_neg()
    rx, rtw = tfm._resolved(x.conj(), tw.conj())
    assert not rx.is_conj() and not rtw.is_conj()
    assert torch.equal(rx, torch.conj_physical(x))
    assert torch.equal(rtw, torch.conj_physical(tw)) and rtw.is_contiguous()
    negated = torch._neg_view(x)  # repro-lint: disable=REP001 no public API
    neg, _ = tfm._resolved(negated, None)
    assert not neg.is_neg() and torch.equal(neg, -x)
    assert tfm._resolved(x, None)[0] is x       # nothing to do: no copy
    # the wrapper's result honours the bits (the plain version on the CPU)
    got = tfm.fft_fourstep(x.conj(), twiddle=tw.conj())
    want = np.conj(tw.numpy()) * np.fft.fft(np.conj(x.numpy()), axis=-1)
    assert_scaled_close(got.numpy(), want, 5e-6)


@pytest.mark.parametrize("n,dtype,path", [
    (1, torch.complex64, "dense"), (2, torch.complex64, "radix"),
    (512, torch.complex64, "radix"), (4096, torch.complex64, "radix"),
    (8192, torch.complex64, "long"), (24, torch.complex64, "radix"),
    (33, torch.complex64, "dense"), (96, torch.complex64, "radix"),
    (521, torch.complex64, "chirp"), (1024, torch.complex128, "radix"),
    (2, torch.complex128, "dense"), (4, torch.complex128, "radix"),
    (2048, torch.complex128, "long"), (4096, torch.complex128, "long"),
    (48, torch.complex128, "radix"), (16384, torch.complex64, "long"),
    (8192, torch.complex128, "long"), (32768, torch.complex64, "split"),
    (16384, torch.complex128, "split"), (1 << 24, torch.complex64, "split"),
    (1 << 22, torch.complex128, "split"), (1 << 25, torch.complex64, "split"),
    (1 << 23, torch.complex128, "split"), (11520, torch.complex64, "long"),
    ((1 << 30) + 1, torch.complex64, "dense"),
    (13312, torch.complex64, "long"), (208, torch.complex128, "radix"),
    (208, torch.complex64, "dense"), (10752, torch.complex64, "long"),
    (672, torch.complex64, "radix"), (4032, torch.complex64, "radix"),
    (4480, torch.complex64, "long"), (21 << 10, torch.complex64, "split"),
    (600, torch.complex64, "radix"), (600, torch.complex128, "radix"),
    (3600, torch.complex64, "radix"), (3780, torch.complex64, "radix"),
    (900, torch.complex128, "radix"), (2730, torch.complex64, "dense"),
    (1000, torch.complex128, "long"), (544, torch.complex64, "radix"),
    (75, torch.complex64, "dense"), (4800, torch.complex64, "long"),
    (4864, torch.complex64, "long"), (23040, torch.complex64, "dense"),
    (4050, torch.complex64, "dense"), (990, torch.complex128, "dense"),
    (4725, torch.complex64, "dense"), (33792, torch.complex64, "split"),
    (16896, torch.complex64, "dense"), (8448, torch.complex128, "dense"),
    (2432, torch.complex64, "radix"), (608, torch.complex128, "radix"),
    (2432, torch.complex128, "long"), (816, torch.complex64, "dense"),
    (4831, torch.complex64, "chirp"), (19 << 19, torch.complex64, "split"),
    (17 << 17, torch.complex128, "split"), (2944, torch.complex64, "radix"),
    (736, torch.complex128, "radix"), (5888, torch.complex64, "long"),
    (2944, torch.complex128, "long"), (23 << 10, torch.complex64, "split"),
    (23 << 19, torch.complex64, "split"), (33 << 18, torch.complex64, "split"),
    (7424, torch.complex64, "chirp"), (3712, torch.complex128, "chirp"),
    (29106, torch.complex64, "split"), (20011, torch.complex64, "chirp")])
def test_kernel_path_selection(n, dtype, path):
    """The path follows N and the dtype alone: N with a radix
    instantiation (powers of two, and mixed r*2^k such as 24, 96 and
    complex128 48) takes the radix kernel, longer power-of-two N whose
    line fits in a block's shared memory the long-line kernel, the
    power-of-two N beyond one block up to 2^24 (complex64) / 2^22
    (complex128) the split route, every other N up to half those that
    the dense route does not take (the primes 521 and 4831, whose generic
    stage costs more than the chirp, ``dense.GENERIC_COST``; 7424 =
    29*2^8, complex128 3712 = 29*2^7, the prime 20011) the chirp route
    (29106 = 2*14553, 13-smooth, a line past one block whose single
    factor of 2 no radix P takes, the split route's general plans), every
    other N the dense one: every N up to the old dense kernel's limit
    (complex64 4835, complex128 2419) whose generic stages cost less
    (816 = 17*48), and
    past it the 13-smooth N whose line fits one block (23040 = 45*512 and
    16896 = 33*512, past the long-line route's 128 KB line; complex128
    8448),
    the mixed-radix kernel in shared memory since it replaced the dense
    matrices, which needed one block for W1, W2 and the line (the card
    refuses the route past its domain: 2^30 + 1; 2^25 / 2^23, which it
    refused before, take the split route's nested plans).  The mixed lengths past the radix route (13312 =
    13*1024 and 10752 = 21*512 are long lines, 21*1024 a split one):
    test_torch_long_mixed_fft.py and test_torch_split_mixed_fft.py; so
    are the other even 13-smooth lengths up to a 128 KB line that three
    codelets of at most 32 take (11520 = 30 x 12 x 32, 4480 = 28 x 10 x
    16, 4800 = 30 x 10 x 16, complex128 1000 = 25 x 5 x 8: a mixed R2).
    complex64 208 = 13x16 is dense: ptxas spills its radix kernel; 4032 =
    63x64 takes the radix route, and so do the even 13-smooth lengths
    with an odd part from 65 whose factors both fit a codelet (600 = 24 x
    25, 3600 = 60 x 60, 3780 = 60 x 63, complex128 900 = 30 x 30); those
    that no route takes (2730 = 42 x 65, 4050 = 2 x 2025, complex128
    990 = 2 x 495) and odd N (75, 4725) run dense.  17*2^k and 19*2^k
    take the radix route since the radix-17 and radix-19 codelets (544 =
    17 x 32, 2432 = 38 x 64, complex128 608 = 19 x 32), the long-line
    route past it (4864 = 19 x 16 x 16, complex128 2432 = 19 x 8 x 16)
    and the split route to 2^24 / 2^22 (19*2^19, complex128 17*2^17, past
    the chirp's limit); so does 23*2^k since the radix-23 codelet (2944 =
    46 x 64, complex128 736 = 23 x 32; 5888 = 23 x 16 x 16, complex128
    2944 = 23 x 8 x 16; 23*2^10 = 256 x 92 to 23*2^19 = 1024 x 11776).
    The split route's rule (``split.rule_factors``) takes the 13-smooth
    lines past one block that a P and a radix or long-line row hold
    (33792 = 33*2^10 = 256 x 132, the chirp's before; 33*2^18 = 1024 x
    8448, past the chirp's limit, which raised).  The radix route's wide
    lines (``longline.WIDE``: 4096, 4032, 3600, 2944, complex128 1024,
    900, 736, 608, 600, 544) take the long route's wide kernel on
    contiguous lines: ``path`` names the route of their table."""
    from repro_torch.kernels import longline
    if path == "radix" and n in longline.WIDE.get(dtype, {}):
        path = "long"
    assert radix.kernel_path(n, dtype) == path


def test_radix_plan_factors_and_codelets():
    for k in range(1, 13):
        n = 2 ** k
        plan = radix.radix_plan(n)
        assert (plan.n1, plan.n2) == (2 ** (k // 2), 2 ** (k - k // 2))
        assert len(plan.column) == k // 2 and len(plan.row) == k - k // 2
        # every stage touches each register once; twiddle indices stay
        # inside the shared N2/2-entry table
        for stages, length in ((plan.column, plan.n1), (plan.row, plan.n2)):
            for stage in stages:
                touched = sorted(i for top, bot, _ in stage
                                 for i in (top, bot))
                assert touched == list(range(length))
                assert all(w is None or 0 < w < plan.n2 // 2
                           for _, _, w in stage)
    assert [radix.bitrev(i, 3) for i in range(8)] == [0, 4, 2, 6, 1, 5, 3, 7]
    for bad in (0, 1, 29, 58, 87, 2 * 23 * 29):
        with pytest.raises(ValueError, match="prime factors are 2, 3, 5, "
                           "7, 11, 13, 17, 19 and 23"):
            radix.radix_plan(bad)


@pytest.mark.parametrize("n", [2 ** k for k in range(1, 13)])
@pytest.mark.parametrize("inverse", [False, True])
def test_radix_plan_matches_numpy(n, inverse):
    """The kernel's radix plan, tiles and index maps, run in torch
    (``radix.emulate``), against np.fft: contiguous lines with a ragged
    last tile, the twiddle and pack_parts epilogues, and strided blocks
    with a ragged last group of inner indices."""
    x = cplx((37, n), 300 + n, np.complex128)
    base = np.fft.ifft if inverse else np.fft.fft
    want = base(x, axis=-1)
    got = radix.emulate(_t(x), inverse=inverse).numpy()
    assert_scaled_close(got, want, 1e-12)
    tw = np.exp(-1j * np.pi * np.arange(n) / (2 * n))
    got = radix.emulate(_t(x), inverse=inverse, twiddle=_t(tw)).numpy()
    assert_scaled_close(got, tw * want, 1e-12)
    if n >= 4:
        got = radix.emulate(_t(x), inverse=inverse, pack_parts=4).numpy()
        assert_scaled_close(got, want.reshape(37, 4, n // 4)
                            .transpose(1, 0, 2), 1e-12)
    if tfm.strided_supported(n, torch.complex64, True):
        xs = cplx((2, n, 20), 400 + n)
        got = radix.emulate(_t(xs), inverse=inverse, twiddle=_t(tw),
                            strided=True).numpy()
        assert_scaled_close(got, tw[:, None] * base(xs, axis=1), 5e-6)


def _grid_layouts(x):
    """A contiguous grid and a permuted view of another contiguous block,
    as a previous stage may leave it."""
    return [x, x.permute(2, 0, 1).contiguous().permute(1, 2, 0)]


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("op", ["fft", "ifft", "twiddle"])
def test_strided_routing_matches_pallas(axis, op):
    """ops.fft1d/ifft1d (and the twiddle epilogue) on every axis of a
    small 3-D grid, in place in x's layout: no line copy, the output keeps
    x's strides, and the values match the JAX package's kernel."""
    x = cplx((4, 64, 32), 60 + axis)
    n = x.shape[axis]
    tw = np.exp(-1j * np.pi * np.arange(n) / (2 * n)).astype(np.complex64)
    kw, jkw = ({"twiddle": _t(tw)}, {"twiddle": jnp.asarray(tw)}) \
        if op == "twiddle" else ({}, {})
    fn, jfn = (ops.ifft1d, jops.ifft1d) if op == "ifft" else (ops.fft1d,
                                                             jops.fft1d)
    want = np.asarray(jfn(jnp.asarray(x), axis, **jkw))
    for xt in _grid_layouts(_t(x)):
        ops.copies["lines"] = 0
        got = fn(xt, axis, **kw)
        assert ops.copies["lines"] == 0
        assert got.stride() == xt.stride()
        assert_scaled_close(got.numpy(), want, 5e-6)


def test_strided_routing_masks_ragged_inner_and_copies_narrow_ones():
    # inner = 20: one full tile of 16 inner indices and a ragged one of 4
    x = cplx((3, 32, 20), 70)
    ops.copies["lines"] = 0
    got = ops.fft1d(_t(x), 1)
    assert ops.copies["lines"] == 0
    assert_scaled_close(got.numpy(), np.fft.fft(x, axis=1), 5e-6)
    # inner = 8 is narrower than a strided tile: the lines are copied
    x = cplx((3, 32, 8), 71)
    got = ops.fft1d(_t(x), 1)
    assert ops.copies["lines"] == 1
    assert_scaled_close(got.numpy(), np.fft.fft(x, axis=1), 5e-6)
    # a general-path N on a strided axis and a pack on one are copied too
    ops.fft1d(_t(cplx((3, 33, 16), 72)), 1)
    ops.packed_fft1d(_t(cplx((3, 32, 16), 73)), 1, 2)
    assert ops.copies["lines"] == 3


def test_dense_layout():
    x = torch.zeros((2, 3, 4, 5))
    assert ops.dense_layout(x, 1) == ([0, 1, 2, 3], 2, 20)
    y = x.permute(3, 1, 0, 2)
    perm, outer, inner = ops.dense_layout(y, 1)
    assert y.permute(perm).is_contiguous() and (outer, inner) == (2, 20)
    assert ops.dense_layout(x[:, :, :2], 1) is None     # not dense
    assert ops.dense_layout(torch.zeros(3, 1).expand(3, 4), 0) is None
    assert ops.dense_layout(x[:1], 3) == ([0, 1, 2, 3], 12, 1)


def test_strided_entry_and_its_plain_version():
    x = cplx((3, 64, 17), 80)
    tw = np.exp(-1j * np.pi * np.arange(64) / 128).astype(np.complex64)
    got = tfm.fft_fourstep_strided(_t(x), inverse=True, twiddle=_t(tw))
    assert got.shape == (3, 64, 17) and got.is_contiguous()
    assert_scaled_close(got.numpy(), tw[:, None] * np.fft.ifft(x, axis=1),
                        5e-6)
    with pytest.raises(ValueError, match=r"\(outer, N, inner\)"):
        tfm.fft_fourstep_strided(torch.zeros((4, 64), dtype=torch.complex64))
    with pytest.raises(ValueError, match="contiguous"):
        tfm.fft_fourstep_strided(
            torch.zeros((2, 16, 64), dtype=torch.complex64).transpose(1, 2))
    with pytest.raises(ValueError, match="no strided radix tile"):
        tfm.fft_fourstep_strided(torch.zeros((1, 33, 16),
                                             dtype=torch.complex64))


#: A stand-in ``nvcc``: a compile (``-c``) logs its start and end times and
#: its ``-DREPRO_PART`` and writes that into its object; the link (``-shared``)
#: writes the objects' contents into the library.
_FAKE_NVCC = """#!{python}
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open({log!r}, "a") as log:
    if "-c" in args:
        part = next(a for a in args if a.startswith("-DREPRO_PART="))
        log.write(f"start {{part}} {{time.time()}}\\n")
        log.flush()
        time.sleep(0.5)
        open(out, "w").write(part + "\\n")
        log.write(f"end {{part}} {{time.time()}}\\n")
        print(f"ptxas info    : compiled {{part}}")
        sys.exit(3 if part == {fail!r} else 0)
    log.write("link " + " ".join(args) + "\\n")
    objs = [a for a in args if a.endswith(".o")]
    open(out, "w").write("".join(open(o).read() for o in objs))
"""


def _fake_nvcc(tmp_path, monkeypatch, fail=""):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    log = tmp_path / "nvcc.log"
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, log=str(log),
                                      fail=fail))
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(home))
    return log


def test_build_compiles_the_parts_at_once_and_links_them(tmp_path,
                                                         monkeypatch):
    """The build runs one ``nvcc -c`` per translation unit (the entry
    points, REPRO_PART=-1, and each of the PARTS kernel parts), all
    started before any ends, with the flags that name the part count, then
    one link of every object into the library; the log holds each unit's
    output in order, and the objects are removed."""
    from repro_torch.kernels import build
    log = _fake_nvcc(tmp_path, monkeypatch)
    out = tmp_path / "lib.so"
    text = build._compile("fft_fourstep", out)
    parts = [f"-DREPRO_PART={k}" for k in range(-1, build.PARTS)]
    assert out.read_text().split() == parts
    assert [line.split()[-1] for line in text.splitlines()] == parts
    events = [line.split() for line in log.read_text().splitlines()]
    starts = [float(e[2]) for e in events if e[0] == "start"]
    ends = [float(e[2]) for e in events if e[0] == "end"]
    assert len(starts) == len(ends) == build.PARTS + 1
    assert max(starts) < min(ends)
    link = [e for e in events if e[0] == "link"]
    assert len(link) == 1 and "-shared" in link[0]
    assert f"-DREPRO_BUILD_PARTS={build.PARTS}" in build.NVCC_FLAGS
    assert not any(p.suffix == ".parts" for p in tmp_path.iterdir())


def test_build_raises_when_a_part_fails(tmp_path, monkeypatch):
    """A unit that fails to compile fails the build, named, with nvcc's
    output, and no library or object is left."""
    from repro_torch.kernels import build
    _fake_nvcc(tmp_path, monkeypatch, fail="-DREPRO_PART=3")
    out = tmp_path / "lib.so"
    with pytest.raises(RuntimeError, match=r"REPRO_PART \[3\]"):
        build._compile("fft_fourstep", out)
    assert not out.exists()
    assert not any(p.suffix == ".parts" for p in tmp_path.iterdir())


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """An edited header under csrc/ gives a new library name, so a stale
    build is never loaded; an unchanged tree keeps its name."""
    from repro_torch.kernels import build
    src = build.csrc_dir()
    names = [p.name for p in build.sources("fft_fourstep")]
    assert names == ["fft_fourstep.cu", "fft_common.cuh", "fft_long.cuh",
                     "fft_radix.cuh", "fft_dense.cuh", "fft_wide.cuh"]
    for name in names:
        (tmp_path / name).write_bytes((src / name).read_bytes())
    monkeypatch.setattr(build, "csrc_dir", lambda: tmp_path)
    first = build._target("fft_fourstep")
    assert build._target("fft_fourstep") == first
    common = tmp_path / "fft_common.cuh"
    common.write_bytes(common.read_bytes() + b"\n// edited\n")
    assert build._target("fft_fourstep") != first
