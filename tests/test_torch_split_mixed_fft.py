"""The split route at the mixed lengths r*2^k, r in
``radix.EVERY_ROUTE_ODD`` = {3, 5, 7, 9, 11, 13, 15, 17, 19, 21, 23, 25,
27}, past the long-line route's (``kernels/split.py``): N = P*Q with P a power of
two (pass A, the strided radix entry unchanged) and the odd part in Q (pass
B: the radix route's ``kRadixSplitB`` at a mixed Q, or the mixed long-line
kernel's body with the line's transposed store folded in through a
cluster, ``split_fold_mixed_kernel``, at a Q that is not a power of
two).  The route's plain version, ``split.emulate`` (the
wrapper runs it for CPU tensors), is held against ``np.fft`` and against
the JAX package's Pallas kernel in interpret mode on the same numpy
inputs (complex64 18432, 24576, 30720, 22528 = 11*2^11, 28672 = 7*2^12,
26624 = 13*2^11 and 53248 = 13*2^12 (pass B at Q = 208), and the odd
products 21504 = 21*2^10, 25600 = 25*2^10 and 27648 = 27*2^10, complex128
9216, 12288, 11264 = 11*2^10, 14336 = 7*2^11 and 13312 = 13*2^10, and
10752 = 21*2^9, 12800 = 25*2^9 and 13824 = 27*2^9;
both directions, the twiddle and ``pack_parts`` epilogues) at the
reference's tolerances (``tests/test_kernels.py:27``: 5e-6 max-scaled in
complex64, 1e-12 in complex128); then lengths whose rows take the
long-line route against ``np.fft``, the table's sizes, the inter-step
twiddle tables at a mixed Q, the transpose's index map, and ``fft_conv``
at S = 12288 (lines of 24576) against the reference's mixer.  The CUDA
kernels are tested in ``test_torch_cuda.py`` and ``chip_smoke.py``."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft_matmul as jfm
from repro_torch.kernels import fft_matmul as tfm
from repro_torch.kernels import longline, radix, split
from torch_harness import assert_scaled_close, pallas_lines_c128

TOL = {torch.complex64: 5e-6, torch.complex128: 1e-12}
NP = {torch.complex64: np.complex64, torch.complex128: np.complex128}
#: (batch, inverse, twiddle, pack_parts) per length: 1 or 2 lines, both
#: directions, each epilogue (segments of N/r, r the odd part's least
#: prime factor, and N/4).
VARIANTS = [(2, False, False, None), (1, True, True, None),
            (2, False, False, "odd"), (1, True, True, 4)]
LENGTHS = [(torch.complex64, 9 << 11), (torch.complex64, 3 << 13),
           (torch.complex64, 15 << 11), (torch.complex128, 9 << 10),
           (torch.complex128, 3 << 12), (torch.complex64, 11 << 11),
           (torch.complex64, 7 << 12), (torch.complex128, 11 << 10),
           (torch.complex128, 7 << 11), (torch.complex64, 13 << 11),
           (torch.complex64, 13 << 12), (torch.complex128, 13 << 10),
           (torch.complex64, 21 << 10), (torch.complex64, 25 << 10),
           (torch.complex64, 27 << 10), (torch.complex128, 21 << 9),
           (torch.complex128, 25 << 9), (torch.complex128, 27 << 9)]
CASES = [(dtype, n, b, inv, tw,
          next(r for r in (3, 5, 7, 11, 13, 17, 19, 23) if n % r == 0)
          if parts == "odd" else parts)
         for dtype, n in LENGTHS for b, inv, tw, parts in VARIANTS]
MIXED = [(dtype, n) for dtype, table in split.FACTORS.items()
         for n in sorted(table) if not radix.is_pow2(n)]


def _case_id(case):
    dtype, n, b, inv, tw, parts = case
    return (f"{str(dtype).removeprefix('torch.')}-{n}-b{b}-"
            f"{'inv' if inv else 'fwd'}-tw{int(tw)}-p{parts}")


def _inputs(case):
    """(x, twiddle or None) as numpy arrays of the case's dtype."""
    dtype, n, b, inv, tw, parts = case
    r = np.random.default_rng(n + 10 * b + int(inv))
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
    ``jax_enable_x64``, one fresh process for every case)."""
    cases = {}
    for case in CASES:
        if case[0] != torch.complex128:
            continue
        x, t = _inputs(case)
        cases[_case_id(case).replace("-", "_")] = (x, t, case[3], case[5])
    return pallas_lines_c128(cases,
                             str(tmp_path_factory.mktemp("split_mixed_x64")))


def _pallas_c64(case, x, t):
    dtype, n, b, inv, tw, parts = case
    twp = None if t is None else (jnp.asarray(t.real), jnp.asarray(t.imag))
    yr, yi = jfm.fft1d_planes(jnp.asarray(x.real), jnp.asarray(x.imag),
                              inverse=inv, twiddle=twp, pack_parts=parts)
    assert yr.dtype == jnp.float32
    return np.asarray(yr) + 1j * np.asarray(yi)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_split_mixed_plan_matches_numpy_and_pallas(case, request):
    """The route's plain version, through the wrapper on CPU tensors,
    against np.fft and the Pallas kernel on the same inputs; no launch or
    split call is counted on the CPU."""
    dtype, n, b, inv, tw, parts = case
    assert radix.kernel_path(n, dtype) == "split"
    assert split.split_plan(n, dtype).row_path == "radix"
    x, t = _inputs(case)
    tfm.reset_launch_counts()
    got = tfm.fft_fourstep(torch.from_numpy(x), inverse=inv,
                           twiddle=None if t is None else torch.from_numpy(t),
                           pack_parts=parts)
    counts = tfm.launch_counts()
    assert counts["launches"] == 0 and counts["split_calls"] == 0
    assert got.dtype == dtype
    want_shape = (b, n) if parts is None else (b, parts, n // parts)
    assert tuple(got.shape) == want_shape
    if parts is not None:       # destination-major (p, B, N/p) storage
        assert got.transpose(0, 1).is_contiguous()
    got = got.numpy()
    assert_scaled_close(got, _numpy_ref(case, x, t), TOL[dtype])
    if dtype == torch.complex64:
        pallas = _pallas_c64(case, x, t)
    else:
        pallas = request.getfixturevalue("pallas_c128")[
            _case_id(case).replace("-", "_")]
    assert pallas.dtype == NP[dtype]
    assert_scaled_close(got, pallas, TOL[dtype])


@pytest.mark.parametrize("dtype,n", [
    (torch.complex64, 9 << 18),         # 512 x 4608
    (torch.complex64, 5 << 19),         # 512 x 5120
    (torch.complex128, 3 << 18),        # 128 x 6144
    (torch.complex128, 9 << 16),        # 256 x 2304
    (torch.complex128, 7 << 16),        # 64 x 7168
    (torch.complex128, 11 << 16),       # 128 x 5632
    (torch.complex128, 13 << 16),       # 128 x 6656
    (torch.complex128, 21 << 14),       # 64 x 5376, an odd R1
    (torch.complex128, 27 << 15)])      # 256 x 3456
@pytest.mark.parametrize("inverse,use_tw,parts", [(False, False, None),
                                                  (True, True, 3)])
def test_split_mixed_long_rows_match_numpy(dtype, n, inverse, use_tw, parts):
    """Pass B on the mixed long-line kernel's body (``longline.emulate``
    unscaled) with its transposed store folded in (``split.fold_emulate``)
    at a Q that is not a power of two, one line, against np.fft with the
    epilogues."""
    plan = split.split_plan(n, dtype)
    assert plan.row_path == "long" and not radix.is_pow2(plan.q)
    if n % (parts or 1):
        parts = next(r for r in (5, 7, 11, 13) if n % r == 0)
    r = np.random.default_rng(n % 1000 + int(inverse))
    x = (r.standard_normal((1, n)) + 1j * r.standard_normal((1, n))
         ).astype(NP[dtype])
    t = np.exp(-1j * np.pi * np.arange(n) / (2 * n)).astype(NP[dtype]) \
        if use_tw else None
    got = split.emulate(torch.from_numpy(x), inverse=inverse,
                        twiddle=None if t is None else torch.from_numpy(t),
                        pack_parts=parts)
    want = (np.fft.ifft if inverse else np.fft.fft)(
        x.astype(np.complex128), axis=-1)
    if t is not None:
        want = want * t
    if parts is not None:
        want = want.reshape(1, parts, n // parts).transpose(1, 0, 2)
    assert got.dtype == dtype
    assert_scaled_close(got.numpy(), want, TOL[dtype])


@pytest.mark.parametrize("dtype,n", MIXED)
def test_split_mixed_plan_sizes_fit_the_tiles(dtype, n):
    """Every mixed length of the table: P a power of two on the strided
    radix tile (an instantiated pass A); Q = N/P carries the odd part, on
    the radix route's lines tile (whose L rows divide P; an instantiated
    pass B) or the long-line route (a multiple of 32, as the table
    has it); QL a power of two dividing Q; the twiddle tables far below
    N for the measured table's lengths.  The rule's Q (``split.
    rule_factors``) may hold a single factor of 2, so QL = 2 and TB holds
    P*Q/2 entries: at most P*(2 + Q/2), within 16 MB (1024 x 960 complex64
    entries at most, read through the 50 MB L2)."""
    plan = split.split_plan(n, dtype)
    assert plan.p * plan.q == n and plan.p in split.COLUMN_SIZES[dtype]
    assert tfm.strided_supported(plan.p, dtype, False)
    assert not radix.is_pow2(plan.q)
    ctile = split.column_tile(plan, dtype)
    assert ctile.smem_bytes <= radix.SMEM_MAX_BYTES
    rtile = split.row_tile(plan, dtype)
    assert rtile.smem_bytes <= radix.SMEM_MAX_BYTES
    if plan.row_path == "radix":
        # a codelet length; complex64 208 runs only as pass B (clean in
        # ptxas, where its plain kernel spills)
        assert plan.q in split.ROW_SIZES[dtype]
        assert plan.q in radix.RADIX_SIZES[dtype] or (
            dtype, plan.q) == (torch.complex64, 208)
        assert plan.p % rtile.lines == 0
    else:
        assert radix.kernel_path(plan.q, dtype) == "long"
        assert plan.q in longline.FACTORS[dtype] and plan.q % 32 == 0
    assert radix.is_pow2(plan.ql) and plan.q % plan.ql == 0
    assert plan.ql * plan.qh == plan.q
    if n in split._TABLE[dtype]:
        assert plan.const_elems <= 2 * plan.p * 2 * math.isqrt(plan.q)
    else:
        assert plan.const_elems <= plan.p * (2 + plan.q // 2)
        assert plan.const_elems * dtype.itemsize <= 16 << 20


def test_split_mixed_lengths_are_every_r_2k_past_the_long_route():
    """The route holds every mixed N = r*2^k past the long-line route's
    lengths up to the split route's limits (2^24 complex64, 2^22
    complex128; 23*2^k by the rule, the rest by the measured table), and
    the pass lengths it instantiates are its own."""
    for dtype, top in ((torch.complex64, 1 << 24),
                       (torch.complex128, 1 << 22)):
        long_max = max(n for n in longline.FACTORS[dtype]
                       if not radix.is_pow2(n))
        want = sorted(r << k for r in radix.EVERY_ROUTE_ODD
                      for k in range(1, 25)
                      if long_max < (r << k) <= top
                      and (r << k) not in longline.FACTORS[dtype])
        assert sorted(n for n in split.FACTORS[dtype]
                      if radix.odd_part(n) in radix.EVERY_ROUTE_ODD) == want
        assert all(split.FACTORS[dtype][n] == split.rule_factors(n, dtype)
                   for n in want if n not in split._TABLE[dtype])
        assert {radix.odd_part(n) for n in want
                if n not in split._TABLE[dtype]} == {23}
        table = split.FACTORS[dtype].values()
        assert set(split.ROW_SIZES[dtype]) == {
            q for _, q in table if q not in longline.FACTORS[dtype]}
    assert split.split_plan(24576, torch.complex64).q == 96
    assert split.split_plan(12288, torch.complex128).q == 192


#: The measured table's pass-B lengths on the radix kernel, per dtype, as
#: the long-line route's second mixed factor found them, with the 17*2^k
#: and 19*2^k rows since the radix-17 and radix-19 codelets.
ROW_SIZES = {
    torch.complex64: (44, 68, 72, 76, 80, 84, 96, 100, 104, 108, 112, 120,
                      128, 136, 144, 152, 160, 168, 176, 192, 200, 208, 216,
                      224, 240, 256, 272, 304, 336, 384, 400, 416, 432, 448,
                      480, 512, 544, 576, 608, 640, 672, 704, 800, 832, 864,
                      896, 960, 1024, 1088, 1152, 1216, 1280, 1344, 1408,
                      1536, 1600, 1664, 1728, 1792, 1920, 2048),
    torch.complex128: (136, 144, 152, 160, 168, 176, 192, 200, 208, 216, 224,
                       240, 256, 272, 304, 336, 400, 416, 432, 448, 480, 512,
                       544, 576, 608, 640, 672, 704, 768, 800, 832, 864, 896,
                       960, 1024)}


@pytest.mark.parametrize("dtype,long_rows,lengths", [
    (torch.complex64, 40, 130), (torch.complex128, 47, 117)])
def test_split_plans_keep_their_row_routes(dtype, long_rows, lengths):
    """The long-line route's rule lengths (R2 mixed) are no Q of the
    measured table: every plan of ``split._TABLE`` keeps its pass-B
    route, "long" exactly where Q is one of the long-line table's lengths
    (a power of two or one mixed factor: 40 of complex64's 130 lengths,
    47 of complex128's 117), and its radix rows keep their lengths
    (complex64 208 among them: a spill, so no radix-route length);
    ``ROW_SIZES``, which the dispatch test holds to the CUDA switch, is
    those rows and the split rule's radix rows (``split.rule_factors``),
    no other."""
    rule = set(longline.FACTORS[dtype]) - set(longline._TABLE[dtype])
    plans = [split.split_plan(n, dtype) for n in split._TABLE[dtype]]
    assert len(plans) == lengths
    for plan in plans:
        assert plan.q not in rule
        assert plan.row_path == ("long" if plan.q in longline._TABLE[dtype]
                                 else "radix"), plan
    assert sum(plan.row_path == "long" for plan in plans) == long_rows
    assert {plan.q for plan in plans
            if plan.row_path == "radix"} == set(ROW_SIZES[dtype])
    ruled = {split.split_plan(n, dtype) for n in split.FACTORS[dtype]
             if n not in split._TABLE[dtype]}
    assert split.ROW_SIZES[dtype] == tuple(sorted(
        set(ROW_SIZES[dtype])
        | {plan.q for plan in ruled if plan.row_path == "radix"}))


@pytest.mark.parametrize("inverse", [False, True])
def test_split_mixed_constants_are_the_inter_step_twiddle(inverse):
    """At a mixed Q (96 = 8 * 12: QL = 8, QH = 12) TA[kp, q % QL] *
    TB[kp, q // QL] is W_N^(kp*q) for every (kp, q)."""
    dtype = torch.complex64
    plan = split.split_plan(3 << 13, dtype)
    assert (plan.ql, plan.qh) == (8, 12)
    c = split.constants(plan, inverse)
    assert c.size == plan.const_elems
    ta = c[:plan.p * plan.ql].reshape(plan.p, plan.ql)
    tb = c[plan.p * plan.ql:].reshape(plan.p, plan.qh)
    q = np.arange(plan.q)
    full = ta[:, q % plan.ql] * tb[:, q // plan.ql]
    sign = 1.0 if inverse else -1.0
    kp = np.arange(plan.p)[:, None]
    np.testing.assert_allclose(
        full, np.exp(sign * 2j * np.pi * kp * q / plan.n), atol=1e-13)


def test_split_mixed_transpose_stores_each_row_at_kp_plus_p_kq():
    """Pass C's plain version at a mixed Q (``split.transpose_emulate``,
    which the plans whose rows keep pass C run): z[b, kp, kq] lands at
    out[b, kp + P*kq], times the twiddle and 1/N, in segments of N/parts
    (here N/3)."""
    dtype = torch.complex128
    plan = split.split_plan(3 << 18, dtype)          # 128 x 6144
    r = np.random.default_rng(9)
    z = torch.from_numpy(r.standard_normal((2, plan.p, plan.q))
                         + 1j * r.standard_normal((2, plan.p, plan.q)))
    tw = torch.from_numpy(np.exp(-1j * np.arange(plan.n) / plan.n))
    got = split.transpose_emulate(z, plan, inverse=True, twiddle=tw,
                                  pack_parts=3)
    want = (z.transpose(1, 2).reshape(2, plan.n) * tw / plan.n
            ).reshape(2, 3, plan.n // 3).transpose(0, 1)
    assert torch.allclose(got, want, rtol=0, atol=1e-15)


def test_wrapper_runs_the_mixed_split_emulation_on_cpu_tensors():
    """For a mixed split N the CPU wrapper's result is ``split.emulate``'s,
    bit for bit; the counters stay at 0."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 3 << 13)).astype(np.complex64))
    tfm.reset_launch_counts()
    assert torch.equal(tfm.fft_fourstep(x, inverse=True),
                       split.emulate(x, inverse=True))
    packed = tfm.fft_fourstep(x, pack_parts=3)
    assert torch.equal(packed.transpose(0, 1), split.emulate(x, pack_parts=3))
    counts = tfm.launch_counts()
    assert counts["split_calls"] == 0 and counts["launches"] == 0


def test_fft_conv_at_12288_takes_the_split_route_and_matches_reference():
    """``fft_conv`` at S=12288 (lines of 24576 = 256 x 96, the split route
    with a mixed Q) with 8 channels on the kernel backend's plain version
    against the reference's mixer, float32."""
    from lm_parity import F32_TOL, f32, jax_init, port_module, randn, \
        scaled_err, tt
    from repro.configs import smoke_config as ref_smoke_config
    from repro.distributed.sharding import MeshRules
    from repro.models import ssm as ref_ssm
    from repro_torch.models import ssm

    cfg = f32(dataclasses.replace(ref_smoke_config("jamba_v0_1_52b"),
                                  ssm_impl="fft_conv", d_model=4, expand=2))
    tree, ref_p = jax_init(ref_ssm.init_fft_conv, cfg, "ssm", seed=4)
    p = port_module(ssm.init_fft_conv, tree, "ssm", cfg)
    s = 12288
    assert radix.kernel_path(2 * s, torch.complex64) == "split"
    x = randn((1, s, cfg.d_model), 13)
    y_ref, _ = ref_ssm.fft_conv(ref_p, cfg, MeshRules(), jnp.asarray(x))
    tfm.reset_launch_counts()
    y, _ = ssm.fft_conv(p, cfg, None, tt(x), fft_backend="kernel")
    assert tfm.launch_counts()["split_calls"] == 0   # plain version on CPU
    assert scaled_err(y, y_ref) < F32_TOL
