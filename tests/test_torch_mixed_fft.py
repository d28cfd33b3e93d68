"""The radix route's mixed lengths (``kernels/radix.py``,
``csrc/fft_radix.cuh``): N = r*2^k, r in ``radix.RADIX_ODD`` (3, 5, 7, 9,
11, 13, 15, 17, 19, the odd products 21 to 63 and, where both factors fit a
codelet, the odd parts from 65), whose codelets are chains of radix-19, 17,
13, 11, 7, 5, 3, 4 and 2 butterflies on digit-reversed loads (radix 7 to 19
in the symmetric-pair form; ``test_torch_wide_fft.py`` holds 17*2^k and
19*2^k); one length per odd product and dtype, and c64 672, 1440 and 4032;
for the odd parts from 65 one length per family (75: c64 150 = 10 x 15 and
600 = 24 x 25, 125: 1000, 225: 1800, 3600 = 60 x 60 and c128 900 = 30 x 30,
169: c64 338 = 13 x 26, 65: c128 130) and c128 300.  The
kernel's plan and index maps, run in torch by ``radix.emulate``, are held
against ``np.fft`` and against the JAX package's Pallas kernel in interpret
mode on the same numpy inputs: both directions, the twiddle epilogue,
``pack_parts`` with a segment that is not a power of two (384 with p = 2
and p = 3), and the strided layout, at the reference's tolerances
(``tests/test_kernels.py:27``: 5e-6 max-scaled in complex64, 1e-12 in
complex128).  Then the chains and tables, the sizes the kernel
instantiates (against the CUDA dispatch's cases), the routes of the odd
products and the radix route's rule over every length to 4096 / 1024,
and a ``plan_fft`` C2C plan and a PPB Poisson solve at a mixed grid on
the kernel backend's plain version against the reference's.
The CUDA kernel is tested in ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.kernels import fft_matmul as jfm
from repro_torch.compat import make_mesh
from repro_torch.core import api
from repro_torch.core.transforms import factorize
from repro_torch.kernels import fft_matmul as tfm
from repro_torch.kernels import chirp, dense, longline, radix, split
from torch_harness import (assert_scaled_close, dense_keeps,
                           pallas_lines_c128)

TOL = {torch.complex64: 5e-6, torch.complex128: 1e-12}
NP = {torch.complex64: np.complex64, torch.complex128: np.complex128}
LENGTHS = [(torch.complex64, n) for n in (6, 12, 30, 36, 60, 96, 384, 1536,
                                          3840)] + \
          [(torch.complex128, n) for n in (6, 30, 96, 384, 960)] + \
          [(torch.complex64, n) for n in (14, 56, 448, 3584, 22, 352,
                                          2816)] + \
          [(torch.complex128, n) for n in (896, 704)] + \
          [(torch.complex64, n) for n in (26, 416, 3328)] + \
          [(torch.complex128, n) for n in (208, 832)] + \
          [(torch.complex64, n) for n in (672, 800, 864, 1056, 1120, 1248,
                                          1440, 1568, 3520, 4032)] + \
          [(torch.complex128, n) for n in (42, 800, 864, 528, 70, 624, 720,
                                           784, 110, 504)] + \
          [(torch.complex64, n) for n in (150, 600, 1000, 1800, 3600,
                                          338)] + \
          [(torch.complex128, n) for n in (130, 300, 900)]
#: (batch, inverse, twiddle, pack_parts): ragged batches, both directions,
#: each epilogue; pack_parts 3 where 3 divides N, else 2.
VARIANTS = [(37, False, False, None), (5, True, True, None),
            (3, False, False, "p"), (2, True, True, "p")]
CASES = [(dtype, n, b, inv, tw, (3 if n % 3 == 0 else 2) if p else None)
         for dtype, n in LENGTHS for b, inv, tw, p in VARIANTS]
CASES += [(torch.complex64, 384, 3, False, True, 2),
          (torch.complex64, 384, 3, True, False, 2)]


def _case_id(case):
    dtype, n, b, inv, tw, parts = case
    return (f"{str(dtype).removeprefix('torch.')}-{n}-b{b}-"
            f"{'inv' if inv else 'fwd'}-tw{int(tw)}-p{parts}")


def _inputs(case):
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
                             str(tmp_path_factory.mktemp("mixed_x64")))


def _pallas_c64(case, x, t):
    dtype, n, b, inv, tw, parts = case
    twp = None if t is None else (jnp.asarray(t.real), jnp.asarray(t.imag))
    yr, yi = jfm.fft1d_planes(jnp.asarray(x.real), jnp.asarray(x.imag),
                              inverse=inv, twiddle=twp, pack_parts=parts)
    assert yr.dtype == jnp.float32
    return np.asarray(yr) + 1j * np.asarray(yi)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_mixed_radix_plan_matches_numpy_and_pallas(case, request):
    """``radix.emulate`` (the kernel's loops and index maps: the mixed
    codelets, their own tables, the row split by a division, the
    ``pack_parts`` segment of any length) against np.fft and the Pallas
    kernel on the same inputs; the buffer it returns is what the kernel
    writes, ``(p, B, N/p)`` with ``pack_parts``."""
    dtype, n, b, inv, tw, parts = case
    # the radix kernel's length (its strided layout and split rows); the
    # wide lines' contiguous lines take the long route's wide kernel
    assert n in radix.RADIX_SIZES[dtype]
    assert radix.kernel_path(n, dtype) == (
        "long" if n in longline.WIDE[dtype] else "radix")
    x, t = _inputs(case)
    got = radix.emulate(torch.from_numpy(x), inverse=inv,
                        twiddle=None if t is None else torch.from_numpy(t),
                        pack_parts=parts)
    assert got.dtype == dtype
    if parts is not None:
        assert tuple(got.shape) == (parts, b, n // parts)
        got = got.transpose(0, 1)
    got = got.numpy()
    assert_scaled_close(got, _numpy_ref(case, x, t), TOL[dtype])
    if dtype == torch.complex64:
        pallas = _pallas_c64(case, x, t)
    else:
        pallas = request.getfixturevalue("pallas_c128")[
            _case_id(case).replace("-", "_")]
    assert pallas.dtype == NP[dtype]
    assert_scaled_close(got, pallas, TOL[dtype])


@pytest.mark.parametrize("dtype,n", [(torch.complex64, 24),
                                     (torch.complex64, 384),
                                     (torch.complex64, 1280),
                                     (torch.complex128, 240),
                                     (torch.complex128, 480),
                                     (torch.complex64, 56),
                                     (torch.complex64, 448),
                                     (torch.complex64, 1408),
                                     (torch.complex128, 44),
                                     (torch.complex128, 704),
                                     (torch.complex64, 416),
                                     (torch.complex128, 208),
                                     (torch.complex64, 360),
                                     (torch.complex64, 1440),
                                     (torch.complex128, 360),
                                     (torch.complex64, 150),
                                     (torch.complex64, 600),
                                     (torch.complex64, 338),
                                     (torch.complex128, 300)])
@pytest.mark.parametrize("inverse", [False, True])
def test_mixed_strided_layout_matches_numpy(dtype, n, inverse):
    """The strided ``(outer, N, inner)`` layout at mixed lengths, a
    ragged last group of inner indices, with the twiddle, through
    ``radix.emulate`` and through the strided entry's plain version."""
    assert tfm.strided_supported(n, dtype, True)
    r = np.random.default_rng(n + int(inverse))
    x = (r.standard_normal((2, n, 21)) + 1j * r.standard_normal(
        (2, n, 21))).astype(NP[dtype])
    t = np.exp(-1j * np.pi * np.arange(n) / (2 * n)).astype(NP[dtype])
    want = t[:, None] * (np.fft.ifft if inverse else np.fft.fft)(
        x.astype(np.complex128), axis=1)
    got = radix.emulate(torch.from_numpy(x), inverse=inverse,
                        twiddle=torch.from_numpy(t), strided=True)
    assert_scaled_close(got.numpy(), want, TOL[dtype])
    got = tfm.fft_fourstep_strided(torch.from_numpy(x), inverse=inverse,
                                   twiddle=torch.from_numpy(t))
    assert_scaled_close(got.numpy(), want, TOL[dtype])


@pytest.mark.parametrize("length,chain", [
    (3, (3,)), (5, (5,)), (6, (3, 2)), (9, (3, 3)), (12, (3, 4)),
    (15, (5, 3)), (24, (3, 4, 2)), (40, (5, 4, 2)), (48, (3, 4, 4)),
    (60, (5, 3, 4)), (16, (2, 2, 2, 2)), (7, (7,)), (11, (11,)),
    (14, (7, 2)), (28, (7, 4)), (56, (7, 4, 2)), (22, (11, 2)),
    (44, (11, 4)), (77, (11, 7)), (13, (13,)), (26, (13, 2)),
    (52, (13, 4)), (104, (13, 4, 2)), (143, (13, 11)), (21, (7, 3)),
    (25, (5, 5)), (27, (3, 3, 3)), (33, (11, 3)), (35, (7, 5)),
    (39, (13, 3)), (45, (5, 3, 3)), (49, (7, 7)), (55, (11, 5)),
    (63, (7, 3, 3)), (42, (7, 3, 2)), (54, (3, 3, 3, 2)), (17, (17,)),
    (19, (19,)), (34, (17, 2)), (38, (19, 2)), (68, (17, 4)),
    (76, (19, 4)), (136, (17, 4, 2)), (323, (19, 17))])
def test_mixed_codelet_chain_and_loads(length, chain):
    """The radix chain (the 19s, the 17s, the 13s, the 11s, the 7s, the 5s,
    the 3s, then 4s and a last 2; 2s for a power of two), the load order (a
    permutation; bit reversal for a power of two), and every stage touching
    each register once with its twiddle inside the codelet's own table of
    ``length`` entries."""
    assert radix.radices(length) == chain
    slots = [radix.load_slot(i, length) for i in range(length)]
    assert sorted(slots) == list(range(length))
    if radix.is_pow2(length):
        bits = length.bit_length() - 1
        assert slots == [radix.bitrev(i, bits) for i in range(length)]
        return
    stages = radix.mixed_codelet(length)
    assert [len(s[0][0]) for s in stages] == list(chain)
    for stage in stages:
        touched = sorted(i for regs, _ in stage for i in regs)
        assert touched == list(range(length))
        assert all(e is None or 0 < e < length
                   for _, tws in stage for e in tws)
    # one codelet on a unit impulse at each input is that input's DFT row
    # (the row's phases reduced mod the length first: np.exp of 2*pi*i*k/L
    # unreduced loses about L ulps of the phase)
    for i in range(length):
        v = [torch.zeros((), dtype=torch.complex128)] * length
        v[slots[i]] = torch.ones((), dtype=torch.complex128)
        w = torch.from_numpy(np.exp(-2j * np.pi * np.arange(length)
                                    / length))
        out = radix.run_codelet(v, length, stages, w, -1.0)
        want = np.exp(-2j * np.pi * (i * np.arange(length) % length)
                      / length)
        assert_scaled_close(np.array([complex(o) for o in out]), want,
                            1e-13)


@pytest.mark.parametrize("n,factors,chains", [
    (416, (16, 26), ((2, 2, 2, 2), (13, 2))),
    (3328, (52, 64), ((13, 4), (2,) * 6))])
def test_mixed_13_codelets_of_416_and_3328(n, factors, chains):
    """416 = 16 x 26 puts a radix-13 and a radix-2 stage in one codelet
    beside a power-of-two codelet; 3328 = 52 x 64 a radix-13 and a
    radix-4 stage beside the radix-2 codelet of 64: the plan's codelets
    follow the chain, each on its own table (N2 then N1 entries), and
    both codelets' loads are permutations."""
    plan = radix.radix_plan(n)
    assert (plan.n1, plan.n2) == factors == factorize(n)
    assert tuple(radix.radices(f) for f in factors) == chains
    assert radix.table_elems(n) == sum(factors)
    for f in factors:
        assert sorted(radix.load_slot(i, f) for i in range(f)) \
            == list(range(f))
    for dtype in (torch.complex64, torch.complex128):
        want = "radix" if max(factors) <= (64 if dtype == torch.complex64
                                           else 32) else "long"
        if n in longline.WIDE[dtype]:        # the wide kernel's line
            want = "long"
        assert radix.kernel_path(n, dtype) == want


def test_mixed_sizes_tables_and_tiles():
    """320 mixed complex64 lengths to 3780 and 155 complex128 to 960 (178
    and 54 of them with an odd part from 65, 14 and 10 of them 17*2^k and
    19*2^k, 7 and 5 of them 23*2^k; complex128 22 and complex64 208 and
    504 spill in ptxas and run dense), every codelet at most 64
    (complex64) or 32 (complex128) long, every odd part among the radix
    route's (``radix.RADIX_ODD``); each codelet
    has its own table (N2 + N1 entries); the tile's lines are a power of
    two; the split route's P stays a power of two (its pass A), and its Q
    is a power of two or a mixed length of the long-line route or of the
    codelets (its pass B: complex64 208 runs there, clean in ptxas), whose
    odd part the radix route takes (the split rule's rows:
    ``split.rule_factors``)."""
    for dtype, count, cap in ((torch.complex64, 320, 64),
                              (torch.complex128, 155, 32)):
        mixed = [n for n in radix.RADIX_SIZES[dtype]
                 if not radix.is_pow2(n)]
        assert len(mixed) == count
        for n in mixed:
            n1, n2 = factorize(n)
            assert max(n1, n2) <= cap and n1 * n2 == n
            odd = n
            while odd % 2 == 0:
                odd //= 2
            assert odd in radix.RADIX_ODD[dtype]
            assert radix.table_elems(n) == n1 + n2
            assert radix.codelet_table(n, False).shape == (n1 + n2,)
            tile = radix.radix_tile(n, dtype.itemsize, True, False)
            assert tile.lines & (tile.lines - 1) == 0
            assert tile.lines * n1 <= radix.THREADS
    caps = {torch.complex64: 64, torch.complex128: 32}
    for dtype, table in split.FACTORS.items():
        for n, (p, q) in table.items():
            assert radix.is_pow2(p)
            assert radix.is_pow2(q) == radix.is_pow2(n)
            assert (q in split.ROW_SIZES[dtype]) != (
                q in longline.FACTORS[dtype])
        for n in split.COLUMN_SIZES[dtype]:
            assert radix.is_pow2(n)
        for n in split.ROW_SIZES[dtype]:
            odd = n >> ((n & -n).bit_length() - 1)
            assert odd == 1 or odd in radix.RADIX_ODD[dtype]
            assert max(factorize(n)) <= caps[dtype]
            assert n in radix.RADIX_SIZES[dtype] or (dtype, n) == (
                torch.complex64, 208)
    # 384 = 16 * 24: N1 does not divide N2, so the tables are separate
    w = radix.codelet_table(384, True)
    assert_scaled_close(w[:24], np.exp(2j * np.pi * np.arange(24) / 24),
                        1e-15)
    assert_scaled_close(w[24:], np.exp(2j * np.pi * np.arange(16) / 16),
                        1e-15)
    assert radix.radix_tile(384, 8, False, False).lines == 16
    assert radix.radix_tile(1536, 8, False, False).lines == 8


@pytest.mark.parametrize("n,factors,chains", [
    (672, (24, 28), ((3, 4, 2), (7, 4))),
    (1440, (36, 40), ((3, 3, 4), (5, 4, 2))),
    (4032, (63, 64), ((7, 3, 3), (2,) * 6)),
    (800, (25, 32), ((5, 5), (2,) * 5)),
    (1568, (32, 49), ((2,) * 5, (7, 7)))])
def test_odd_product_codelets(n, factors, chains):
    """The odd products need no new butterfly: 672 = 24 x 28 and 1440 = 36
    x 40 mix both codelets, 4032 = 63 x 64 and 800 = 25 x 32 put an odd
    codelet (no 4s or 2s) beside a power of two's, 1568 = 32 x 49 the
    other way round; each on its own table, on the radix route in
    complex64, and in complex128 where both codelets are at most 32."""
    plan = radix.radix_plan(n)
    assert (plan.n1, plan.n2) == factors == factorize(n)
    assert tuple(radix.radices(f) for f in factors) == chains
    assert radix.table_elems(n) == sum(factors)
    for dtype in (torch.complex64, torch.complex128):
        if n in radix.RADIX_SIZES[dtype]:
            assert radix.kernel_path(n, dtype) == (
                "long" if n in longline.WIDE[dtype] else "radix")
    assert n in radix.RADIX_SIZES[torch.complex64]
    assert (n in radix.RADIX_SIZES[torch.complex128]) == (max(factors) <= 32)


def _dispatch_cases():
    """The CUDA dispatch's instantiations: {(mode, dtype): {N: (N1, N2)}}
    from ``radix_part``'s switch cases ("plain", "A", "B": the split
    passes), and {dtype: {N: (R1, R2, R3)}} from ``long_part``'s."""
    csrc = Path(radix.__file__).resolve().parent.parent / "csrc"
    both = (torch.complex64, torch.complex128)
    text = (csrc / "fft_radix.cuh").read_text()
    body = text[text.index("int radix_part("):]
    cases, mode, dts = {}, None, both
    for line in body.splitlines():
        if "MODE == kRadixPlain" in line:
            mode, dts = "plain", both
        elif "MODE == kRadixSplitA" in line:
            mode, dts = "A", both
        elif line.startswith("  } else {"):
            mode, dts = "B", both
        elif line.startswith("    if constexpr (c64)"):
            dts = (torch.complex64,)
        elif line.startswith("    } else {"):
            dts = (torch.complex128,)
        elif line.startswith("    }"):
            dts = both
        m = re.search(r"REPRO_RADIX_CASE\((\d+), (\d+), (\d+)\)", line)
        if m:
            n, n1, n2 = map(int, m.groups())
            for dtype in dts:
                table = cases.setdefault((mode, dtype), {})
                assert n not in table, (mode, dtype, n)
                table[n] = (n1, n2)
    text = (csrc / "fft_long.cuh").read_text()
    body = text[text.index("int long_part("):]
    long_cases, dtype = {}, torch.complex64
    for line in body.splitlines():
        if line.startswith("  } else {"):
            dtype = torch.complex128
        m = re.search(r"REPRO_LONG(?:_MIXED)?_CASE\((\d+), (\d+), (\d+), "
                      r"(\d+)\)", line)
        if m:
            n, *factors = map(int, m.groups())
            long_cases.setdefault(dtype, {})[n] = tuple(factors)
    return cases, long_cases


def test_cuda_dispatch_instantiates_the_python_tables():
    """The CUDA source instantiates exactly the lengths the Python tables
    route there, with ``factorize``'s factors: ``radix.RADIX_SIZES`` on
    the plain radix kernel, ``split.COLUMN_SIZES`` and ``ROW_SIZES`` on
    its split passes, ``longline.FACTORS`` on the long-line kernels (the
    odd R1 = 17, 19, 21, 23, 25 and 27 too), per dtype; no length is left
    without an instantiation or instantiated in vain."""
    cases, long_cases = _dispatch_cases()
    for dtype in (torch.complex64, torch.complex128):
        for mode, sizes in (("plain", radix.RADIX_SIZES[dtype]),
                            ("A", split.COLUMN_SIZES[dtype]),
                            ("B", split.ROW_SIZES[dtype])):
            table = cases[mode, dtype]
            assert set(table) == set(sizes), (mode, dtype)
            for n, (n1, n2) in table.items():
                assert (n1, n2) == factorize(n) or (n, n1) == (2, 1)
        assert long_cases[dtype] == longline.FACTORS[dtype]
    assert cases["plain", torch.complex64][4032] == (63, 64)
    assert long_cases[torch.complex64][10752] == (21, 16, 32)
    assert cases["plain", torch.complex64][2432] == (38, 64)
    assert cases["plain", torch.complex128][544] == (17, 32)
    assert cases["B", torch.complex64][1216] == (32, 38)
    assert long_cases[torch.complex64][9728] == (19, 16, 32)
    assert long_cases[torch.complex128][4864] == (19, 16, 16)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("r", [33, 35, 39, 45, 49, 55, 63, 75])
def test_odd_parts_past_the_codelets_run_dense_then_chirp(dtype, r):
    """r = 33 to 63 and 75 take the radix route within one codelet pair
    (75*2^k as 10 x 15 up to 2400 = 48 x 50 in complex64, 600 = 24 x 25 in
    complex128), the long-line route past it up to a 128 KB line (R1 and
    R2 both mixed: ``longline.rule_factors``): their longer r*2^k run the
    dense route while the line fits one block (``dense.fits``: 33*2^9 =
    16896 in complex64), then the split route where its rule finds a P
    and a Q (``split.rule_factors``: 33*2^10 = 256 x 132), else its
    general plans (``split.general_factors``) up to its limit, 2^24 /
    2^22, and past it its nested plans (``split.nested_factors``), which
    raised on the card before."""
    cap = radix.CODELET_MAX[dtype]
    on_radix = []
    for k in range(1, 24):
        n = r << k
        path = radix.kernel_path(n, dtype)
        if n in radix.RADIX_SIZES[dtype]:
            assert r in radix.RADIX_ODD[dtype] and path == (
                "long" if n in longline.WIDE[dtype] else "radix")
            on_radix.append(n)
            continue
        if n in radix._SPILLS[dtype]:               # complex64 504: dense
            assert path == "dense" and n not in longline.FACTORS[dtype]
            continue
        if n * dtype.itemsize <= 128 << 10:
            assert path == "long", (n, path)
            assert longline.FACTORS[dtype][n] == longline.rule_factors(
                n, dtype)
            continue
        assert n not in longline.FACTORS[dtype]
        if n <= dense.DENSE_LIMIT[dtype] or dense.fits(n, dtype):
            assert path == "dense" and n not in split.FACTORS[dtype]
        elif n <= split.LIMIT[dtype] and split.rule_factors(n, dtype):
            assert path == "split", (n, path)
            assert split.FACTORS[dtype][n] == split.rule_factors(n, dtype)
        elif n <= split.LIMIT[dtype]:
            assert path == "split" and split.general_factors(n, dtype), (
                n, path)
        else:
            assert path == "split" and split.nested_factors(n, dtype), (
                n, path)
    assert on_radix == [r << k for k in range(1, 24)
                        if max(factorize(r << k)) <= cap
                        and (r << k) not in radix._SPILLS[dtype]]
    if r == 75:
        assert on_radix == ([150, 300, 600, 1200, 2400]
                            if dtype == torch.complex64 else [150, 300, 600])
    assert r in radix.RADIX_ODD[dtype]
    assert r not in radix.EVERY_ROUTE_ODD


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_even_smooth_lengths_take_the_radix_route_when_both_factors_fit(
        dtype):
    """Every even 13-smooth N, 17*2^k and 19*2^k to 4096 (complex64) / 1024
    (complex128) is on the radix route exactly when both factors fit a
    codelet and N is not one of the spills; otherwise on the long-line route
    where three codelets of at most 32 take it (``longline.rule_factors``:
    complex64 3168 to 4096, complex128 792 to 1024) and N is not a spill,
    and on the dense kernel else; the radix lengths are those and nothing
    else, their odd parts ``RADIX_ODD``."""
    cap = radix.CODELET_MAX[dtype]
    want = []
    for n in range(2, cap * cap + 1, 2):
        if not radix.codelet_length(n):
            continue
        path = radix.kernel_path(n, dtype)
        if max(factorize(n)) <= cap and n not in radix._SPILLS[dtype]:
            assert path == ("long" if n in longline.WIDE[dtype]
                            else "radix"), (n, path)
            want.append(n)
        elif longline.rule_factors(n, dtype) is not None \
                and n not in radix._SPILLS[dtype]:
            assert path == "long", (n, path)
            assert n >= (3168 if dtype == torch.complex64 else 792)
        else:
            assert path == "dense", (n, path)
    assert tuple(want) == radix.RADIX_SIZES[dtype]
    odd = {radix.odd_part(n) for n in want} - {1}
    assert odd == radix.RADIX_ODD[dtype]
    assert max(odd) == (1701 if dtype == torch.complex64 else 405)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_odd_and_rough_lengths_stay_dense(dtype):
    """Odd N (75, 225, 1575, ...) and even N with a prime factor past 13
    that no codelet takes (816 = 17*48) stay on the dense kernel within
    the radix route's range while their generic stages cost no more than
    the chirp route (``dense.GENERIC_COST``), and take the chirp route
    past it (the primes 521 and 1021); 17*2^k and 19*2^k take the radix route (544 = 17 x
    32)."""
    cap = radix.CODELET_MAX[dtype]
    cost = dense.GENERIC_COST[dtype]
    for n in range(3, cap * cap + 1):
        if n % 2 == 0 and radix.codelet_length(n):
            continue
        want = ("dense" if dense_keeps(n, cost, dense.MOVE_MARGIN,
                                          longline.FOLD_SIZES[dtype], dtype.itemsize)
                else "chirp")
        assert radix.kernel_path(n, dtype) == want, n
    assert radix.kernel_path(544, dtype) == (
        "long" if 544 in longline.WIDE[dtype] else "radix")
    assert radix.kernel_path(816, dtype) == "dense"
    assert radix.kernel_path(521, dtype) == "chirp"
    assert radix.kernel_path(1021, dtype) == "chirp"


@pytest.fixture
def mesh():
    return make_mesh((1, 1), ("data", "model"), device="cpu")


@pytest.mark.parametrize("grid", [(24, 48, 96), (30, 12, 40),
                                  (130, 150, 162)])
def test_plan_at_a_mixed_grid_matches_reference(cpu_mesh, mesh, grid):
    """``plan_fft`` C2C at a grid of mixed lengths on the kernel backend
    (every axis on the radix route; here its plain version; odd parts 65,
    75 and 81 in the last) against the reference's plan on its Pallas
    backend, and the round trip."""
    for n in grid:
        assert radix.kernel_path(n, torch.complex64) == "radix"
    r = np.random.default_rng(sum(grid))
    x = (r.standard_normal(grid) + 1j * r.standard_normal(grid)
         ).astype(np.complex64)
    plan = api.plan_fft(mesh, grid, backend="kernel")
    got = plan.forward(torch.from_numpy(x))
    want = japi.plan_fft(cpu_mesh, grid, backend="pallas").forward(
        jnp.asarray(x))
    assert_scaled_close(got.numpy(), np.asarray(want), 2e-4)
    assert_scaled_close(got.numpy(), np.fft.fftn(x), 2e-4)
    back = plan.inverse(got, sharded_in=True)
    assert_scaled_close(back.numpy(), x, 1e-4)


@pytest.mark.parametrize("grid", [(24, 48, 96), (30, 12, 40)])
def test_ppb_solve_at_a_mixed_grid_matches_reference(cpu_mesh, mesh, grid):
    """The (periodic, periodic, bounded) Poisson solve at a mixed grid on
    the kernel backend (its DCT lines of N on the radix route) against
    the reference's solve on its Pallas backend."""
    topo = ("periodic", "periodic", "bounded")
    rhs = np.random.default_rng(len(grid) + grid[0]).standard_normal(
        grid).astype(np.float32)
    rhs -= rhs.mean()
    got = api.poisson_solve(torch.from_numpy(rhs), mesh=mesh, topology=topo,
                            backend="kernel")
    ref = japi.poisson_solve(jnp.asarray(rhs), mesh=cpu_mesh, topology=topo,
                             backend="pallas")
    assert got.dtype == torch.float32
    assert_scaled_close(got.numpy(), np.real(np.asarray(ref)), 2e-4)
