"""The radix-17, radix-19 and radix-23 codelets and the lengths they take
off the dense and chirp routes (``kernels/radix.py``,
``csrc/fft_radix.cuh``'s ``dft_odd``): N = 17*2^k, 19*2^k and 23*2^k on
the radix route (complex64 34 to 2176 = 34 x 64, 38 to 2432 = 38 x 64
and 46 to 2944 = 46 x 64, complex128 34 to 544 = 17 x 32, 38 to 608 = 19
x 32 and 46 to 736 = 23 x 32), on the long-line route with an odd R1 to
a 128 KB line (complex64 4352 to 11776, complex128 1088 to 5888) and on
the split route past it (complex64 17*2^10 to 23*2^19, complex128 17*2^9
to 23*2^17; 23*2^k by the split route's rule, ``split.rule_factors``);
and the dense route's ``GENERIC_COST``, past which an N up to
``DENSE_LIMIT`` whose generic stages cost more than the chirp goes to the
chirp route (whose M may then take the radix route).  One length per route, odd part and dtype,
and a chirp length each dtype that left the dense route, through the
routes' plain versions (``radix.emulate``, ``longline.emulate``,
``split.emulate``, ``chirp.emulate``) on the same numpy inputs against
``np.fft`` and the JAX package's Pallas kernel in interpret mode (complex128
in one x64 subprocess): both directions, the twiddle and ``pack_parts``
epilogues and the strided layout, at the reference's tolerances
(``tests/test_kernels.py:27``: 5e-6 max-scaled in complex64, 1e-12 in
complex128).  Then the butterflies' literals against numpy and the CUDA
source, the chains, and the routing of every 17*2^k and 19*2^k and of
every N up to ``DENSE_LIMIT``.  The CUDA kernels are tested in
``test_torch_cuda.py`` and ``chip_smoke.py``."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft_matmul as jfm
from repro_torch.core.transforms import factorize
from repro_torch.kernels import fft_matmul as tfm
from repro_torch.kernels import chirp, dense, longline, ops, radix, split
from torch_harness import (assert_scaled_close, dense_keeps,
                           pallas_lines_c128)

TOL = {torch.complex64: 5e-6, torch.complex128: 1e-12}
NP = {torch.complex64: np.complex64, torch.complex128: np.complex128}
c64, c128 = torch.complex64, torch.complex128
#: (dtype, N, route): the radix route's longest of each odd part and dtype
#: and the 17-codelet beside a power of two (544 = 17 x 32), the long-line
#: route's 19*2^k and 23*2^k that the chirp held (complex64 4864 = 19 x 16
#: x 16 and 5888 = 23 x 16 x 16, complex128 2432 = 19 x 8 x 16 and 2944 =
#: 23 x 8 x 16), the split route's shortest (complex64 17*2^10 = 256 x 68
#: and 23*2^10 = 256 x 92, complex128 19*2^9 = 64 x 152), and primes that
#: left the dense route for the chirp, M on the radix route (complex64
#: 521: M = 2048, complex128 101: M = 256).
LENGTHS = [(c64, 2432, "radix"), (c64, 544, "radix"), (c128, 608, "radix"),
           (c128, 544, "radix"), (c64, 4864, "long"), (c128, 2432, "long"),
           (c64, 17 << 10, "split"), (c128, 19 << 9, "split"),
           (c64, 521, "chirp"), (c128, 101, "chirp"),
           (c64, 2944, "radix"), (c128, 736, "radix"), (c64, 5888, "long"),
           (c128, 2944, "long"), (c64, 23 << 10, "split")]
#: (batch, inverse, twiddle, pack_parts): both directions, each epilogue;
#: segments of N/17, N/19 or N/23 (the odd part), and N/2.
VARIANTS = [(3, False, False, None), (2, True, True, None),
            (2, False, True, "odd"), (1, True, False, 2)]
CASES = [(dtype, n, route, b, inv, tw,
          (radix.odd_part(n) if parts == "odd" else parts)
          if n % 2 == 0 else None)
         for dtype, n, route in LENGTHS for b, inv, tw, parts in VARIANTS]
#: The Pallas kernel's dense matrices at the split length grow with N:
#: one line a case there.
SPLIT_BATCH = 1


def _case_id(case):
    dtype, n, route, b, inv, tw, parts = case
    return (f"{str(dtype).removeprefix('torch.')}-{n}-{route}-b{b}-"
            f"{'inv' if inv else 'fwd'}-tw{int(tw)}-p{parts}")


def _inputs(case):
    dtype, n, route, b, inv, tw, parts = case
    if route == "split":
        b = SPLIT_BATCH
    r = np.random.default_rng(n + 10 * b + int(inv) + 100 * int(tw))
    x = (r.standard_normal((b, n)) + 1j * r.standard_normal((b, n))
         ).astype(NP[dtype])
    t = np.exp(-1j * np.pi * np.arange(n) / (2 * n)).astype(NP[dtype]) \
        if tw else None
    return x, t


def _numpy_ref(case, x, t):
    dtype, n, route, b, inv, tw, parts = case
    y = (np.fft.ifft if inv else np.fft.fft)(x.astype(np.complex128),
                                             axis=-1)
    if t is not None:
        y = t * y
    return y if parts is None else y.reshape(len(x), parts, n // parts)


def _route(case, x, t):
    """The route's plain version: the radix kernel's index maps
    (``radix.emulate``: its buffer is what the kernel writes), else the
    wrapper on CPU tensors, which runs the long-line, split or chirp
    route's own (``fft_fourstep_plain``)."""
    dtype, n, route, b, inv, tw, parts = case
    xt = torch.from_numpy(x)
    tt = None if t is None else torch.from_numpy(t)
    if route == "radix":
        got = radix.emulate(xt, inverse=inv, twiddle=tt, pack_parts=parts)
        return got if parts is None else got.transpose(0, 1)
    return tfm.fft_fourstep(xt, inverse=inv, twiddle=tt, pack_parts=parts)


@pytest.fixture(scope="module")
def pallas_c128(tmp_path_factory):
    """The Pallas kernel's complex128 results (interpret mode under
    ``jax_enable_x64``, every case in one fresh process)."""
    cases = {}
    for case in CASES:
        if case[0] != c128:
            continue
        x, t = _inputs(case)
        cases[_case_id(case).replace("-", "_")] = (x, t, case[4], case[6])
    return pallas_lines_c128(cases, str(tmp_path_factory.mktemp("wide_x64")))


def _pallas_c64(case, x, t):
    dtype, n, route, b, inv, tw, parts = case
    twp = None if t is None else (jnp.asarray(t.real), jnp.asarray(t.imag))
    yr, yi = jfm.fft1d_planes(jnp.asarray(x.real), jnp.asarray(x.imag),
                              inverse=inv, twiddle=twp, pack_parts=parts)
    assert yr.dtype == jnp.float32
    return np.asarray(yr) + 1j * np.asarray(yi)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_wide_lengths_match_numpy_and_pallas(case, request):
    """Each length on its route (``radix.kernel_path``), through that
    route's plain version, against np.fft and the Pallas kernel on the
    same inputs; no launch is counted on the CPU, and only the chirp
    route packs with a line copy."""
    dtype, n, route, b, inv, tw, parts = case
    # a wide line (``longline.WIDE``) of the radix kernel's table takes the
    # long route's wide kernel on contiguous lines; ``_route`` runs the
    # radix kernel's plain version, which its strided layout keeps
    assert radix.kernel_path(n, dtype) == (
        "long" if n in longline.WIDE[dtype] else route)
    x, t = _inputs(case)
    tfm.reset_launch_counts()
    ops.copies["lines"] = 0
    got = _route(case, x, t)
    assert tfm.launch_counts()["launches"] == 0
    assert ops.copies["lines"] == (route == "chirp" and parts is not None)
    assert got.dtype == dtype
    want_shape = (len(x), n) if parts is None else (len(x), parts,
                                                     n // parts)
    assert tuple(got.shape) == want_shape
    got = got.numpy()
    assert_scaled_close(got, _numpy_ref(case, x, t), TOL[dtype])
    if dtype == c64:
        pallas = _pallas_c64(case, x, t)
    else:
        pallas = request.getfixturevalue("pallas_c128")[
            _case_id(case).replace("-", "_")]
    assert pallas.dtype == NP[dtype]
    assert_scaled_close(got, pallas, TOL[dtype])


@pytest.mark.parametrize("dtype,n", [(c64, 544), (c64, 152), (c128, 608),
                                     (c128, 68), (c64, 1472), (c128, 736)])
@pytest.mark.parametrize("inverse", [False, True])
def test_wide_strided_layout_matches_numpy(dtype, n, inverse):
    """The strided ``(outer, N, inner)`` layout at 17*2^k, 19*2^k and 23*2^k, a
    ragged last group of inner indices, with the twiddle, through
    ``radix.emulate`` and the strided entry's plain version."""
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


def _source_literals(p: int) -> tuple:
    """The (cos, sin) literals of ``odd_cos``/``odd_sin``'s branch for P =
    ``p`` in ``fft_radix.cuh``, m = 1 .. (P-1)/2."""
    src = (Path(radix.__file__).resolve().parent.parent / "csrc"
           / "fft_radix.cuh").read_text()
    out = []
    for fn in ("odd_cos", "odd_sin"):
        body = src[src.index(f"constexpr double {fn}("):]
        body = body[body.index(f"if (p == {p})"):]
        body = body[:body.index("}")]
        out.append(tuple(float(v) for v in re.findall(
            r"-?\d\.\d{20}", body)))
    return tuple(out)


@pytest.mark.parametrize("p", [17, 19, 23])
def test_wide_literals_match_numpy_and_the_cuda_source(p):
    """cos and sin of 2*pi*m/P, m = 1 .. (P-1)/2, as ``radix._ODD_COS`` and
    ``_ODD_SIN`` spell them: numpy's values to a float64 rounding, and the
    CUDA source's ``odd_cos``/``odd_sin`` the same digits; by symmetry
    every m (``radix._odd_cs``)."""
    m = np.arange(1, (p - 1) // 2 + 1)
    cos, sin = radix._ODD_COS[p], radix._ODD_SIN[p]
    assert len(cos) == len(sin) == (p - 1) // 2
    # numpy's own phase 2*pi*m/P is rounded: a few 1e-16 apart
    np.testing.assert_allclose(cos, np.cos(2 * np.pi * m / p), rtol=0,
                               atol=1e-15)
    np.testing.assert_allclose(sin, np.sin(2 * np.pi * m / p), rtol=0,
                               atol=1e-15)
    assert _source_literals(p) == (cos, sin)
    for k in range(3 * p):
        c, s = radix._odd_cs(p, k) if k % p else (1.0, 0.0)
        assert abs(c - np.cos(2 * np.pi * (k % p) / p)) < 1e-15
        assert abs(s - np.sin(2 * np.pi * (k % p) / p)) < 1e-15


@pytest.mark.parametrize("p", [17, 19, 23])
@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_wide_butterfly_is_the_dft(p, sign):
    """``radix._dft_small``'s P-point DFT (the kernel's ``dft_odd``, the
    symmetric-pair form) on random inputs against the DFT matrix, both
    directions, in complex128."""
    r = np.random.default_rng(p + int(sign))
    a = r.standard_normal(p) + 1j * r.standard_normal(p)
    got = radix._dft_small([torch.tensor(v) for v in a], sign)
    k = np.arange(p)
    want = np.exp(sign * 2j * np.pi * np.outer(k, k) / p) @ a
    assert_scaled_close(np.array([complex(v) for v in got]), want, 1e-14)


def test_wide_chains_and_the_smooth_predicate():
    """The 23s, the 19s and the 17s lead a chain (``radices``, the
    kernel's ``mixed_radix``); ``codelet_length`` takes r*2^k for r in
    ``WIDE_ODD`` = (17, 19, 23), while ``smooth`` (the dense route's and
    the long-line rule's) stays 13-smooth, so the dense chain keeps a
    prime past 13 as a generic stage; a prime past 23 has no codelet."""
    assert radix.ODD_RADICES[:3] == (23, 19, 17)
    assert radix.radices(2432 // 64) == (19, 2)
    assert radix.radices(2944 // 64) == (23, 2)
    assert radix.radices(323) == (19, 17)
    assert radix.radices(23 * 19 * 2) == (23, 19, 2)
    assert radix.radices(17 * 13 * 4) == (17, 13, 4)
    for n in (17, 34, 19, 152, 2432, 23, 46, 2944):
        assert radix.codelet_length(n) and not radix.smooth(n)
    for n in (51, 57, 323, 69, 29, 58):
        assert not radix.codelet_length(n)
    assert dense.chain(544) == (17, 4, 4, 2)
    assert dense.chain(816) == (17, 3, 4, 4)
    assert dense.chain(2944) == (23, 4, 4, 4, 2)
    with pytest.raises(ValueError, match="17, 19 and 23"):
        radix.radices(58)


@pytest.mark.parametrize("dtype", [c64, c128])
@pytest.mark.parametrize("r", [17, 19, 23])
def test_wide_odd_parts_take_every_codelet_route(dtype, r):
    """Every r*2^k takes the radix route while both factors fit a codelet
    (``CODELET_MAX``), the long-line route (R1 = r, R2 and R3 powers of
    two) to a 128 KB line and the split route (P a power of two, r in Q)
    to 2^24 / 2^22; the longest on the split route lay past the chirp's
    limit before, and none is left to the dense or chirp route."""
    cap = radix.CODELET_MAX[dtype]
    routes = {}
    for k in range(1, 24):
        n = r << k
        if n > (1 << 24 if dtype == c64 else 1 << 22):
            break
        routes.setdefault(radix.kernel_path(n, dtype), []).append(n)
    # the radix kernel's wide lines take the long route's wide kernel
    wide = [n for n in routes["long"] if n in longline.WIDE[dtype]]
    routes["long"] = [n for n in routes["long"] if n not in wide]
    routes["radix"] = sorted(routes.get("radix", []) + wide)
    assert routes["radix"] == [r << k for k in range(1, 24)
                               if max(factorize(r << k)) <= cap]
    assert routes["radix"][-1] == (r * 128 if dtype == c64 else r * 32)
    assert routes["long"] == [n for n in sorted(longline.FACTORS[dtype])
                              if radix.odd_part(n) == r]
    for n in routes["long"]:
        r1, r2, r3 = longline.FACTORS[dtype][n]
        assert r1 == r and radix.is_pow2(r2) and radix.is_pow2(r3)
        assert n * dtype.itemsize <= longline.LINE_MAX_BYTES
    assert len(routes["long"]) == (2 if dtype == c64 else 3)
    assert set(routes) == {"radix", "long", "split"}
    assert routes["split"][-1] > split.LIMIT[dtype] // 2   # the old chirp
    for n in routes["split"]:
        plan = split.split_plan(n, dtype)
        assert radix.is_pow2(plan.p) and radix.odd_part(plan.q) == r
        assert plan.p in split.COLUMN_SIZES[dtype]
        assert (plan.q in split.ROW_SIZES[dtype]) == (plan.row_path
                                                      == "radix")
    assert len(routes["split"]) == (10 if dtype == c64 else 9)


#: (dtype, N, route) from the H100 sweep of both routes forced on the
#: same lines (``scripts/route_times.py generic``, refit since the chirp's
#: folded load and store; PERF.md §6): the chirp where it read faster
#: than ``dense.MOVE_MARGIN`` covers (c64 1616 = 101*16, 1086, 1028, 53,
#: 4081, c128 1616, 1888, which the refit moved off the dense route),
#: dense where the dense route read faster (c128 123) or the chirp by less
#: than the margin (c64 848, 10%).
SWEPT = [(c64, 1616, "chirp"), (c64, 3232, "chirp"), (c64, 4831, "chirp"),
         (c64, 1086, "chirp"), (c64, 848, "dense"), (c64, 53, "chirp"),
         (c64, 4081, "chirp"), (c64, 1028, "chirp"), (c128, 2417, "chirp"),
         (c128, 1888, "chirp"), (c128, 123, "dense"), (c128, 1616, "chirp")]


@pytest.mark.parametrize("dtype", [c64, c128])
def test_dense_route_keeps_generic_stages_cheaper_than_the_chirp(dtype):
    """Up to ``DENSE_LIMIT`` an N that no codelet route takes runs dense
    exactly while its generic stages cost no more than the chirp route
    (``torch_harness.dense_keeps`` restates ``GENERIC_COST``'s rule: the
    sum of N's primes past 13 against the chirp's cost per element of M
    times M/N and ``MOVE_MARGIN``), and the chirp route takes the rest,
    its M (13-smooth, at most twice 2N - 1) on the long-line route's
    powers of two or the dense route's kernel, whose line fits one block;
    and the swept lengths take the route
    ``SWEPT`` names."""
    limit, cost = dense.DENSE_LIMIT[dtype], dense.GENERIC_COST[dtype]
    inner = set()
    for n in range(1, limit + 1):
        path = radix.kernel_path(n, dtype)
        if path in ("radix", "long", "split"):
            continue
        keep = dense_keeps(n, cost, dense.MOVE_MARGIN,
                           longline.FOLD_SIZES[dtype], dtype.itemsize)
        assert path == ("dense" if keep else "chirp"), (n, path)
        assert dense.takes(n, dtype) == (path == "dense")
        if path == "chirp":
            inner.add(chirp.chirp_plan(n, dtype).route)
    assert inner <= {"dense", "long"}
    for dt, n, route in SWEPT:
        if dt == dtype:
            assert radix.kernel_path(n, dtype) == route, n
