"""The long-line route at the mixed lengths r*2^k, r in
``radix.EVERY_ROUTE_ODD`` = {3, 5, 7, 9, 11, 13, 15, 17, 19, 21, 23, 25,
27} (``kernels/longline.py``, ``csrc/fft_long.cuh``'s
``long_mixed_kernel``): complex64 N of 4352 to 15360 and complex128 N of
1088 to 7680, whose line fits one block; and the rule's lengths, whose
odd part (33 to 729) needs a second mixed factor R2 (complex64 3168 to
16128, complex128 792 to 8064: ``longline.rule_factors``), at one length
per family and dtype (c64 4800 = 30 x 10 x 16, 8448 = 24 x 11 x 32,
3888 = 27 x 9 x 16; c128 4224 = 24 x 11 x 16, 2400 = 30 x 5 x 16, 1056 =
22 x 3 x 16) against ``np.fft`` and the Pallas kernel as the others.  Their plan (one mixed factor R1
on the radix route's mixed chain, R2 and R3 powers of two, a block of 128
or 256 threads walking each pass's items in rounds, every pass in place,
item by item) runs in torch in
``longline.emulate`` (the kernel's plain version, which the wrapper runs
for CPU tensors); it is held against ``np.fft`` at every length (both
directions, the twiddle and ``pack_parts`` epilogues) and against the JAX
package's Pallas kernel in interpret mode on the same numpy inputs at one
length per odd part r = 3, 5, 9, 15, 17, 19, 21, 23, 25, 27 (an odd R1) and
every 7*2^k, 11*2^k and 13*2^k, per dtype, at the reference's tolerances
(``tests/test_kernels.py:27``: 5e-6 max-scaled in complex64, 1e-12 in
complex128).  Then the plan's threads, sizes and tables, the routing of
every mixed length past the radix route, and ``fft_conv`` at S = 2688,
3072, 3328 and 3584 (lines of 5376, 6144, 6656 and 7168) forward and
backward against the reference's mixer.  The
CUDA kernel is tested in ``test_torch_cuda.py`` and ``chip_smoke.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft_matmul as jfm
from repro_torch.kernels import fft_matmul as tfm
from repro_torch.core.transforms import factorize
from repro_torch.kernels import dense, longline, ops, radix, split
from torch_harness import (assert_scaled_close, dense_keeps,
                           pallas_lines_c128)

TOL = {torch.complex64: 5e-6, torch.complex128: 1e-12}
NP = {torch.complex64: np.complex64, torch.complex128: np.complex128}
#: The lengths with one mixed factor R1 (R2 and R3 powers of two).
MIXED = [(dtype, n) for dtype, sizes in longline.FACTORS.items()
         for n in sorted(sizes)
         if radix.odd_part(n) in radix.EVERY_ROUTE_ODD]
#: The rule's lengths (R2 mixed too), and one of each family per dtype
#: held against np.fft and the Pallas kernel: an odd part 33 to 63 (8448
#: = 33*256, 4224), from 65 (4800 = 75*64, 2400) and past 243 (3888 =
#: 243*16, 1056 = 33*32 the shortest of complex128's dense lengths).
TWO = [(dtype, n) for dtype, sizes in longline.FACTORS.items()
       for n in sorted(sizes)
       if radix.odd_part(n) not in radix.EVERY_ROUTE_ODD + (1,)]
TWO_PARITY = [(torch.complex64, 4800), (torch.complex64, 8448),
              (torch.complex64, 3888), (torch.complex128, 4224),
              (torch.complex128, 2400), (torch.complex128, 1056)]
#: (batch, inverse, twiddle, pack_parts) per length: both directions,
#: each epilogue, segments of N/r (r the odd part's least prime factor)
#: and N/4.
VARIANTS = [(3, False, False, None), (1, True, True, None),
            (2, False, False, "odd"), (2, True, True, 4)]
CASES = [(dtype, n, b, inv, tw,
          next(r for r in (3, 5, 7, 11, 13, 17, 19, 23) if n % r == 0)
          if parts == "odd" else parts)
         for dtype, n in MIXED + TWO_PARITY
         for b, inv, tw, parts in VARIANTS]
#: One length per odd part r = 3, 5, 9, 15, 17, 19, 21, 23, 25, 27 and every
#: 7*2^k, 11*2^k and 13*2^k, per dtype, and the rule's parity lengths,
#: held against the Pallas kernel too.
PALLAS = {torch.complex64: {4608, 5120, 6144, 7680, 5632, 7168, 11264,
                            14336, 6656, 13312, 5376, 6400, 13824, 4800,
                            8448, 3888, 4352, 4864, 5888},
          torch.complex128: {1152, 1280, 3072, 7680, 1408, 1792, 2816,
                             3584, 5632, 7168, 1664, 3328, 6656, 1344,
                             3200, 6912, 4224, 2400, 1056, 1088, 2432,
                             2944}}


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
        if case[0] != torch.complex128 or case[1] not in PALLAS[case[0]]:
            continue
        x, t = _inputs(case)
        cases[_case_id(case).replace("-", "_")] = (x, t, case[3], case[5])
    return pallas_lines_c128(cases,
                             str(tmp_path_factory.mktemp("long_mixed_x64")))


def _pallas_c64(case, x, t):
    dtype, n, b, inv, tw, parts = case
    twp = None if t is None else (jnp.asarray(t.real), jnp.asarray(t.imag))
    yr, yi = jfm.fft1d_planes(jnp.asarray(x.real), jnp.asarray(x.imag),
                              inverse=inv, twiddle=twp, pack_parts=parts)
    assert yr.dtype == jnp.float32
    return np.asarray(yr) + 1j * np.asarray(yi)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_long_mixed_plan_matches_numpy_and_pallas(case, request):
    """The plan's plain version, through the wrapper on CPU tensors,
    against np.fft and (one length per odd part) the Pallas kernel on the
    same inputs; no launch is counted on the CPU."""
    dtype, n, b, inv, tw, parts = case
    assert radix.kernel_path(n, dtype) == "long"
    x, t = _inputs(case)
    tfm.reset_launch_counts()
    got = tfm.fft_fourstep(torch.from_numpy(x), inverse=inv,
                           twiddle=None if t is None else torch.from_numpy(t),
                           pack_parts=parts)
    assert tfm.launch_counts()["launches"] == 0
    assert got.dtype == dtype
    want_shape = (b, n) if parts is None else (b, parts, n // parts)
    assert tuple(got.shape) == want_shape
    if parts is not None:       # destination-major (p, B, N/p) storage
        assert got.transpose(0, 1).is_contiguous()
    got = got.numpy()
    assert_scaled_close(got, _numpy_ref(case, x, t), TOL[dtype])
    if n not in PALLAS[dtype]:
        return
    if dtype == torch.complex64:
        pallas = _pallas_c64(case, x, t)
    else:
        pallas = request.getfixturevalue("pallas_c128")[
            _case_id(case).replace("-", "_")]
    assert pallas.dtype == NP[dtype]
    assert_scaled_close(got, pallas, TOL[dtype])


@pytest.mark.parametrize("dtype,n", MIXED)
def test_long_mixed_threads_split_every_pass_evenly(dtype, n):
    """One mixed factor R1 = r*2^a of at most 32 values, R2 and R3 powers
    of two of at most 32.  The block is sized for occupancy, not by
    lcm(R1, R2, R3): 256 threads for complex64; complex128 128 where two
    blocks share an SM by shared memory, else 256; never fewer than 128.
    Each pass's items (N/R1, N/R2, N/R3) are walked in rounds of the
    block, item = tid + round*T, so every item falls to exactly one thread
    over the rounds and only the last round leaves threads idle.  A ring
    of two line buffers of R1 rows at a 16-byte padded pitch where two fit
    in the 227 KB of one block, else one."""
    plan = longline.long_plan(n, dtype)
    r1, r2, r3 = plan.r1, plan.r2, plan.r3
    assert plan.mixed and r1 * r2 * r3 == n
    assert not radix.is_pow2(r1) and r1 <= 32
    odd = r1 // (r1 & -r1)
    assert odd in radix.EVERY_ROUTE_ODD
    assert radix.is_pow2(r2) and radix.is_pow2(r3) and max(r2, r3) <= 32
    t = plan.threads
    assert t >= 128
    if dtype == torch.complex64:
        assert t == 256
    else:
        assert t == (128 if plan.blocks_per_sm >= 2 else 256)
    for r in (r1, r2, r3):
        items = n // r
        rounds = -(-items // t)
        taken = [tid + k * t for k in range(rounds) for tid in range(t)
                 if tid + k * t < items]
        assert sorted(taken) == list(range(items))      # each item once
        assert (rounds - 1) * t < items <= rounds * t   # idle: last round
    item = dtype.itemsize
    assert (plan.pitch - r2 * r3) * item == 16
    assert plan.line_elems == r1 * plan.pitch
    assert plan.pitch * item % 16 == 0 and r2 * r3 * item % 16 == 0
    assert plan.table == max(r2, r3)
    assert plan.const_elems == (r1 * r3 + r1 * r2 + r2 * r3
                                + plan.table // 2 + r1)
    tile = longline.long_tile(n, dtype)
    two = longline.smem_bytes(plan, item, 2)
    assert tile.depth == plan.depth == (2 if two <= radix.SMEM_MAX_BYTES
                                        else 1)
    assert tile.smem_bytes == longline.smem_bytes(plan, item, tile.depth)
    assert tile.smem_bytes <= radix.SMEM_MAX_BYTES
    assert plan.blocks_per_sm == max(1, 233472 // (tile.smem_bytes + 1024))
    assert n * item <= 128 << 10        # the power-of-two lines' limit


def test_long_mixed_lengths_are_every_r_2k_that_fits():
    """The table holds every mixed N = r*2^k, r in
    ``radix.EVERY_ROUTE_ODD``, past the radix route (a factor of
    ``factorize`` past its codelets' 64 or 32 values) whose line is at
    most 128 KB: complex64 4352 to 15360, complex128 1088 to 7680; 6144
    is 24 x 16 x 16 on 256 threads (1 round of radix 24, 2 of
    radix 16), complex128 1152 18 x 8 x 8 on 128, 7168 28 x 16 x 16
    (complex64 and complex128), 11264 22 x 16 x 32, 6656 26 x 16 x 16
    (complex64 and complex128), complex128 1664 26 x 8 x 8; the odd
    products 21, 25 and 27 have an odd R1 (complex64 10752 21 x 16 x 32,
    complex128 1344 21 x 8 x 8 and 6912 27 x 16 x 16), and so do the
    primes 17 and 19 (complex64 4352 17 x 16 x 16 and 9728 19 x 16 x 32,
    complex128 1088 17 x 8 x 8 and 2432 19 x 8 x 16)."""
    for dtype, first, last, cap in ((torch.complex64, 4352, 15360, 64),
                                    (torch.complex128, 1088, 7680, 32)):
        want = sorted(r << k for r in radix.EVERY_ROUTE_ODD
                      for k in range(1, 14)
                      if max(factorize(r << k)) > cap
                      and (r << k) * dtype.itemsize <= 128 << 10)
        got = sorted(n for n in longline.FACTORS[dtype]
                     if radix.odd_part(n) in radix.EVERY_ROUTE_ODD)
        assert got == want and got[0] == first and got[-1] == last
    plan = longline.long_plan(6144, torch.complex64)
    assert (plan.r1, plan.r2, plan.r3, plan.threads) == (24, 16, 16, 256)
    assert (-(-6144 // 24 // 256), -(-6144 // 16 // 256)) == (1, 2)
    plan = longline.long_plan(1152, torch.complex128)
    assert (plan.r1, plan.r2, plan.r3, plan.threads) == (18, 8, 8, 128)
    for dtype in (torch.complex64, torch.complex128):
        plan = longline.long_plan(7168, dtype)
        assert (plan.r1, plan.r2, plan.r3) == (28, 16, 16)
    plan = longline.long_plan(11264, torch.complex64)
    assert (plan.r1, plan.r2, plan.r3) == (22, 16, 32)
    for dtype in (torch.complex64, torch.complex128):
        plan = longline.long_plan(6656, dtype)
        assert (plan.r1, plan.r2, plan.r3) == (26, 16, 16)
    plan = longline.long_plan(1664, torch.complex128)
    assert (plan.r1, plan.r2, plan.r3) == (26, 8, 8)
    for n, dtype, factors in ((10752, torch.complex64, (21, 16, 32)),
                              (1344, torch.complex128, (21, 8, 8)),
                              (6912, torch.complex128, (27, 16, 16)),
                              (4352, torch.complex64, (17, 16, 16)),
                              (9728, torch.complex64, (19, 16, 32)),
                              (1088, torch.complex128, (17, 8, 8)),
                              (2432, torch.complex128, (19, 8, 16))):
        plan = longline.long_plan(n, dtype)
        assert (plan.r1, plan.r2, plan.r3) == factors


def _largest_r1(rest: int):
    """The largest R1 <= 32 with R2 = rest/R1 <= R1, both 13-smooth
    codelet lengths of 2 to 32, or None."""
    return next((a for a in range(32, 1, -1)
                 if rest % a == 0 and 2 <= rest // a <= a
                 and radix.smooth(a) and radix.smooth(rest // a)), None)


def _old_path(n: int, dtype: torch.dtype) -> str:
    """``radix.kernel_path`` before the rule: the table's lengths alone on
    the long-line route, and the chirp route past the dense route's old
    limit (``dense.DENSE_LIMIT``), as it then was."""
    from repro_torch.kernels import split
    if n in radix.RADIX_SIZES[dtype]:
        return "radix"
    if n in longline._TABLE[dtype]:
        return "long"
    if n in split.FACTORS[dtype]:
        return "split"
    # the chirp's limit then: half the split route's longest power of two
    return ("chirp" if dense.DENSE_LIMIT[dtype] < n <= split.LIMIT[dtype]
            // 2 else "dense")


@pytest.mark.parametrize("dtype,count,first,last", [
    (torch.complex64, 90, 3168, 16128), (torch.complex128, 135, 792, 8064)])
def test_long_rule_factors_every_length_it_takes(dtype, count, first, last):
    """``longline.FACTORS`` is the table (the powers of two and the one
    mixed factor lengths, 28 complex64 and 42 complex128 with 23*2^k's,
    their factors
    as before: R1 the odd part times as many 2s as 32 allows, R2 <= R3
    powers of two at most a factor 2 apart) and the rule: every even
    13-smooth N past the radix route (less ``radix._SPILLS``) up to a
    128 KB line that is R1*R2*R3, R1 and R2 13-smooth of at most 32 and
    R3 a power of two, split with the largest R3 up to 32 and then the
    largest R1, R3 = 32 only for complex64 plans whose block has an SM
    alone (the rest spilled in ptxas).  Every entry multiplies out; ``radix.kernel_path`` sends
    exactly the rule's lengths to "long" that went elsewhere (18
    complex64 and 63 complex128 from "dense", 72 each from "chirp"), and
    every other length up to twice the line where it went before (or,
    13-smooth past the old dense limit, on the dense route since it
    takes the lines that fit one block; or, up to that limit with generic
    stages that cost more than the chirp, on the chirp route)."""
    table = longline._TABLE[dtype]
    assert len(table) == (28 if dtype == torch.complex64 else 42)
    for n, (r1, r2, r3) in longline.FACTORS[dtype].items():
        assert r1 * r2 * r3 == n and max(r1, r2, r3) <= 32
        assert radix.codelet_length(r1) and radix.smooth(r2) \
            and radix.is_pow2(r3)
        assert n * dtype.itemsize <= 128 << 10
        if n in table and not radix.is_pow2(n):
            odd = radix.odd_part(n)
            assert odd in radix.EVERY_ROUTE_ODD
            assert r1 == odd << ((32 // odd).bit_length() - 1)
            assert radix.is_pow2(r2) and r3 in (r2, 2 * r2)
    rule = {n: f for n, f in longline.FACTORS[dtype].items()
            if n not in table}
    assert len(rule) == count and min(rule) == first and max(rule) == last
    moved = {"dense": 0, "chirp": 0}
    taken = set(radix.RADIX_SIZES[dtype])
    for n in range(1, 2 * (128 << 10) // dtype.itemsize + 1):
        path, old = radix.kernel_path(n, dtype), _old_path(n, dtype)
        if n in rule:
            assert path == "long" and old in moved, (n, old)
            moved[old] += 1
            r1, r2, r3 = rule[n]
            assert n % 2 == 0 and radix.smooth(n) and n not in taken
            assert rule[n] == longline.rule_factors(n, dtype)
            assert not radix.is_pow2(r1) and not radix.is_pow2(r2)
            assert r1 >= r2 and r3 >= 2
            plan = longline.long_plan(n, dtype)
            assert r3 < 32 or (dtype == torch.complex64
                               and plan.blocks_per_sm == 1)
            # no larger R3 splits N in a plan that stays in registers, and
            # no larger R1 splits N / R3
            for c3 in (4, 8, 16, 32):
                if c3 > r3 and n % c3 == 0:
                    a = _largest_r1(n // c3)
                    assert a is None or not longline._pass3_fits(
                        longline.LongPlan(n, a, n // c3 // a, c3,
                                          dtype.itemsize)), (n, c3)
            assert _largest_r1(n // r3) == r1, n
        elif path != old and (old, path) == ("radix", "long"):
            # since the wide kernel took the radix route's wide lines
            assert n in longline.WIDE[dtype], (n, path, old)
        elif path != old and (old, path) == ("dense", "chirp"):
            # since the chirp took the lines whose generic stages cost
            # more than it from the dense route
            assert n <= dense.DENSE_LIMIT[dtype] and not dense_keeps(
                n, dense.GENERIC_COST[dtype], dense.MOVE_MARGIN,
                longline.FOLD_SIZES[dtype], dtype.itemsize), (
                    n, path, old)
        elif path != old and path == "split":
            # since the split route's general plans took the other
            # 13-smooth lines past one block from the chirp
            assert old == "chirp" and radix.smooth(n) and \
                split.general_factors(n, dtype), (n, path, old)
        elif path != old:
            # since the dense route took the 13-smooth lines that fit one
            # block from the chirp
            assert (old, path) == ("chirp", "dense") and radix.smooth(n) \
                and dense.fits(n, dtype), (n, path, old)
    assert moved == ({"dense": 18, "chirp": 72} if dtype == torch.complex64
                     else {"dense": 63, "chirp": 72})
    odd = sorted({radix.odd_part(n) for n in rule})
    assert len(odd) == 42 and odd[0] == 33 and odd[-1] == 729
    c64, c128 = torch.complex64, torch.complex128
    assert longline.rule_factors(8448, c64) == (24, 11, 32)
    # 30 x 5 x 32 would spill at 128 registers (two blocks an SM)
    assert longline.rule_factors(4800, c64) == (30, 10, 16)
    assert longline.rule_factors(4800, c128) == (30, 10, 16)
    assert longline.rule_factors(1056, c128) == (22, 3, 16)
    assert longline.rule_factors(2730, c64) is None   # 1365 = 3*5*7*13


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_long_rule_plans_fit_a_block(dtype):
    """At every rule length the plan's R2 is mixed: its own table of R2
    entries after R1's, the radix-2 codelets' table R3/2 entries; the
    block holds the line at a 16-byte padded pitch, one or two of them,
    within the 227 KB of one block; 256 threads for complex64, 128 or 256
    for complex128, as the other mixed lengths."""
    item = dtype.itemsize
    for n in [n for d, n in TWO if d == dtype]:
        plan = longline.long_plan(n, dtype)
        r1, r2, r3 = plan.r1, plan.r2, plan.r3
        assert plan.mixed and plan.mixed_r2 and plan.table == r3
        assert plan.const_elems == (r1 * r3 + r1 * r2 + r2 * r3 + r3 // 2
                                    + r1 + r2)
        assert (plan.pitch - r2 * r3) * item == 16
        assert plan.pitch * item % 16 == 0 and r2 * r3 * item % 16 == 0
        tile = longline.long_tile(n, dtype)
        assert tile.depth == plan.depth
        assert tile.smem_bytes == longline.smem_bytes(plan, item, tile.depth)
        assert tile.smem_bytes <= radix.SMEM_MAX_BYTES
        if dtype == torch.complex64:
            assert plan.threads == 256
        else:
            assert plan.threads == (128 if plan.blocks_per_sm >= 2 else 256)


@pytest.mark.parametrize("inverse", [False, True])
def test_long_mixed_r2_has_its_own_table(inverse):
    """At 8448 = 24 x 11 x 32 the constants are TA, TB, TC, the radix-2
    table of R3/2 = 16 entries, W_R1^j (j < 24), then W_R2^j (j < 11),
    all in float64; both mixed tables carry the direction's sign, which
    the kernel reads from W_R1^1."""
    n, dtype = 8448, torch.complex64
    p = longline.long_plan(n, dtype)
    assert (p.r1, p.r2, p.r3) == (24, 11, 32)
    c = longline.constants(n, dtype, inverse)
    assert c.dtype == np.complex128 and c.size == p.const_elems
    ta, tb, tc, w, wm, wm2 = np.split(c, np.cumsum(
        [p.r1 * p.r3, p.r1 * p.r2, p.r2 * p.r3, p.table // 2, p.r1]))
    sign = 1.0 if inverse else -1.0
    k1 = np.arange(p.r1)[:, None]
    mb = np.arange(n // p.r1)
    full = ta.reshape(p.r1, p.r3)[:, mb % p.r3] \
        * tb.reshape(p.r1, p.r2)[:, mb // p.r3]
    np.testing.assert_allclose(full, np.exp(sign * 2j * np.pi * k1 * mb / n),
                               atol=1e-13)
    np.testing.assert_allclose(
        w, np.exp(sign * 2j * np.pi * np.arange(16) / 32), atol=1e-15)
    np.testing.assert_allclose(
        wm, np.exp(sign * 2j * np.pi * np.arange(24) / 24), atol=1e-15)
    np.testing.assert_allclose(
        wm2, np.exp(sign * 2j * np.pi * np.arange(11) / 11), atol=1e-15)
    assert (wm[1].imag > 0) == inverse and (wm2[1].imag > 0) == inverse


@pytest.mark.parametrize("inverse", [False, True])
def test_long_mixed_constants_and_the_codelet_tables(inverse):
    """TA[k1, m3] * TB[k1, m2] is W_N^(k1*mb), TC[k2, m3] W_(R2*R3)^(k2*m3),
    W the radix-2 codelets' W_table^j (j < table/2) and the mixed codelet
    its own W_R1^j (j < R1); the cached device copy is their cast."""
    n, dtype = 6144, torch.complex64
    p = longline.long_plan(n, dtype)
    c = longline.constants(n, dtype, inverse)
    assert c.dtype == np.complex128 and c.size == p.const_elems
    ta, tb, tc, w, wm = np.split(c, np.cumsum(
        [p.r1 * p.r3, p.r1 * p.r2, p.r2 * p.r3, p.table // 2]))
    sign = 1.0 if inverse else -1.0
    k1 = np.arange(p.r1)[:, None]
    mb = np.arange(n // p.r1)
    full = ta.reshape(p.r1, p.r3)[:, mb % p.r3] \
        * tb.reshape(p.r1, p.r2)[:, mb // p.r3]
    np.testing.assert_allclose(full, np.exp(sign * 2j * np.pi * k1 * mb / n),
                               atol=1e-13)
    k2 = np.arange(p.r2)[:, None]
    m3 = np.arange(p.r3)[None, :]
    np.testing.assert_allclose(
        tc.reshape(p.r2, p.r3),
        np.exp(sign * 2j * np.pi * k2 * m3 / (p.r2 * p.r3)), atol=1e-15)
    np.testing.assert_allclose(
        w, np.exp(sign * 2j * np.pi * np.arange(p.table // 2) / p.table),
        atol=1e-15)
    np.testing.assert_allclose(
        wm, np.exp(sign * 2j * np.pi * np.arange(p.r1) / p.r1), atol=1e-15)
    # the kernel reads the mixed codelets' sign from W_R1^1
    assert (wm[1].imag > 0) == inverse
    dev = tfm._long_constants(n, inverse, dtype, torch.device("cpu"))
    assert torch.equal(dev, torch.from_numpy(c).to(dtype))


def test_wrapper_runs_the_mixed_emulation_on_cpu_tensors():
    """For a mixed long N the CPU wrapper's result is ``longline.emulate``'s,
    bit for bit, and the unscaled inverse (the split route's pass B) is
    the scaled one times N; the counters stay at 0."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 6144)).astype(np.complex64))
    tfm.reset_launch_counts()
    assert torch.equal(tfm.fft_fourstep(x, inverse=True),
                       longline.emulate(x, inverse=True))
    packed = tfm.fft_fourstep(x, pack_parts=3)
    assert torch.equal(packed.transpose(0, 1),
                       longline.emulate(x, pack_parts=3))
    assert_scaled_close(longline.emulate(x, inverse=True, scaled=False)
                        .numpy() / 6144,
                        longline.emulate(x, inverse=True).numpy(), 1e-7)
    assert tfm.launch_counts()["launches"] == 0


def test_every_mixed_length_past_the_radix_route_goes_long_then_split():
    """``radix.kernel_path``: every complex64 r*2^k from 4608 to 16384 and
    every complex128 one from 1152 to 8192 is "long", every longer one up
    to the split route's limits (2^24, 2^22) "split"; none is "chirp" or
    "dense" (7*2^k, 11*2^k, 13*2^k, 17*2^k, 19*2^k, 21*2^k, 23*2^k,
    25*2^k and 27*2^k included: complex64 13*2^20, 19*2^19, 23*2^19 and
    complex128 13*2^18, 19*2^17, 23*2^17, past the chirp's limits, run);
    a prime and 29*2^k past the dense route's old limit stay "chirp"; a
    13-smooth line past one block that no radix P holds is "split" by
    the general plans (29106 = 2*14553; 45*2^9, past the 128 KB line but
    within one block, is "dense", and 45*2^10 = 256 x 180 "split" by the
    split route's rule);
    19*2^k and 23*2^k, the chirp's before the radix-19 and radix-23
    codelets, are "long" (4864, 5888, complex128 2432, 2944)."""
    for dtype, (lo, hi, top) in {
            torch.complex64: (4608, 16384, 1 << 24),
            torch.complex128: (1152, 8192, 1 << 22)}.items():
        for r in radix.EVERY_ROUTE_ODD:
            for k in range(1, 25):
                n = r << k
                if n < lo or n > top:
                    continue
                want = "long" if n <= hi else "split"
                assert radix.kernel_path(n, dtype) == want, (n, dtype)
    assert radix.kernel_path(13 << 20, torch.complex64) == "split"
    assert radix.kernel_path(13 << 18, torch.complex128) == "split"
    for n, dtype in ((7424, torch.complex64), (10007, torch.complex64),
                     (20011, torch.complex64), (3712, torch.complex128),
                     (3001, torch.complex128)):
        assert radix.kernel_path(n, dtype) == "chirp"
    assert radix.kernel_path(29106, torch.complex64) == "split"
    assert radix.kernel_path(46080, torch.complex64) == "split"
    assert radix.kernel_path(5888, torch.complex64) == "long"
    assert radix.kernel_path(2944, torch.complex128) == "long"
    assert radix.kernel_path(23040, torch.complex64) == "dense"
    assert radix.kernel_path(4864, torch.complex64) == "long"
    assert radix.kernel_path(2432, torch.complex128) == "long"
    assert radix.kernel_path(19 << 19, torch.complex64) == "split"
    assert radix.kernel_path(19 << 17, torch.complex128) == "split"


def test_mixed_long_lines_along_any_axis_and_their_gradient():
    """``ops.fft1d`` on a mixed long N: contiguous lines in place, a
    strided axis copied contiguous first (``ops.copies``); the
    transform's gradient (``LineTransform``, the adjoint on the same
    route) against ``torch.fft``'s, both directions."""
    n = 6144
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


def test_fft_conv_at_2688_takes_the_long_route_and_matches_reference():
    """``fft_conv`` at S=2688 (lines of 5376 = 21 x 16 x 16: an odd R1,
    off the chirp route since the odd products joined the long-line
    route), as at S=3072: the output and every gradient against the
    reference's mixer."""
    _fft_conv_on_the_long_route_matches_reference(2688)


def test_fft_conv_at_3072_takes_the_long_route_and_matches_reference():
    """``fft_conv`` at S=3072 (lines of 6144, the long-line route) with 8
    channels on the kernel backend's plain version against the
    reference's mixer, float32: the output, and the gradients of w_in,
    basis_w, decay, w_out and the input against ``jax.grad`` of the
    reference's ``fft_backend="xla"``."""
    _fft_conv_on_the_long_route_matches_reference(3072)


def test_fft_conv_at_3328_takes_the_long_route_and_matches_reference():
    """``fft_conv`` at S=3328 (lines of 6656 = 26 x 16 x 16: the radix-13
    codelet took it off the chirp route), as at S=3072: the output and
    every gradient against the reference's mixer."""
    _fft_conv_on_the_long_route_matches_reference(3328)


def test_fft_conv_at_3584_takes_the_long_route_and_matches_reference():
    """``fft_conv`` at S=3584 (lines of 7168 = 28 x 16 x 16: the radix-7
    codelet took it off the chirp route), as at S=3072: the output and
    every gradient against the reference's mixer; the 3 transforms' long
    launches are counted on the card (``test_torch_cuda.py``,
    ``chip_smoke.py``'s ``[lm_fftconv]``)."""
    _fft_conv_on_the_long_route_matches_reference(3584)


def _fft_conv_on_the_long_route_matches_reference(s):
    from lm_parity import F32_TOL, f32, jax_init, port_module, randn, \
        scaled_err, tt
    from repro.configs import smoke_config as ref_smoke_config
    from repro.distributed.sharding import MeshRules
    from repro.models import ssm as ref_ssm
    from repro_torch.models import ssm

    cfg = f32(dataclasses.replace(ref_smoke_config("jamba_v0_1_52b"),
                                  ssm_impl="fft_conv", d_model=4, expand=2))
    tree, ref_p = jax_init(ref_ssm.init_fft_conv, cfg, "ssm", seed=3)
    p = port_module(ssm.init_fft_conv, tree, "ssm", cfg)
    assert p.basis_w.shape[0] == 8                  # 8 channels
    assert radix.kernel_path(2 * s, torch.complex64) == "long"
    x = randn((1, s, cfg.d_model), 11)
    r = randn((1, s, cfg.d_model), 12)
    y_ref, _ = ref_ssm.fft_conv(ref_p, cfg, MeshRules(), jnp.asarray(x))

    def ref_loss(pp, xx):
        y, _ = ref_ssm.fft_conv(pp, cfg, MeshRules(), xx, fft_backend="xla")
        return jnp.sum(y * jnp.asarray(r))

    ref_gp, ref_gx = jax.grad(ref_loss, argnums=(0, 1))(ref_p,
                                                        jnp.asarray(x))
    tfm.reset_launch_counts()
    p.requires_grad_(True)
    xt = tt(x).requires_grad_(True)
    y, _ = ssm.fft_conv(p, cfg, None, xt, fft_backend="kernel")
    assert scaled_err(y, y_ref) < F32_TOL
    (y * tt(r)).sum().backward()
    counts = tfm.launch_counts()                     # plain version on CPU
    assert counts["launches"] == 0 and counts["chirp_calls"] == 0
    for name in ("w_in", "basis_w", "decay", "w_out"):
        g = getattr(p, name).grad
        assert g is not None and bool(g.abs().max() > 0), name
        assert scaled_err(g, ref_gp[name]) < F32_TOL, name
    assert scaled_err(xt.grad, ref_gx) < F32_TOL
