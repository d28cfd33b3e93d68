"""The split route's rule (``kernels/split.py``: ``rule_factors``, the
lengths of ``FACTORS`` past its measured table): every 13-smooth N and
every r*2^k, r in ``radix.WIDE_ODD``, up to 2^24 (complex64) / 2^22
(complex128) that no other route takes, with N = P*Q, P a pass-A length
(``split.COLUMN_SIZES``) and Q a radix row up to ``split.ROW_MAX`` (the
least P below the largest whose Q is at most ``split.ROW_SHORT``, else
the least P) or else a long-line row (a multiple of 32, P in
``split.LONG_P``'s order).  Rule lengths on both kinds of row through
the route's plain version (``split.emulate``, which the wrapper runs on
CPU tensors) against ``np.fft`` and the JAX package's Pallas kernel in
interpret mode on the same numpy inputs (complex64 33792 = 256 x 132 and
complex128 16896 = 64 x 264 on radix rows, complex128 405504 = 64 x 6336
on long-line rows, and complex64 1982464 = 512 x 3872 on long-line rows
against ``np.fft`` alone; both directions, the twiddle and
``pack_parts`` epilogues) at the reference's tolerances
(``tests/test_kernels.py:27``: 5e-6 max-scaled in complex64, 1e-12 in
complex128); then every rule length's plan against the tiles and the
instantiated pass lengths, the rule restated, the lengths it lifts past
the chirp's limit, and the routes it leaves alone.  The CUDA kernels are
tested in ``test_torch_cuda.py`` and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft_matmul as jfm
from repro_torch.kernels import fft_matmul as tfm
from repro_torch.kernels import chirp, dense, longline, ops, radix, split
from torch_harness import assert_scaled_close, pallas_lines_c128

TOL = {torch.complex64: 5e-6, torch.complex128: 1e-12}
NP = {torch.complex64: np.complex64, torch.complex128: np.complex128}
c64, c128 = torch.complex64, torch.complex128
#: (dtype, N, row route): a radix-row rule length per dtype and the
#: shortest long-row one per dtype; complex64's is held to np.fft alone
#: (the Pallas kernel's dense matrices of 1408 x 1408 at 1982464 took 48
#: s a case under the suite's load).
LENGTHS = [(c64, 33792, "radix"), (c128, 16896, "radix"),
           (c128, 405504, "long"), (c64, 1982464, "long")]
PALLAS = {33792, 16896, 405504}
#: (inverse, twiddle, pack_parts) on one line: both directions, each
#: epilogue (segments of N/r, r the odd part's least prime factor, and
#: N/4); the long-row length both directions, each epilogue once.
VARIANTS = [(False, False, None), (True, True, None), (False, True, "odd"),
            (True, False, 4)]
LONG_VARIANTS = [(False, True, "odd"), (True, True, 4)]
CASES = [(dtype, n, row, inv, tw,
          next(r for r in (3, 5, 7, 11, 13) if n % r == 0)
          if parts == "odd" else parts)
         for dtype, n, row in LENGTHS
         for inv, tw, parts in (LONG_VARIANTS if row == "long"
                                else VARIANTS)]
#: The rule's lengths per dtype: (all, on long-line rows, past the chirp
#: route's limit, which raised before the rule).
COUNTS = {c64: (396, 118, 38), c128: (269, 95, 29)}


def _case_id(case):
    dtype, n, row, inv, tw, parts = case
    return (f"{str(dtype).removeprefix('torch.')}-{n}-{row}-"
            f"{'inv' if inv else 'fwd'}-tw{int(tw)}-p{parts}")


def _inputs(case):
    dtype, n, row, inv, tw, parts = case
    r = np.random.default_rng(n + int(inv) + 10 * int(tw))
    x = (r.standard_normal((1, n)) + 1j * r.standard_normal((1, n))
         ).astype(NP[dtype])
    t = np.exp(-1j * np.pi * np.arange(n) / (2 * n)).astype(NP[dtype]) \
        if tw else None
    return x, t


def _numpy_ref(case, x, t):
    dtype, n, row, inv, tw, parts = case
    y = (np.fft.ifft if inv else np.fft.fft)(x.astype(np.complex128),
                                             axis=-1)
    if t is not None:
        y = t * y
    return y if parts is None else y.reshape(1, parts, n // parts)


@pytest.fixture(scope="module")
def pallas_c128(tmp_path_factory):
    """The Pallas kernel's complex128 results (interpret mode under
    ``jax_enable_x64``, every case in one fresh process)."""
    cases = {}
    for case in CASES:
        if case[0] == c128 and case[1] in PALLAS:
            x, t = _inputs(case)
            cases[_case_id(case).replace("-", "_")] = (x, t, case[3],
                                                       case[5])
    return pallas_lines_c128(cases, str(tmp_path_factory.mktemp("rule_x64")))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_rule_lengths_match_numpy_and_pallas(case, request):
    """The rule's plan (the route ``radix.kernel_path`` names, the row
    route the case names) through the wrapper on CPU tensors, which runs
    ``split.emulate``, against np.fft and the Pallas kernel on the same
    inputs (np.fft alone outside ``PALLAS``); no launch is counted on the
    CPU and no line is copied."""
    dtype, n, row, inv, tw, parts = case
    assert radix.kernel_path(n, dtype) == "split"
    assert n not in split._TABLE[dtype]
    plan = split.split_plan(n, dtype)
    assert plan.row_path == row
    assert (plan.p, plan.q) == split.rule_factors(n, dtype)
    x, t = _inputs(case)
    tfm.reset_launch_counts()
    ops.copies["lines"] = 0
    got = tfm.fft_fourstep(torch.from_numpy(x), inverse=inv,
                           twiddle=None if t is None else torch.from_numpy(t),
                           pack_parts=parts)
    assert tfm.launch_counts()["launches"] == 0
    assert ops.copies["lines"] == 0
    assert got.dtype == dtype
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
    assert pallas.dtype == NP[dtype]
    assert_scaled_close(got, pallas, TOL[dtype])


def _rule(dtype):
    return {n: pq for n, pq in split.FACTORS[dtype].items()
            if n not in split._TABLE[dtype]}


@pytest.mark.parametrize("dtype", [c64, c128])
def test_rule_plans_fit_the_tiles_and_the_instantiated_sizes(dtype):
    """Every rule length: N = P*Q up to the route's limit, P a pass-A
    length on the strided radix tile; Q a radix row (an instantiated pass
    B of ``ROW_SIZES``, a radix-route length up to ``ROW_MAX``, whose
    tile's L rows divide P) or a long-line row (a length of
    ``longline.FACTORS``, a multiple of 32); both
    tiles within one block's shared memory; QL a power of two dividing Q;
    the inter-step tables within 16 MB; N on the split route.  The counts
    of rule lengths, long-line rows and lengths past the chirp's limit
    are :data:`COUNTS`."""
    rule = _rule(dtype)
    long_rows = past = 0
    for n, (p, q) in rule.items():
        plan = split.split_plan(n, dtype)
        assert p * q == n <= split.LIMIT[dtype]
        assert p in split.COLUMN_SIZES[dtype]
        assert tfm.strided_supported(p, dtype, False)
        assert split.column_tile(plan, dtype).smem_bytes \
            <= radix.SMEM_MAX_BYTES
        assert split.row_tile(plan, dtype).smem_bytes <= radix.SMEM_MAX_BYTES
        if plan.row_path == "radix":
            assert q in split.ROW_SIZES[dtype] and q <= split.ROW_MAX[dtype]
            assert q in radix.RADIX_SIZES[dtype]
            assert p % split.row_lines(plan, dtype) == 0
        else:
            assert q in longline.FACTORS[dtype] and q % 32 == 0
            assert q not in split.ROW_SIZES[dtype]
            long_rows += 1
        assert radix.is_pow2(plan.ql) and plan.ql * plan.qh == q
        assert plan.const_elems * dtype.itemsize <= 16 << 20
        assert radix.kernel_path(n, dtype) == "split"
        past += n > split.LIMIT[dtype] // 2     # the chirp's old limit
    assert (len(rule), long_rows, past) == COUNTS[dtype]


def _candidates(n, dtype):
    """(radix rows, long-line rows): the (P, Q) the instantiated pass
    lengths could run for N."""
    radix_rows, long_rows = [], []
    for p in split.COLUMN_SIZES[dtype]:
        if n % p:
            continue
        q = n // p
        lines = radix.radix_tile(q, dtype.itemsize, False, False).lines \
            if q in radix.RADIX_SIZES[dtype] else 0
        if q in radix.RADIX_SIZES[dtype] and q <= split.ROW_MAX[dtype] \
                and p % lines == 0:
            radix_rows.append((p, q))
        if q in longline.FACTORS[dtype] and q % 32 == 0:
            long_rows.append((p, q))
    return radix_rows, long_rows


def _smooth_or_wide(n):
    odd = radix.odd_part(n)
    return radix.smooth(odd) or odd in radix.WIDE_ODD


@pytest.mark.parametrize("dtype", [c64, c128])
def test_rule_takes_the_least_p_on_radix_rows_then_long_rows(dtype):
    """The rule restated: of every 13-smooth (or r*2^k, r in
    ``WIDE_ODD``) even N up to the limit that no other route takes (not a
    radix, long-line or measured split length, and no line the dense
    route takes), those with a (P, Q) candidate are the rule's lengths;
    each takes the least P below the largest on a radix row of at most
    ``ROW_SHORT``, else the least P on a radix row, else the first P of
    ``LONG_P`` on a long-line row.  Complex64 376832 = 23*2^14 takes 512
    x 736 (not 256 x 1472), 663552 takes 512 x 1296 (not 1024 x 648) and
    33792 takes 256 x 132."""
    taken = (set(radix.RADIX_SIZES[dtype]) | set(longline.FACTORS[dtype])
             | set(split._TABLE[dtype]))
    want = {}
    for q in set(radix.RADIX_SIZES[dtype]) | set(longline.FACTORS[dtype]):
        for p in split.COLUMN_SIZES[dtype]:
            n = p * q
            if n > split.LIMIT[dtype] or n in taken or n in want \
                    or dense.takes(n, dtype) or not _smooth_or_wide(n):
                continue
            radix_rows, long_rows = _candidates(n, dtype)
            short = [c for c in radix_rows if c[1] <= split.ROW_SHORT
                     and c[0] < max(split.COLUMN_SIZES[dtype])]
            if short or radix_rows:
                want[n] = (short or radix_rows)[0]
            elif long_rows:
                want[n] = next(c for lp in split.LONG_P[dtype]
                               for c in long_rows if c[0] == lp)
    assert _rule(dtype) == want
    if dtype == c64:
        assert [want[n] for n in (376832, 663552, 33792)] == [
            (512, 736), (512, 1296), (256, 132)]


@pytest.mark.parametrize("dtype", [c64, c128])
def test_rule_leaves_the_other_routes_alone(dtype):
    """The rule takes nothing another route takes: every 13-smooth N up
    to the longest line the dense route holds keeps the dense route where
    ``dense.takes`` holds it (and no radix, long-line or measured split
    length does);
    the measured table keeps its plans; what the rule cannot hold (odd N
    such as 98415 = 3^9*5, N with one factor of 2 such as 29106 =
    2*14553, Q that no row fits: 30976 = 256 x 121, complex128 62720 =
    64 x 980, 980 = 28 x 35 past its codelets) takes the split route's
    general plans (``split.general_factors``); past the split route's
    limit (3^15*2), which raised, its nested plans
    (``split.nested_factors``)."""
    for n, pq in split._TABLE[dtype].items():
        assert split.FACTORS[dtype][n] == pq
    top = 28431 if dtype == c64 else 14196
    for n in range(2, top + 1):
        if not radix.smooth(n) or n in radix.RADIX_SIZES[dtype] \
                or n in longline.FACTORS[dtype] or n in split._TABLE[dtype]:
            continue
        if dense.takes(n, dtype):
            assert radix.kernel_path(n, dtype) == "dense", n
            assert n not in split.FACTORS[dtype]
    for n in (29106, 3 ** 9 * 5, 30976 if dtype == c64 else 62720):
        assert split.rule_factors(n, dtype) is None
        assert split.general_factors(n, dtype) is not None
        assert radix.kernel_path(n, dtype) == "split", n
    # past the split route's limit, no (P, Q) of the rule: a nested plan
    n = 3 ** 15 * 2
    assert n > split.LIMIT[dtype] and split.rule_factors(n, dtype) is None
    assert radix.kernel_path(n, dtype) == "split"
    p, q, _ = split.nested_factors(n, dtype)
    assert p * q == n and q <= split.LIMIT[dtype]
    assert split.split_plan(n, dtype).row_path == "any"


def test_rule_message_names_the_split_rule():
    """Past every route's domain the dense route's message names the
    split route's measured table and rule, and the chirp's limit."""
    with pytest.raises(ValueError, match="rule_factors") as err:
        tfm.launch_config(split.MAX_LENGTH + 1, 8)
    assert str(chirp.max_chirp_length()) in str(err.value)
    assert split.LIMIT == {c64: 1 << 24, c128: 1 << 22}
