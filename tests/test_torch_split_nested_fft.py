"""The split route's nested plans (``kernels/split.py``:
``nested_factors``, ``any_factors``) and the chirp route without a length
limit (``kernels/chirp.py``: ``chirp_plan``).

Past the split route's old limit (2^24 complex64, 2^22 complex128) a
line of N = P*Q takes pass A on a column pass of a 13-smooth P (the
radix route at a P of ``split.COLUMN_SIZES``, or the dense kernel's
column form), pass B the rows' own launch on any route but the chirp
(the split route itself one level down) and pass C for any P and Q, up
to ``split.MAX_LENGTH`` = 2^30; every other N there takes the chirp,
whose M is any 13-smooth length a route with the folded load and store
runs, up to the kernels' 32-bit line index (``split.LINE_MAX``).

Forced nested plans at a few thousand points (the rows' limit passed as
an argument, nothing changed globally) through ``split.emulate_plan``
(the rows through ``fft_fourstep_plain``) against ``np.fft`` and the JAX
package's Pallas kernel in interpret mode on the same numpy inputs, both
directions, the twiddle and ``pack_parts`` epilogues, at the reference's
tolerances (``tests/test_kernels.py:27``: 5e-6 max-scaled in complex64,
1e-12 in complex128); then the lengths that raised before, a seeded
sample past the old limits, and the message past the domain.  The CUDA
kernels are tested in ``test_torch_cuda.py`` and ``chip_smoke.py``."""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft_matmul as jfm
from repro_torch.kernels import fft_matmul as tfm
from repro_torch.kernels import chirp, dense, radix, split
from torch_harness import assert_scaled_close, pallas_lines_c128

TOL = {torch.complex64: 5e-6, torch.complex128: 1e-12}
NP = {torch.complex64: np.complex64, torch.complex128: np.complex128}
c64, c128 = torch.complex64, torch.complex128
#: The chirp's limit before its M could take any route length: half the
#: split route's longest power of two; past it N with a prime factor past
#: 13 raised, and past the split route's limit every N.
OLD_CHIRP = {c64: 1 << 23, c128: 1 << 21}
#: (dtype, N, rows' limit, forced (P, Q, pass A's route) or None for
#: ``any_factors``' own choice at that limit): rows on the radix route
#: (4096 at rows of 64), the dense route (3375 = 15 x 225, odd), the
#: long-line route (c64 24576 = 3 x 8192), a radix pass A (c64 256 x 12,
#: c128 64 x 50).
NESTED = [(c64, 4096, 64, None), (c64, 3375, 225, (15, 225, "dense")),
          (c64, 3072, 12, (256, 12, "radix")),
          (c64, 24576, 8192, (3, 8192, "dense")),
          (c128, 3200, 50, (64, 50, "radix")),
          (c128, 2025, 81, None)]
VARIANTS = [(False, False, None), (True, True, 4)]
CASES = [(dtype, n, lim, forced, inv, tw,
          parts if parts and n % parts == 0 else (3 if parts else None))
         for dtype, n, lim, forced in NESTED for inv, tw, parts in VARIANTS]


def _case_id(case):
    dtype, n, lim, forced, inv, tw, parts = case
    return (f"{str(dtype).removeprefix('torch.')}-{n}-rows{lim}-"
            f"{'inv' if inv else 'fwd'}-tw{int(tw)}-p{parts}")


def _inputs(case):
    dtype, n, lim, forced, inv, tw, parts = case
    r = np.random.default_rng(n + lim + int(inv))
    x = (r.standard_normal((2, n)) + 1j * r.standard_normal((2, n))
         ).astype(NP[dtype])
    t = np.exp(-1j * np.pi * np.arange(n) / (2 * n)).astype(NP[dtype]) \
        if tw else None
    return x, t


@pytest.fixture(scope="module")
def pallas_c128(tmp_path_factory):
    """The Pallas kernel's complex128 results (interpret mode under
    ``jax_enable_x64``, every case in one fresh process)."""
    cases = {}
    for case in CASES:
        if case[0] == c128:
            x, t = _inputs(case)
            cases[_case_id(case).replace("-", "_")] = (x, t, case[4],
                                                       case[6])
    return pallas_lines_c128(cases,
                             str(tmp_path_factory.mktemp("nested_x64")))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_forced_nested_plans_match_numpy_and_pallas(case, request):
    """A nested plan at rows of at most ``lim`` (``any_factors``' choice,
    or forced), rows on their own route's plain version, against np.fft
    and the Pallas kernel on the same inputs."""
    dtype, n, lim, forced, inv, tw, parts = case
    p, q, col = forced or split.any_factors(n, dtype, limit=lim)
    assert p * q == n and q <= lim
    assert split.row_route(q, dtype) == radix.kernel_path(q, dtype)
    assert (p, q, col) in split.any_candidates(n, dtype, limit=lim)
    x, t = _inputs(case)
    buf = split.emulate_plan(
        torch.from_numpy(x), split.SplitPlan(n, p, q, "any", col),
        inverse=inv, twiddle=None if t is None else torch.from_numpy(t),
        pack_parts=parts)
    got = (buf if parts is None else buf.transpose(0, 1)).numpy()
    assert got.dtype == NP[dtype]
    want = (np.fft.ifft if inv else np.fft.fft)(x.astype(np.complex128),
                                                axis=-1)
    if t is not None:
        want = t * want
    if parts is not None:
        want = want.reshape(2, parts, n // parts)
    assert_scaled_close(got, want, TOL[dtype])
    if dtype == c64:
        twp = None if t is None else (jnp.asarray(t.real),
                                      jnp.asarray(t.imag))
        yr, yi = jfm.fft1d_planes(jnp.asarray(x.real), jnp.asarray(x.imag),
                                  inverse=inv, twiddle=twp, pack_parts=parts,
                                  interpret=True)
        pallas = np.asarray(yr) + 1j * np.asarray(yi)
    else:
        pallas = request.getfixturevalue("pallas_c128")[
            _case_id(case).replace("-", "_")]
    assert pallas.dtype == NP[dtype]
    assert_scaled_close(got, pallas, TOL[dtype])


#: Lengths that raised before, per dtype: primes and products with no
#: 13-smooth plan past the chirp's old limit (the chirp now), 13-smooth
#: and other lengths past the split route's old limit (nested now), and
#: 2^30, the longest line.
RAISED = [(c64, 8388617, "chirp"), (c64, (1 << 24) + 1, "chirp"),
          (c64, 3 ** 16, "split"), (c64, 1 << 25, "split"),
          (c64, 1 << 30, "split"), (c64, 8388609, "chirp"),
          (c64, (1 << 24) + 43, "chirp"), (c64, 17 << 21, "split"),
          (c128, (1 << 21) + 1, "chirp"), (c128, 1 << 23, "split"),
          (c128, 1 << 30, "split"), (c128, 2097169, "chirp"),
          (c128, (1 << 22) + 15, "chirp"), (c128, 5 ** 10, "split")]


@pytest.mark.parametrize("dtype,n,route", RAISED)
def test_lengths_that_raised_take_a_route(dtype, n, route):
    """``radix.kernel_path`` and the plans answer without raising where
    ``launch_config`` raised before (the primes just past each old limit
    among them): a nested plan whose rows run on a route of their own
    (one level down on the split route at 2^30), or the chirp, whose M is
    13-smooth, from 2N - 1 to twice that, within the line index."""
    assert radix.kernel_path(n, dtype) == route
    if route == "split":
        plan = split.split_plan(n, dtype)
        assert plan.row_path == "any" and plan.p * plan.q == n
        assert plan.q <= split.LIMIT[dtype]
        assert split.row_route(plan.q, dtype) == radix.kernel_path(
            plan.q, dtype) != "chirp"
        assert split.column_tile(plan, dtype).smem_bytes \
            <= radix.SMEM_MAX_BYTES
        return
    plan = chirp.chirp_plan(n, dtype)
    assert 2 * n - 1 <= plan.m <= 2 * (2 * n - 1) <= split.LINE_MAX
    assert radix.smooth(plan.m) and plan.route == "split"
    sp = plan.split
    assert sp.col_path == "dense" and sp.row_path == "any"
    assert sp.p * sp.q == plan.m and sp.q <= split.LIMIT[dtype]
    assert radix.kernel_path(sp.q, dtype) in ("radix", "long", "dense",
                                              "split")


@pytest.mark.parametrize("dtype", [c64, c128])
def test_a_sample_past_the_old_limits_takes_a_route(dtype):
    """A seeded sample of 1000 lengths in (the chirp's old limit, 2^30]
    (10^4 a dtype answered too, PERF.md §6) takes the split or the chirp
    route, but for the band below 2^30 whose M would pass 2^31 - 1
    (``chirp.max_chirp_length``), which stays "dense" and raises."""
    gen = random.Random(33 + dtype.itemsize)
    top = chirp.max_chirp_length()
    assert top < split.MAX_LENGTH and 2 * top - 1 <= split.LINE_MAX
    for _ in range(1000):
        n = gen.randint(OLD_CHIRP[dtype] + 1, split.MAX_LENGTH)
        path = radix.kernel_path(n, dtype)
        if n <= top:
            assert path in ("split", "chirp"), (n, path)
        else:
            assert path in ("split", "dense"), (n, path)
        if path == "split":
            assert split.split_plan(n, dtype).p > 1
        elif path == "chirp":
            assert chirp.chirp_plan(n, dtype).m <= split.LINE_MAX


@pytest.mark.parametrize("dtype", [c64, c128])
def test_message_past_the_domain_names_the_line_index(dtype):
    """Past 2^30, and in the band below it where no 13-smooth plan takes
    N and its M would pass 2^31 - 1, ``launch_config`` raises naming the
    kernels' 32-bit line index; the plans answer None there."""
    for n in (split.MAX_LENGTH + 1, chirp.max_chirp_length() + 2):
        if radix.smooth(n):
            continue
        assert radix.kernel_path(n, dtype) == "dense"
        assert split.nested_factors(n, dtype) is None
        assert chirp.chirp_plan(n, dtype) is None or n > split.MAX_LENGTH
        with pytest.raises(ValueError, match="32-bit ints"):
            tfm.launch_config(n, dtype.itemsize)


@pytest.mark.parametrize("dtype", [c64, c128])
def test_nested_rule_prefers_a_radix_pass_a_then_rows_of_one_block(dtype):
    """``nested_factors`` takes a radix pass A where N has a P of
    ``COLUMN_SIZES`` (c64 2^25: 512 x 65536, c128 2^23: 256 x 32768, rows
    on the split route one level down; P nearest ``split.NESTED_P``), else
    rows on a route of one block (c64 3^16: 2187 x 19683 on the dense
    route, c128 3^15: 2187 x 6561; P nearest ``split.NESTED_ONE_P``), else
    rows on the split route (c128 2^30: rows of at most 2^22); lengths up
    to the old limit keep their plans (no nested plan there)."""
    n = 1 << 25 if dtype == c64 else 1 << 23
    assert split.nested_factors(n, dtype) == (
        (512, 65536, "radix") if dtype == c64 else (256, 32768, "radix"))
    p, q, col = split.nested_factors(3 ** 16 if dtype == c64 else 3 ** 15,
                                     dtype)
    assert split.row_route(q, dtype) != "split" and col == "dense"
    assert (p, q) == ((2187, 19683) if dtype == c64 else (2187, 6561))
    p, q, col = split.nested_factors(1 << 30, dtype)
    assert split.row_route(q, dtype) == "split"
    assert split.nested_factors(split.LIMIT[dtype], dtype) is None
    assert split.nested_factors(29106, dtype) is None
    for n in (1 << 24, 33792, 29106):
        if n <= split.LIMIT[dtype] and split.takes(n, dtype):
            assert split.split_plan(n, dtype).row_path != "any"
    assert dense.column_plan(1 << 20, dtype) is None


@pytest.mark.parametrize("dtype,n,m_limit", [(c64, 1000, 64),
                                             (c128, 700, 40)])
def test_chirp_on_a_forced_split_plan_of_m(dtype, n, m_limit):
    """The chirp's folded load and store on a split plan of M (pass A
    reads the N-long lines times the chirp, zeros past N; pass C keeps the
    first N in the ``pack_parts`` segments), M forced to the least
    13-smooth length >= 2N - 1 with rows of at most ``m_limit``, both
    directions with the twiddle, against np.fft; the dense route's M of
    the same N gives the same result."""
    m = next(k for k in range(2 * n - 1, 4 * n) if radix.smooth(k))
    p, q, col = split.any_factors(m, dtype, limit=m_limit, dense_only=True)
    assert col == "dense" and q <= m_limit
    plan = chirp.ChirpPlan(n, m, "split", split.SplitPlan(m, p, q, "any",
                                                          col))
    r = np.random.default_rng(n)
    x = (r.standard_normal((3, n)) + 1j * r.standard_normal((3, n))
         ).astype(NP[dtype])
    t = np.exp(-1j * np.pi * np.arange(n) / (2 * n)).astype(NP[dtype])
    for inv in (False, True):
        want = (np.fft.ifft if inv else np.fft.fft)(
            x.astype(np.complex128), axis=-1) * t
        xt, tt = torch.from_numpy(x), torch.from_numpy(t)
        got = chirp.emulate(xt, plan=plan, inverse=inv, twiddle=tt,
                            pack_parts=4)
        assert tuple(got.shape) == (4, 3, n // 4)
        got = got.transpose(0, 1).reshape(3, n).numpy()
        assert_scaled_close(got, want, TOL[dtype])
        on_dense = chirp.emulate(xt, plan=chirp.ChirpPlan(n, m, "dense"),
                                 inverse=inv, twiddle=tt).numpy()
        assert_scaled_close(on_dense, want, TOL[dtype])
