"""The split route's general plans (``kernels/split.py``:
``general_factors``): every 13-smooth N past one block up to 2^24
(complex64) / 2^22 (complex128) that no other route takes, as N = P*Q with
pass A on the radix route at a P of ``split.COLUMN_SIZES`` or on the dense
kernel's column form of any P (``dense_column_kernel``, the inter-step
twiddle from two tables), and pass B on the dense route's stages on the
rows of Q, stored transposed through a thread-block cluster with the
line's epilogues and the inverse's 1/N (``split_fold_dense_kernel``;
``tests/test_torch_split_fold_fft.py`` holds its cluster map).
General lengths and forced small plans through the route's plain version
(``split.emulate``, which the wrapper runs on CPU tensors) against
``np.fft`` and the JAX package's Pallas kernel in interpret mode on the
same numpy inputs (both directions, the twiddle and ``pack_parts``
epilogues) at the reference's tolerances (``tests/test_kernels.py:27``:
5e-6 max-scaled in complex64, 1e-12 in complex128); then every general
length's plan against the tiles, and the routes that keep their lengths.
The CUDA kernels are tested in ``test_torch_cuda.py`` and
``chip_smoke.py``."""
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
#: (dtype, N, plan): general lengths with the plan the rule gives them
#: (None) and forced small plans (P, Q, pass A's route): an odd P with an
#: odd Q, a power-of-two P with an odd Q on the radix pass A, an odd P
#: with an even Q.  complex64 29106 = 2*3^3*7^2*11, 30976 = 256 x 121
#: (a radix pass A), the odd 33075, 44100; complex128 14406 = 2*3*7^4.
LENGTHS = [(c64, 29106, None), (c64, 30976, None), (c64, 33075, None),
           (c64, 44100, None), (c128, 14406, None),
           (c64, 315, (15, 21, "dense")), (c64, 2240, (64, 35, "radix")),
           (c64, 630, (45, 14, "dense")), (c128, 315, (15, 21, "dense")),
           (c128, 2240, (64, 35, "radix")), (c128, 630, (45, 14, "dense"))]
#: (inverse, twiddle, pack_parts): forward alone, and the inverse with
#: the twiddle and segments of N/r, r the least odd prime factor of N.
VARIANTS = [(False, False, None), (True, True, "odd")]
CASES = [(dtype, n, plan, inv, tw,
          next(r for r in (3, 5, 7, 11, 13) if n % r == 0)
          if parts == "odd" else parts)
         for dtype, n, plan in LENGTHS for inv, tw, parts in VARIANTS]
#: The general rule's lengths per dtype: (all, past the chirp route's
#: limit before its M could take any route length, which raised before).
COUNTS = {c64: (7974, 1673), c128: (5216, 1187)}
#: That limit: half the split route's longest power of two.
CHIRP_LIMIT_BEFORE = {c64: 1 << 23, c128: 1 << 21}


def _case_id(case):
    dtype, n, plan, inv, tw, parts = case
    forced = "" if plan is None else f"-{plan[0]}x{plan[1]}{plan[2]}"
    return (f"{str(dtype).removeprefix('torch.')}-{n}{forced}-"
            f"{'inv' if inv else 'fwd'}-tw{int(tw)}-p{parts}")


def _inputs(case):
    dtype, n, plan, inv, tw, parts = case
    r = np.random.default_rng(n + int(inv) + 10 * int(tw))
    x = (r.standard_normal((2, n)) + 1j * r.standard_normal((2, n))
         ).astype(NP[dtype])
    t = np.exp(-1j * np.pi * np.arange(n) / (2 * n)).astype(NP[dtype]) \
        if tw else None
    return x, t


def _numpy_ref(case, x, t):
    dtype, n, plan, inv, tw, parts = case
    y = (np.fft.ifft if inv else np.fft.fft)(x.astype(np.complex128),
                                             axis=-1)
    if t is not None:
        y = t * y
    return y if parts is None else y.reshape(2, parts, n // parts)


@pytest.fixture(scope="module")
def pallas_c128(tmp_path_factory):
    """The Pallas kernel's complex128 results (interpret mode under
    ``jax_enable_x64``, every case in one fresh process)."""
    cases = {}
    for case in CASES:
        if case[0] == c128:
            x, t = _inputs(case)
            cases[_case_id(case).replace("-", "_")] = (x, t, case[3],
                                                       case[5])
    return pallas_lines_c128(cases,
                             str(tmp_path_factory.mktemp("general_x64")))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_general_plans_match_numpy_and_pallas(case, request):
    """A general length through the wrapper on CPU tensors (the route
    ``radix.kernel_path`` names, ``split.emulate``; no launch counted, no
    line copied), or a forced plan through ``split.emulate_plan``, against
    np.fft and the Pallas kernel on the same inputs."""
    dtype, n, plan, inv, tw, parts = case
    x, t = _inputs(case)
    tt = None if t is None else torch.from_numpy(t)
    if plan is None:
        assert radix.kernel_path(n, dtype) == "split"
        assert not chirp.takes(n, dtype)
        sp = split.split_plan(n, dtype)
        assert (sp.p, sp.q, sp.col_path) == split.general_factors(n, dtype)
        assert sp.row_path == "dense"
        tfm.reset_launch_counts()
        ops.copies["lines"] = 0
        got = tfm.fft_fourstep(torch.from_numpy(x), inverse=inv,
                               twiddle=tt, pack_parts=parts)
        assert tfm.launch_counts()["launches"] == 0
        assert ops.copies["lines"] == 0
    else:
        p, q, col = plan
        assert p * q == n
        buf = split.emulate_plan(torch.from_numpy(x), split.SplitPlan(
            n, p, q, "dense", col), inverse=inv, twiddle=tt,
            pack_parts=parts)
        got = buf if parts is None else buf.transpose(0, 1)
    assert got.dtype == dtype
    got = got.numpy()
    assert_scaled_close(got, _numpy_ref(case, x, t), TOL[dtype])
    if dtype == c64:
        twp = None if t is None else (jnp.asarray(t.real),
                                      jnp.asarray(t.imag))
        yr, yi = jfm.fft1d_planes(jnp.asarray(x.real), jnp.asarray(x.imag),
                                  inverse=inv, twiddle=twp, pack_parts=parts,
                                  interpret=True)
        assert yr.dtype == jnp.float32
        pallas = np.asarray(yr) + 1j * np.asarray(yi)
    else:
        pallas = request.getfixturevalue("pallas_c128")[
            _case_id(case).replace("-", "_")]
    assert pallas.dtype == NP[dtype]
    assert_scaled_close(got, pallas, TOL[dtype])


def _smooth_upto(limit: int) -> list:
    """Every 13-smooth number up to ``limit``, ascending, as products."""
    out = [1]
    for p in (2, 3, 5, 7, 11, 13):
        grown = []
        for d in out:
            while d <= limit:
                grown.append(d)
                d *= p
        out = grown
    return sorted(out)


@pytest.mark.parametrize("dtype", [c64, c128])
def test_every_smooth_line_past_one_block_has_a_general_plan(dtype):
    """Every 13-smooth N past one block up to ``split.LIMIT`` that the
    radix, long-line and split routes' tables and the dense route do not
    take is a general length (:data:`COUNTS`): N = P*Q on the split
    route, pass A's tile within one block's shared memory (the strided
    radix tile of a P of ``COLUMN_SIZES`` with its inter-step tables
    within ``split.TABLE_MAX_BYTES``, or the dense kernel's column tile
    of 16, 8 or 4 columns, its lines an odd pitch apart), pass B's row
    of Q and its tables in one block, 2 launches on the card (3 where a
    row and the cluster's tile do not fit one block); none is
    left to the chirp, and no 13-smooth length raises."""
    taken = (set(radix.RADIX_SIZES[dtype]) | set(longline.FACTORS[dtype])
             | set(split.FACTORS[dtype]))
    general = past = 0
    for n in _smooth_upto(split.LIMIT[dtype]):
        if n in taken or dense.takes(n, dtype):
            assert split.general_factors(n, dtype) is None
            continue
        p, q, col = split.general_factors(n, dtype)
        general += 1
        past += n > CHIRP_LIMIT_BEFORE[dtype]
        assert p * q == n and not chirp.takes(n, dtype)
        assert radix.kernel_path(n, dtype) == "split"
        plan = split.split_plan(n, dtype)
        if col == "radix":
            assert p in split.COLUMN_SIZES[dtype]
            assert plan.const_elems * dtype.itemsize \
                <= split.TABLE_MAX_BYTES
            assert split.column_tile(plan, dtype).smem_bytes \
                <= radix.SMEM_MAX_BYTES
        else:
            tile = split.column_tile(plan, dtype)
            assert tile.lines in dense.COLUMN_LINES
            assert tile.line_pitch % 2 == 1 and tile.line_pitch - p <= 1
            assert tile.smem_bytes <= radix.SMEM_MAX_BYTES
        rows = split.fold_layout(plan, dtype) or dense.dense_plan(q, dtype)
        assert rows.smem_bytes <= radix.SMEM_MAX_BYTES
    assert (general, past) == COUNTS[dtype]


@pytest.mark.parametrize("dtype", [c64, c128])
def test_the_routes_keep_their_lengths(dtype):
    """The radix route's lengths (``RADIX_SIZES``), the long-line route's
    (``longline.FACTORS``) and the split route's table and rule
    (``split.FACTORS``) keep their route and (P, Q), with pass A on the
    radix route and pass B on the row route they had; the general rule
    takes none of them; the primes past the chirp's old limit, complex64
    8388617 and complex128 2097169, which raised, take the chirp (M on a
    split plan), and only N past the kernels' 32-bit line index raise
    (``launch_config`` says so)."""
    for n in radix.RADIX_SIZES[dtype]:      # the wide lines: the long route
        assert radix.kernel_path(n, dtype) == (
            "long" if n in longline.WIDE[dtype] else "radix")
    for n in longline.FACTORS[dtype]:
        assert radix.kernel_path(n, dtype) == "long"
    for n, (p, q) in split.FACTORS[dtype].items():
        assert radix.kernel_path(n, dtype) == "split"
        plan = split.split_plan(n, dtype)
        assert (plan.p, plan.q, plan.col_path) == (p, q, "radix")
        assert plan.row_path == ("long" if q in longline.FACTORS[dtype]
                                 else "radix")
    for n in (*radix.RADIX_SIZES[dtype], *longline.FACTORS[dtype],
              *split.FACTORS[dtype]):
        assert split.general_factors(n, dtype) is None
    prime = 8388617 if dtype == c64 else 2097169
    assert prime > CHIRP_LIMIT_BEFORE[dtype]
    assert radix.kernel_path(prime, dtype) == "chirp"
    assert chirp.chirp_plan(prime, dtype).route == "split"
    past = split.MAX_LENGTH + 1
    assert radix.kernel_path(past, dtype) == "dense"
    with pytest.raises(ValueError, match="32-bit ints"):
        tfm.launch_config(past, dtype.itemsize)
