"""The wide lines of B1 (``longline.WIDE``: the radix route's lengths with a
factor past 32 values in complex64, 16 in complex128) on the long route's
tile kernel (``csrc/fft_wide.cuh``): the plan's tile loop, run in torch by
``longline.emulate`` (the kernel's plain version, which the wrapper runs
for CPU tensors), held against ``np.fft`` and against the JAX package's
Pallas kernel in interpret mode on the same numpy inputs — complex64 1000,
1800, 2944 and 4096 and complex128 864, both directions, the twiddle and
``pack_parts`` epilogues, batches that leave a ragged last tile — at the
reference's tolerances (``tests/test_kernels.py:27``: 5e-6 max-scaled in
complex64, 1e-12 in complex128).  Then the rule's plans, the CUDA
dispatch's cases, and what must not move with these lengths: the split
route's rows and plans, the strided entry, the other routes' answers.
The CUDA kernel itself is tested in ``test_torch_cuda.py`` and
``chip_smoke.py``."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft_matmul as jfm
from repro_torch.core.transforms import factorize
from repro_torch.kernels import (chirp, dense, longline, ops, radix, split)
from repro_torch.kernels import fft_matmul as tfm
from torch_harness import assert_scaled_close, pallas_lines_c128

TOL = {torch.complex64: 5e-6, torch.complex128: 1e-12}
NP = {torch.complex64: np.complex64, torch.complex128: np.complex128}
C64, C128 = torch.complex64, torch.complex128


def _variants(dtype, n):
    """(batch, inverse, twiddle, pack_parts): one line past a whole tile
    forward, two tiles and one line inverse with both epilogues (a ragged
    last tile where the tile holds more than one line: complex64 1000,
    complex128 864)."""
    lt = longline.long_plan(n, dtype).lt
    return [(lt + 1, False, True, None), (2 * lt + 1, True, True, 4)]


CASES = [(dtype, n, *v) for dtype, n in ((C64, 1000), (C64, 1800),
                                         (C64, 2944), (C64, 4096),
                                         (C128, 864))
         for v in _variants(dtype, n)]


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


@pytest.fixture(scope="module")
def pallas_c128(tmp_path_factory):
    """The Pallas kernel's complex128 results (interpret mode under
    ``jax_enable_x64``, one fresh process for every case)."""
    cases = {}
    for case in CASES:
        if case[0] == C128:
            x, t = _inputs(case)
            cases[_case_id(case).replace("-", "_")] = (x, t, case[3],
                                                       case[5])
    return pallas_lines_c128(cases, str(tmp_path_factory.mktemp("wide_x64")))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_wide_tile_matches_numpy_and_pallas(case, request):
    """The tile loop's plain version, through the wrapper on CPU tensors
    (no launch), against np.fft and the Pallas kernel on the same
    inputs; the buffer is what the kernel writes, destination-major with
    ``pack_parts``."""
    dtype, n, b, inv, tw, parts = case
    assert radix.kernel_path(n, dtype) == "long"
    plan = longline.long_plan(n, dtype)
    assert isinstance(plan, longline.WidePlan)
    assert b % plan.lt or plan.lt == 1
    assert plan.lt > 1 or n in (1800, 2944, 4096)
    x, t = _inputs(case)
    tfm.reset_launch_counts()
    got = tfm.fft_fourstep(torch.from_numpy(x), inverse=inv,
                           twiddle=None if t is None else torch.from_numpy(t),
                           pack_parts=parts)
    assert tfm.fft_fourstep.launches == 0
    assert got.dtype == dtype
    if parts is not None:
        assert tuple(got.shape) == (b, parts, n // parts)
        assert got.transpose(0, 1).is_contiguous()
    got = got.numpy().reshape(b, n)
    want = (np.fft.ifft if inv else np.fft.fft)(x.astype(np.complex128))
    if t is not None:
        want = want * t
    assert_scaled_close(got, want, TOL[dtype])
    if dtype == C64:
        twp = None if t is None else (jnp.asarray(t.real),
                                      jnp.asarray(t.imag))
        yr, yi = jfm.fft1d_planes(jnp.asarray(x.real), jnp.asarray(x.imag),
                                  inverse=inv, twiddle=twp, pack_parts=parts)
        pallas = np.asarray(yr) + 1j * np.asarray(yi)
    else:
        pallas = request.getfixturevalue("pallas_c128")[
            _case_id(case).replace("-", "_")]
    assert_scaled_close(got, pallas.reshape(b, n), TOL[dtype])


@pytest.mark.parametrize("dtype,n", [(C64, 2944), (C64, 1000),
                                     (C128, 736), (C128, 900)])
def test_every_candidate_tile_computes_the_same_lines(dtype, n):
    """Every plan the rule ranks (``longline.wide_candidates``: splits,
    lines a tile) gives the rule's plan's output on a ragged
    batch: the tile changes the loop, not the transform."""
    plans = longline.wide_candidates(n, dtype)
    r = np.random.default_rng(n)
    b = 2 * max(p.lt for p in plans) + 1
    x = torch.from_numpy((r.standard_normal((b, n))
                          + 1j * r.standard_normal((b, n))).astype(NP[dtype]))
    want = longline.emulate(x, inverse=True)
    splits = {(p.r1, p.r2, p.r3) for p in plans}
    seen = set()
    for p in plans:
        if (p.r1, p.r2, p.r3, p.lt) in seen:
            continue
        seen.add((p.r1, p.r2, p.r3, p.lt))
        got = longline.emulate(x, inverse=True, plan=p)
        assert_scaled_close(got.numpy(), want.numpy(), TOL[dtype])
    assert len(splits) > 1


@pytest.mark.parametrize("dtype", [C64, C128])
def test_every_wide_length_has_its_plan(dtype):
    """Every radix length whose larger factor passes ``WIDE_FROM`` and
    that has a wide plan (three codelets of at most 32 values, rows of
    ``WIDE_ROW_MIN_BYTES``, a line of ``WIDE_LINE_MIN_BYTES``) is a wide
    line, and nothing else: R3 a power of two to 16, R1 and R2 codelet
    lengths to 32, its plan the rule's first (``wide_candidates``), the
    ring within one block's 227 KB, the SM holding the blocks its
    registers allow, and ``kernel_path`` "long"; the rest, and the lines
    ``WIDE_RADIX_KEEPS`` names, keep the radix route."""
    cap, wide = longline.WIDE_FROM[dtype], longline.WIDE[dtype]
    moved = []
    for n in radix.RADIX_SIZES[dtype]:
        if max(factorize(n)) <= cap \
                or not longline.wide_candidates(n, dtype) \
                or n in longline.WIDE_RADIX_KEEPS[dtype]:
            assert n not in wide and radix.kernel_path(n, dtype) == "radix"
            continue
        moved.append(n)
        r1, r2, r3, lt = wide[n]
        plan = longline.long_plan(n, dtype)
        threads = plan.threads
        assert plan == longline.wide_candidates(n, dtype)[0]
        assert (plan.r1, plan.r2, plan.r3, plan.lt) == wide[n]
        assert r1 * r2 * r3 == n and radix.is_pow2(r3) and 2 <= r3 <= 16
        assert all(2 <= r <= 32 and radix.codelet_length(r)
                   for r in (r1, r2)) and r1 >= r2
        assert r2 * r3 * dtype.itemsize >= longline.WIDE_ROW_MIN_BYTES
        assert n * dtype.itemsize >= longline.WIDE_LINE_MIN_BYTES
        assert threads == longline.WIDE_THREADS
        assert plan.smem_bytes <= radix.SMEM_MAX_BYTES
        assert longline.long_tile(n, dtype).smem_bytes == plan.smem_bytes
        regs = 128 if dtype == C64 else 255
        assert plan.min_blocks == min(65536 // (threads * regs),
                                      233472 // (plan.smem_bytes + 1024))
        assert lt == 1 or plan.min_blocks == 65536 // (threads * regs)
        assert radix.kernel_path(n, dtype) == "long"
    assert moved == sorted(wide)
    assert len(moved) == {C64: 111, C128: 54}[dtype]
    assert {C64: 4096, C128: 1024}[dtype] in wide
    assert min(moved) == {C64: 792, C128: 384}[dtype]
    keeps = longline.WIDE_RADIX_KEEPS[dtype]
    assert all(max(factorize(n)) > cap and longline.wide_candidates(n, dtype)
               for n in keeps)


def _wide_cases():
    """``wide_part``'s switch cases: {dtype: {N: (R1, R2, R3, LT,
    blocks)}}."""
    csrc = Path(radix.__file__).resolve().parent.parent / "csrc"
    text = (csrc / "fft_wide.cuh").read_text()
    body = text[text.index("int wide_part("):]
    out, dtype = {}, C64
    for line in body.splitlines():
        if line.startswith("  } else {"):
            dtype = C128
        m = re.search(r"REPRO_WIDE_CASE\((\d+), (\d+), (\d+), (\d+), "
                      r"(\d+), (\d+)\)", line)
        if m:
            n, *rest = map(int, m.groups())
            assert n not in out.setdefault(dtype, {})
            out[dtype][n] = tuple(rest)
    return out


def test_cuda_dispatch_instantiates_the_wide_plans():
    """``wide_part`` instantiates every wide line with the plan's factors,
    lines a tile and launch bound, and nothing else (every wide block has
    ``kWideThreads`` = ``WIDE_THREADS`` threads)."""
    cases = _wide_cases()
    for dtype in (C64, C128):
        want = {}
        for n, (r1, r2, r3, lt) in longline.WIDE[dtype].items():
            p = longline.long_plan(n, dtype)
            want[n] = (r1, r2, r3, lt, p.min_blocks)
        assert cases[dtype] == want, dtype
    csrc = Path(radix.__file__).resolve().parent.parent / "csrc"
    m = re.search(r"constexpr int kWideThreads = (\d+);",
                  (csrc / "fft_wide.cuh").read_text())
    assert int(m.group(1)) == longline.WIDE_THREADS


#: Split plans whose Q has a factor past ``WIDE_FROM`` (most of them wide
#: lines), as the tree before the wide kernel planned them: (dtype, N, P,
#: Q, pass B's route).
SPLIT_SAMPLE = [
    (C64, 225792, 256, 882, "radix"), (C64, 552960, 512, 1080, "radix"),
    (C64, 743424, 512, 1452, "radix"), (C64, 788480, 512, 1540, "radix"),
    (C64, 1114112, 1024, 1088, "radix"), (C64, 1277952, 1024, 1248, "radix"),
    (C64, 1032192, 1024, 1008, "radix"), (C64, 860160, 512, 1680, "radix"),
    (C64, 1179648, 1024, 1152, "radix"),
    (C128, 16000, 64, 250, "radix"), (C128, 41472, 64, 648, "radix"),
    (C128, 67584, 128, 528, "radix"), (C128, 123904, 256, 484, "radix"),
    (C128, 150528, 256, 588, "radix"), (C128, 384000, 512, 750, "radix")]


@pytest.mark.parametrize("dtype", [C64, C128])
def test_split_rows_and_strided_entry_keep_the_radix_kernel(dtype):
    """The wide lines stay rows of the split route (``split.ROW_SIZES``,
    ``row_route``) and lengths of the strided entry on ``radix_kernel``
    (``strided_supported`` as the strided tile fits, no line copy); only
    contiguous lines take the wide kernel."""
    rows = split._radix_rows(dtype)
    for n in longline.WIDE[dtype]:
        assert n in radix.RADIX_SIZES[dtype]
        assert split.row_route(n, dtype) == "radix"
        assert tfm.strided_supported(n, dtype, False) == (
            radix.radix_tile(n, dtype.itemsize, False, True) is not None)
        assert (n in rows) == (n <= split.ROW_MAX[dtype])
    moved = 0
    for dt, n, p, q, row in SPLIT_SAMPLE:
        if dt == dtype:
            plan = split.split_plan(n, dtype)
            assert (plan.p, plan.q, plan.row_path) == (p, q, row)
            assert q in split.ROW_SIZES[dtype]
            assert max(factorize(q)) > longline.WIDE_FROM[dtype]
            moved += q in longline.WIDE[dtype]
    assert moved >= 4


def test_strided_axis_of_a_wide_length_takes_no_copy():
    """A wide length on a strided axis runs the strided entry (its plain
    version here), as the radix route's lengths do: no line copy."""
    n = 1000
    assert n in longline.WIDE[C64] and tfm.strided_supported(n, C64, False)
    r = np.random.default_rng(7)
    x = torch.from_numpy((r.standard_normal((2, n, 16))
                          + 1j * r.standard_normal((2, n, 16))
                          ).astype(np.complex64))
    ops.copies["lines"] = 0
    got = ops.fft1d(x, axis=1)
    assert ops.copies["lines"] == 0
    want = np.fft.fft(x.numpy().astype(np.complex128), axis=1)
    assert_scaled_close(got.numpy(), want, 2e-5)


def test_other_routes_keep_their_answers():
    """The wide lines move no length of the other routes: the long
    route's own table and rule (``longline.FACTORS``), the dense route's
    and the chirp's answers."""
    for dtype in (C64, C128):
        assert not set(longline.WIDE[dtype]) & set(longline.FACTORS[dtype])
        assert len(longline.FACTORS[dtype]) == {C64: 118, C128: 177}[dtype]
        for n in longline.WIDE[dtype]:
            assert not split.takes(n, dtype)
    assert radix.kernel_path(2730, C64) == "dense"
    assert dense.takes(2730, C64) and not chirp.takes(2730, C64)
    assert radix.kernel_path(4800, C64) == "long"
    assert chirp.chirp_plan(7424, C64).m == 16384
    assert chirp.chirp_plan(3712, C128).route == "long"


def test_line_transform_gradient_through_a_wide_length():
    """``LineTransform``'s backward runs the adjoint through the same
    route: the gradient of a real loss through a wide line's transform
    against torch.fft's."""
    n = 2944
    r = np.random.default_rng(3)
    x0 = (r.standard_normal((3, n)) + 1j * r.standard_normal((3, n))
          ).astype(np.complex64)
    w = torch.from_numpy(r.standard_normal((3, n)).astype(np.float32))
    x = torch.from_numpy(x0).requires_grad_(True)
    (ops.fft1d(x, axis=-1).real * w).sum().backward()
    y = torch.from_numpy(x0).requires_grad_(True)
    (torch.fft.fft(y).real * w).sum().backward()
    assert_scaled_close(x.grad.numpy(), y.grad.numpy(), 5e-5)
