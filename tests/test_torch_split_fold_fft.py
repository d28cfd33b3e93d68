"""The split route's pass B with pass C folded in (``kernels/split.py``:
``fold_layout``, ``fold_emulate``): rows on the dense route's stages
(``fft_dense.cuh``'s ``split_fold_dense_kernel``: the general plans, a
nested plan's or a chirp's M whose rows take the dense route) or on the
long-line route's (``fft_long.cuh``'s ``split_fold_long_kernel`` and
``split_fold_mixed_kernel``) are transformed by a thread-block cluster of
C blocks, L rows a block, and stored transposed at kp + P*kq in runs of
C*L outputs with the line's epilogues: two HBM passes where pass C made
three.
Forced small plans through the route's plain version
(``split.emulate_plan``, which runs the cluster's own map: the rows in the
order the kernels leave them in shared memory, which block stores which
kq, the masked rows of a ragged P) against ``np.fft`` and the JAX
package's Pallas kernel in interpret mode on the same numpy inputs (both
directions, the twiddle and ``pack_parts`` epilogues, the chirp's second
transform keeping the first N) at the reference's tolerances
(``tests/test_kernels.py:27``: 5e-6 max-scaled in complex64, 1e-12 in
complex128); then every general and long-row length's route, layout and
launches, and the kernel's switch of long rows against the table.  The
CUDA kernels are tested in ``test_torch_cuda.py`` and ``chip_smoke.py``."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft_matmul as jfm
from repro_torch.kernels import chirp, dense, longline, radix, split
from torch_harness import assert_scaled_close, pallas_lines_c128

TOL = {torch.complex64: 5e-6, torch.complex128: 1e-12}
NP = {torch.complex64: np.complex64, torch.complex128: np.complex128}
c64, c128 = torch.complex64, torch.complex128
#: (dtype, P, Q, row_path, what the layout must be: (C, L)): forced small
#: plans on each form of the folded pass B.  Dense rows: the in-block case
#: (Q = 77, 32 rows a block, no cluster, P = 30 ragged on it; complex128 Q
#: = 1250, 2 rows a block, P = 9), rows of one a block (Q = 2500: C = 8, P
#: = 21 ragged), clusters of blocks of two rows (complex64 Q = 1250: C =
#: 4, P = 10 ragged), a complex128 cluster of 2 (Q = 3645, P = 7); the
#: rows pushed into the owners' tiles wherever C > 1; long-line rows, P a
#: multiple of C (8 complex64, 2 complex128): a mixed Q (complex64 4352 =
#: 17 x 16 x 16, complex128 792 = 11 x 9 x 8, a mixed R2) and a power of
#: two (complex128 2048).
PLANS = [(c64, 30, 77, "dense", (1, 32)), (c64, 21, 2500, "dense", (8, 1)),
         (c64, 10, 1250, "dense", (4, 2)), (c128, 9, 1250, "dense", (1, 2)),
         (c128, 7, 3645, "dense", (2, 1)), (c64, 8, 4352, "long", (8, 1)),
         (c128, 4, 792, "long", (2, 1)), (c128, 8, 2048, "long", (2, 1))]
#: (batch, inverse, twiddle, pack_parts): forward alone, and the inverse
#: with the twiddle and segments of N/r, r the least prime factor of N.
VARIANTS = [(3, False, False, None), (2, True, True, "least")]
CASES = [(dtype, p, q, row, cl, b, inv, tw,
          next(r for r in (2, 3, 5, 7, 11, 13) if (p * q) % r == 0)
          if parts == "least" else parts)
         for dtype, p, q, row, cl in PLANS for b, inv, tw, parts in VARIANTS]


def _case_id(case):
    dtype, p, q, row, cl, b, inv, tw, parts = case
    return (f"{str(dtype).removeprefix('torch.')}-{p}x{q}{row}-b{b}-"
            f"{'inv' if inv else 'fwd'}-tw{int(tw)}-p{parts}")


def _inputs(case):
    dtype, p, q, row, cl, b, inv, tw, parts = case
    n = p * q
    r = np.random.default_rng(n + 10 * b + int(inv))
    x = (r.standard_normal((b, n)) + 1j * r.standard_normal((b, n))
         ).astype(NP[dtype])
    t = np.exp(-1j * np.pi * np.arange(n) / (2 * n)).astype(NP[dtype]) \
        if tw else None
    return x, t


def _numpy_ref(x, t, inv, parts):
    b, n = x.shape
    y = (np.fft.ifft if inv else np.fft.fft)(x.astype(np.complex128),
                                             axis=-1)
    if t is not None:
        y = t * y
    return y if parts is None else y.reshape(b, parts, n // parts)


def _pallas_c64(x, t, inv, parts):
    twp = None if t is None else (jnp.asarray(t.real), jnp.asarray(t.imag))
    yr, yi = jfm.fft1d_planes(jnp.asarray(x.real), jnp.asarray(x.imag),
                              inverse=inv, twiddle=twp, pack_parts=parts,
                              interpret=True)
    assert yr.dtype == jnp.float32
    return np.asarray(yr) + 1j * np.asarray(yi)


@pytest.fixture(scope="module")
def pallas_c128(tmp_path_factory):
    """The Pallas kernel's complex128 results (interpret mode under
    ``jax_enable_x64``, every case in one fresh process)."""
    cases = {}
    for case in CASES:
        if case[0] == c128:
            x, t = _inputs(case)
            cases[_case_id(case).replace("-", "_")] = (x, t, case[6],
                                                       case[8])
    return pallas_lines_c128(cases, str(tmp_path_factory.mktemp("fold_x64")))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_folded_row_pass_matches_numpy_and_pallas(case, request):
    """A forced plan whose pass B stores transposed through a cluster
    (``split.fold_layout``: the cluster and rows a block the case names,
    a ragged P where it does not divide into groups) through
    ``split.emulate_plan`` against np.fft and the Pallas kernel on the
    same inputs."""
    dtype, p, q, row, (c, lines), b, inv, tw, parts = case
    col = "radix" if row == "long" else "dense"
    plan = split.SplitPlan(p * q, p, q, row, col)
    layout = split.fold_layout(plan, dtype)
    assert (layout.rows, layout.cluster, layout.lines) == (row, c, lines)
    assert split.call_launches(plan, dtype) == 2
    assert (p % layout.group != 0) == (row == "dense")
    x, t = _inputs(case)
    buf = split.emulate_plan(torch.from_numpy(x), plan, inverse=inv,
                             twiddle=None if t is None else
                             torch.from_numpy(t), pack_parts=parts)
    got = (buf if parts is None else buf.transpose(0, 1)).numpy()
    assert got.dtype == NP[dtype]
    assert_scaled_close(got, _numpy_ref(x, t, inv, parts), TOL[dtype])
    if dtype == c64:
        pallas = _pallas_c64(x, t, inv, parts)
    else:
        pallas = request.getfixturevalue("pallas_c128")[
            _case_id(case).replace("-", "_")]
    assert pallas.dtype == NP[dtype]
    assert_scaled_close(got, pallas, TOL[dtype])


@pytest.mark.parametrize("p,q", [(30, 77), (21, 2500), (8, 4352)])
def test_every_output_is_stored_once_by_the_cluster_map(p, q):
    """The cluster's map (which block stores which kq of which row, the
    masked rows of a ragged P) writes every output index of every line
    exactly once: the rows staged as their own row and column numbers
    come back as kp + P*kq."""
    row = "long" if q in longline.FACTORS[c64] else "dense"
    plan = split.SplitPlan(p * q, p, q, row, "radix")
    layout = split.fold_layout(plan, c64)
    pos = (dense.staged(torch.zeros((1, q), dtype=c64), False)[1]
           if row == "dense" else split.fold_positions(q, c64))
    staged = torch.full((2, p, int(pos.max()) + 1), -1.0, dtype=c64)
    kp = torch.arange(p, dtype=torch.float32)[:, None]
    kq = torch.arange(q, dtype=torch.float32)[None, :]
    staged[:, :, pos] = torch.complex(kp + p * kq, kq * 0).to(c64)
    staged[1] += 1j
    out = split.fold_emulate(staged, pos, plan, layout)
    want = torch.arange(p * q, dtype=torch.float32).to(c64)
    assert torch.equal(out[0], want)
    assert torch.equal(out[1], want + 1j)


#: (dtype, N, M, P, Q): the chirp route over a forced split plan of M with
#: dense rows (``chirp.ChirpPlan``): its first transform's pass A reads the
#: input times the chirp, its second's folded pass B keeps the first N in
#: the ``pack_parts`` segments.  complex64 1009 on M = 2079 = 27 x 77 (the
#: in-block case, 32 rows a block), 4099 on M = 8505 = 3 x 2835 (a
#: cluster of 8, P = 3 ragged on it); complex128 1009 on 27 x 77.
CHIRPS = [(c64, 1009, 2079, 27, 77), (c64, 4099, 8505, 3, 2835),
          (c128, 1009, 2079, 27, 77)]


@pytest.mark.parametrize("dtype,n,m,p,q", CHIRPS)
@pytest.mark.parametrize("inv,tw,parts", [(False, True, None),
                                          (True, False, "least")])
def test_chirp_over_a_folded_split_plan_keeps_the_first_n(dtype, n, m, p, q,
                                                          inv, tw, parts):
    """``chirp.emulate`` over a forced split plan of M whose rows take the
    dense route: both transforms' pass B folded (``fold_layout`` not None:
    2 launches each, 4 a call where pass C made 6), the second keeping
    only the outputs of < N; against np.fft and, complex64, the Pallas
    kernel."""
    sp = split.SplitPlan(m, p, q, "any", "dense")
    assert split.row_route(q, dtype) == "dense"
    layout = split.fold_layout(sp, dtype)
    assert layout is not None and layout.rows == "dense"
    assert 2 * split.call_launches(sp, dtype) == 4
    parts = next(r for r in (2, 3, 5, 7, 11, 13) if n % r == 0) \
        if parts == "least" and any(n % r == 0 for r in (2, 3, 5)) else None
    r = np.random.default_rng(n + m)
    x = (r.standard_normal((2, n)) + 1j * r.standard_normal((2, n))
         ).astype(NP[dtype])
    t = np.exp(-1j * np.pi * np.arange(n) / (2 * n)).astype(NP[dtype]) \
        if tw else None
    buf = chirp.emulate(torch.from_numpy(x), inverse=inv,
                        twiddle=None if t is None else torch.from_numpy(t),
                        pack_parts=parts,
                        plan=chirp.ChirpPlan(n, m, "split", sp))
    got = (buf if parts is None else buf.transpose(0, 1)).numpy()
    assert_scaled_close(got, _numpy_ref(x, t, inv, parts), TOL[dtype])
    if dtype == c64:
        assert_scaled_close(got, _pallas_c64(x, t, inv, parts), TOL[dtype])


def _smooth_upto(limit: int) -> list:
    """Every 13-smooth number up to ``limit``, ascending."""
    out = [1]
    for f in (2, 3, 5, 7, 11, 13):
        grown = []
        for d in out:
            while d <= limit:
                grown.append(d)
                d *= f
        out = grown
    return sorted(out)


#: General lengths whose rows keep pass C: the rows of the least Q that
#: fits one block (every shorter Q leaves P without a column plan) too
#: long for a slot and the cluster's tile in one block.
KEEP_PASS_C = {c64: 67, c128: 111}


@pytest.mark.parametrize("dtype", [c64, c128])
def test_every_general_and_long_row_plan_runs_two_launches(dtype):
    """Every general length (``split.general_factors``) folds pass C into
    its dense rows where a row (a group of rows) and, in a cluster, the
    tile the cluster's rows are pushed into fit one block, and every length
    of ``split.FACTORS`` whose rows take the long-line route into its long
    rows: 2 launches a split call (``split.call_launches``); the cluster
    makes runs of ``FOLD_RUN_BYTES``, or the block's rows do; its blocks
    divide a long-row plan's P; the layout fits one block's shared memory
    and the long rows' is the long kernel's own.  The general plans whose
    rows and tile do not fit (:data:`KEEP_PASS_C`) keep pass C (row path
    "any", 3 launches).  The radix rows keep their own pass B (2
    launches, no folded layout)."""
    run = split.FOLD_RUN_BYTES["dense"][dtype] // dtype.itemsize
    general = kept = 0
    for n in _smooth_upto(split.LIMIT[dtype]):
        if split.general_factors(n, dtype) is None:
            continue
        general += 1
        plan = split.split_plan(n, dtype)
        layout = split.fold_layout(plan, dtype)
        rows = dense.dense_plan(plan.q, dtype)
        if layout is None:
            kept += 1
            assert plan.row_path == "any", n
            assert split.call_launches(plan, dtype) == 3
            cluster = max(1, run // rows.lines)
            assert cluster > 1 and split.dense_fold(
                split.SplitPlan(n, plan.p, plan.q, "dense", plan.col_path),
                dtype, cluster, 1) is None
            continue
        assert plan.row_path == "dense" and layout.rows == "dense", n
        assert split.call_launches(plan, dtype) == 2
        assert layout.lines == rows.lines and not rows.generic
        assert layout.group >= run or layout.cluster == 1
        assert layout.group == max(run, rows.lines)
        assert (layout.tile_pitch > 0) == (layout.cluster > 1)
        assert layout.slot_elems * dtype.itemsize \
            >= layout.lines * plan.q * dtype.itemsize + 16
        assert layout.smem_bytes <= radix.SMEM_MAX_BYTES
    assert general == {c64: 7974, c128: 5216}[dtype]
    assert kept == KEEP_PASS_C[dtype]
    for n, (p, q) in split.FACTORS[dtype].items():
        plan = split.split_plan(n, dtype)
        layout = split.fold_layout(plan, dtype)
        assert split.call_launches(plan, dtype) == 2
        if plan.row_path == "radix":
            assert layout is None
            continue
        assert q in split.FOLD_LONG_ROWS[dtype]
        assert (layout.rows, layout.cluster, layout.lines) == (
            "long", split.FOLD_RUN_BYTES["long"][dtype] // dtype.itemsize, 1)
        assert p % layout.cluster == 0
        assert layout.smem_bytes == longline.long_tile(q, dtype).smem_bytes


@pytest.mark.parametrize("dtype,n", [(c64, 3 ** 16), (c128, 3 ** 14 * 2),
                                     (c64, 1 << 25), (c128, 1 << 23)])
def test_nested_plans_fold_only_dense_rows(dtype, n):
    """A nested plan (``split.nested_factors``) folds pass C into its rows
    where they take the dense route and a row and the cluster's tile fit
    one block (complex128 3^14*2 = 1458 x 6561, a cluster of 2), and keeps
    pass C where they do not (complex64 3^16 = 2187 x 19683: a row of 154
    KB) or where they take the split route one level down (complex64
    2^25, complex128 2^23)."""
    plan = split.split_plan(n, dtype)
    assert plan.row_path == "any"
    layout = split.fold_layout(plan, dtype)
    if (dtype, n) == (c128, 3 ** 14 * 2):
        assert split.row_route(plan.q, dtype) == "dense"
        assert layout.cluster == 2 and layout.tile_pitch > 0
        assert split.call_launches(plan, dtype) == 2
    else:
        assert layout is None and split.call_launches(plan, dtype) == 3


def test_cuda_switch_instantiates_the_long_rows():
    """``fft_long.cuh``'s ``split_fold_part`` has one case per Q of
    ``split.FOLD_LONG_ROWS`` and dtype, with ``longline.FACTORS``'
    factors, on the power-of-two kernel exactly where Q is a power of
    two."""
    src = (Path(split.__file__).resolve().parent.parent / "csrc"
           / "fft_long.cuh").read_text()
    body = src[src.index("int split_fold_part(int q"):]
    body = body[body.index("{"):body.index("#endif")]
    c64_part, c128_part = body.split("} else {")
    for dtype, part in ((c64, c64_part), (c128, c128_part)):
        cases = re.findall(r"REPRO_SPLIT_FOLD(_MIXED)?_CASE\((\d+), (\d+), "
                           r"(\d+), (\d+)\)", part)
        got = {int(q): (int(a), int(b), int(c)) for _, q, a, b, c in cases}
        assert sorted(got) == list(split.FOLD_LONG_ROWS[dtype])
        for mixed, q, *_ in cases:
            assert (mixed == "") == radix.is_pow2(int(q))
            assert got[int(q)] == tuple(longline.FACTORS[dtype][int(q)])
