"""The split route of the four-step kernel (``kernels/split.py``): lines
longer than one block holds, N = P*Q in two passes through HBM (a strided
radix pass on the P-long columns with the inter-step twiddle, then the
Q-long rows on the radix or long-line route, stored transposed).  Its
plain version, ``split.emulate`` (the wrapper runs it for CPU tensors),
runs the kernels' passes and index maps in torch; it is held against
``np.fft`` and against the JAX package's Pallas kernel in interpret mode
on the same numpy inputs — complex64 N of 32768 and 65536, complex128 N
of 16384, both directions, the twiddle and ``pack_parts`` epilogues — at
the reference's tolerances (``tests/test_kernels.py:27``: 5e-6
max-scaled in complex64, 1e-12 in complex128).  Then the longest lengths
and the long-line row route against ``np.fft``, the plan's sizes and
constants, the routing through ``ops`` (any axis, the gradient) and
``fft_conv`` at S=16384 on the kernel backend against the reference's
mixer.  The CUDA kernels are tested in ``test_torch_cuda.py`` and
``chip_smoke.py``."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft_matmul as jfm
from repro_torch.kernels import fft_matmul as tfm
from repro_torch.kernels import longline, ops, radix, split
from torch_harness import assert_scaled_close, pallas_lines_c128

TOL = {torch.complex64: 5e-6, torch.complex128: 1e-12}
NP = {torch.complex64: np.complex64, torch.complex128: np.complex128}
#: (batch, inverse, twiddle, pack_parts) per length: 1 or 2 lines, both
#: directions, each epilogue.
VARIANTS = [(2, False, False, None), (1, True, True, None),
            (2, False, False, 2), (1, True, True, 4)]
LENGTHS = [(torch.complex64, 1 << 15), (torch.complex64, 1 << 16),
           (torch.complex128, 1 << 14)]
CASES = [(dtype, n, *v) for dtype, n in LENGTHS for v in VARIANTS]


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
                             str(tmp_path_factory.mktemp("split_x64")))


def _pallas_c64(case, x, t):
    dtype, n, b, inv, tw, parts = case
    twp = None if t is None else (jnp.asarray(t.real), jnp.asarray(t.imag))
    yr, yi = jfm.fft1d_planes(jnp.asarray(x.real), jnp.asarray(x.imag),
                              inverse=inv, twiddle=twp, pack_parts=parts)
    assert yr.dtype == jnp.float32
    return np.asarray(yr) + 1j * np.asarray(yi)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_split_plan_matches_numpy_and_pallas(case, request):
    """The route's plain version, through the wrapper on CPU tensors,
    against np.fft and the Pallas kernel on the same inputs."""
    dtype, n, b, inv, tw, parts = case
    assert radix.kernel_path(n, dtype) == "split"
    x, t = _inputs(case)
    tfm.reset_launch_counts()
    got = tfm.fft_fourstep(torch.from_numpy(x), inverse=inv,
                           twiddle=None if t is None else torch.from_numpy(t),
                           pack_parts=parts)
    assert tfm.launch_counts()["launches"] == 0
    assert tfm.launch_counts()["split_calls"] == 0
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
    (torch.complex64, 1 << 22),         # 512 x 8192
    (torch.complex64, 1 << 23),         # 512 x 16384
    (torch.complex128, 1 << 19),        # 64 x 8192
    (torch.complex128, 1 << 20),        # 128 x 8192
    (torch.complex128, 1 << 21)])       # 256 x 8192
@pytest.mark.parametrize("inverse,use_tw,parts", [(False, False, None),
                                                  (True, True, 4)])
def test_split_rows_on_either_route_match_numpy(dtype, n, inverse, use_tw,
                                                parts):
    """Pass B on the long-line route (``longline.emulate`` with the
    cluster's transposed store, ``split.fold_emulate``) at the table's
    lengths whose rows take it, one line, against np.fft with the
    epilogues."""
    plan = split.split_plan(n, dtype)
    assert plan.row_path == "long"
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


def test_wrapper_runs_the_emulation_on_cpu_tensors():
    """For a split N the CPU wrapper's result is ``split.emulate``'s, bit
    for bit; the counters stay at 0."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 1 << 15)).astype(np.complex64))
    tfm.reset_launch_counts()
    assert torch.equal(tfm.fft_fourstep(x, inverse=True),
                       split.emulate(x, inverse=True))
    packed = tfm.fft_fourstep(x, pack_parts=4)
    assert torch.equal(packed.transpose(0, 1), split.emulate(x, pack_parts=4))
    counts = tfm.launch_counts()
    assert counts["split_calls"] == 0 and counts["launches"] == 0
    assert tfm.fft_fourstep.path_launches == {"radix": 0, "dense": 0,
                                              "long": 0, "split": 0,
                                              "chirp": 0}


#: The power-of-two lengths (the mixed ones: test_torch_split_mixed_fft.py).
SPLIT_LENGTHS = [(d, n) for d, s in split.FACTORS.items() for n in s
                 if radix.is_pow2(n)]


@pytest.mark.parametrize("dtype,n", SPLIT_LENGTHS)
def test_split_plan_sizes_fit_the_tiles(dtype, n):
    """Every length of the table: P on the strided radix tile within one
    block's 227 KB, Q on the radix route's lines tile (whose L rows are
    consecutive kp of one line, so L divides P) or the long-line route's,
    both instantiated by the kernel, and no pass length instantiated that
    the table does not use; the twiddle tables far below N."""
    plan = split.split_plan(n, dtype)
    assert plan.p * plan.q == n and plan.p in split.COLUMN_SIZES[dtype]
    assert tfm.strided_supported(plan.p, dtype, False)
    ctile = split.column_tile(plan, dtype)
    assert ctile.strided and ctile.lines == radix.STRIDED_LINES
    assert ctile.smem_bytes <= radix.SMEM_MAX_BYTES
    assert plan.q % radix.STRIDED_LINES == 0    # no ragged column tile
    rtile = split.row_tile(plan, dtype)
    assert rtile.smem_bytes <= radix.SMEM_MAX_BYTES
    if plan.row_path == "radix":
        assert plan.q in split.ROW_SIZES[dtype]
        assert plan.q in radix.RADIX_SIZES[dtype]   # radix_kernel's row
        assert plan.p % rtile.lines == 0
    else:
        assert radix.kernel_path(plan.q, dtype) == "long"
    assert plan.ql * plan.qh == plan.q
    assert plan.const_elems <= 2 * plan.p * 2 * math.isqrt(plan.q)
    table = split.FACTORS[dtype].values()
    assert set(split.COLUMN_SIZES[dtype]) == {p for p, _ in table}
    assert set(split.ROW_SIZES[dtype]) == {
        q for _, q in table if q not in longline.FACTORS[dtype]}


@pytest.mark.parametrize("inverse", [False, True])
def test_split_constants_are_the_inter_step_twiddle(inverse):
    """TA[kp, q % QL] * TB[kp, q // QL] is W_N^(kp*q) for every (kp, q);
    the cached device copy is their cast."""
    dtype = torch.complex64
    plan = split.split_plan(1 << 16, dtype)
    c = split.constants(plan, inverse)
    assert c.dtype == np.complex128 and c.size == plan.const_elems
    ta = c[:plan.p * plan.ql].reshape(plan.p, plan.ql)
    tb = c[plan.p * plan.ql:].reshape(plan.p, plan.qh)
    q = np.arange(plan.q)
    full = ta[:, q % plan.ql] * tb[:, q // plan.ql]
    sign = 1.0 if inverse else -1.0
    kp = np.arange(plan.p)[:, None]
    np.testing.assert_allclose(
        full, np.exp(sign * 2j * np.pi * kp * q / plan.n), atol=1e-13)
    dev = tfm._split_constants(plan, inverse, dtype, torch.device("cpu"))
    assert torch.equal(dev, torch.from_numpy(c).to(dtype))
    assert tfm._split_constants(plan, inverse, dtype,
                                torch.device("cpu")) is dev


def test_split_plan_rejects_other_lengths_and_factors():
    """A length off the table is refused; a length on it gets the table's
    factors and no others (the plan takes no factors of its own); past
    the table's limit, 2^25 / 2^23 take nested plans, and past 2^30 the
    route refuses every length."""
    for n, dtype in ((16384, torch.complex64), ((1 << 30) * 2, torch.complex64),
                     (8192, torch.complex128), ((1 << 30) * 2, torch.complex128),
                     (20011, torch.complex64)):
        with pytest.raises(ValueError, match="split route takes N"):
            split.split_plan(n, dtype)
    for dtype, table in split.FACTORS.items():
        for n, (p, q) in table.items():
            plan = split.split_plan(n, dtype)
            assert (plan.p, plan.q) == (p, q) and p * q == n


def test_split_lines_along_any_axis_and_their_gradient():
    """``ops.fft1d`` on a split N: contiguous lines in place, a strided
    axis copied contiguous first (``ops.copies``); the transform's
    gradient (``LineTransform``, unchanged: the adjoint runs on the same
    route) against ``torch.fft``'s, both directions."""
    n = 1 << 15
    r = np.random.default_rng(4)
    x = (r.standard_normal((2, n, 3)) + 1j * r.standard_normal(
        (2, n, 3))).astype(np.complex64)
    ops.copies["lines"] = 0
    got = ops.fft1d(torch.from_numpy(x), 1)
    assert ops.copies["lines"] == 1
    assert_scaled_close(got.numpy(), np.fft.fft(x, axis=1), 5e-6)
    got = ops.ifft1d(torch.from_numpy(x), -2)
    assert ops.copies["lines"] == 2
    assert_scaled_close(got.numpy(), np.fft.ifft(x, axis=1), 5e-6)
    lines = torch.from_numpy(np.ascontiguousarray(x[:, :, 0]))
    got = ops.ifft1d(lines, -1)
    assert ops.copies["lines"] == 2
    assert_scaled_close(got.numpy(), np.fft.ifft(x[:, :, 0], axis=-1), 5e-6)
    g = torch.from_numpy(r.standard_normal((2, n)).astype(np.complex64))
    for fns in ((ops.fft1d, torch.fft.fft), (ops.ifft1d, torch.fft.ifft)):
        grads = []
        for fn in fns:
            xx = lines.clone().requires_grad_(True)
            (fn(xx) * g).real.sum().backward()
            grads.append(xx.grad.numpy())
        assert_scaled_close(grads[0], grads[1], 5e-6)


def test_fft_conv_at_16384_takes_the_split_route_and_matches_reference():
    """``fft_conv`` at S=16384 (lines of 32768, the split route) with 8
    channels on the kernel backend's plain version against the
    reference's mixer, float32."""
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
    s = 16384
    assert radix.kernel_path(2 * s, torch.complex64) == "split"
    x = randn((1, s, cfg.d_model), 10)
    y_ref, _ = ref_ssm.fft_conv(ref_p, cfg, MeshRules(), jnp.asarray(x))
    tfm.reset_launch_counts()
    y, _ = ssm.fft_conv(p, cfg, None, tt(x), fft_backend="kernel")
    assert tfm.launch_counts()["split_calls"] == 0   # plain version on CPU
    assert scaled_err(y, y_ref) < F32_TOL
