"""The long-line path of the four-step kernel (``kernels/longline.py``,
``csrc/fft_long.cuh``): its three-pass plan and index maps, run in torch by
``longline.emulate`` (the kernel's plain version, which the wrapper runs
for CPU tensors), held against ``np.fft`` and against the JAX package's
Pallas kernel in interpret mode on the same numpy inputs — complex64 N of
8192 and 16384, complex128 N of 2048, 4096 and 8192, both directions, the
twiddle and ``pack_parts`` epilogues — at the reference's tolerances
(``tests/test_kernels.py:27``: 5e-6 max-scaled in complex64, 1e-12 in
complex128).  Then the plan's sizing and constants, the routing through
``ops``, and ``fft_conv`` at S=4096 on the kernel backend against the
reference's mixer.  The CUDA kernel itself is tested in
``test_torch_cuda.py`` and ``chip_smoke.py``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft_matmul as jfm
from repro_torch.kernels import fft_matmul as tfm
from repro_torch.kernels import longline, ops, radix
from torch_harness import assert_scaled_close, pallas_lines_c128

TOL = {torch.complex64: 5e-6, torch.complex128: 1e-12}
NP = {torch.complex64: np.complex64, torch.complex128: np.complex128}
#: (batch, inverse, twiddle, pack_parts) per length: ragged batches of 1
#: to 3 lines, both directions, each epilogue.
VARIANTS = [(3, False, False, None), (1, True, True, None),
            (2, False, False, 2), (3, True, True, 4)]
#: The power-of-two lengths (the mixed ones: test_torch_long_mixed_fft.py).
POW2 = [(dtype, n) for dtype, sizes in longline.FACTORS.items()
        for n in sizes if radix.is_pow2(n)]
CASES = [(dtype, n, *v) for dtype, n in POW2 for v in VARIANTS]


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
                             str(tmp_path_factory.mktemp("long_x64")))


def _pallas_c64(case, x, t):
    dtype, n, b, inv, tw, parts = case
    twp = None if t is None else (jnp.asarray(t.real), jnp.asarray(t.imag))
    yr, yi = jfm.fft1d_planes(jnp.asarray(x.real), jnp.asarray(x.imag),
                              inverse=inv, twiddle=twp, pack_parts=parts)
    assert yr.dtype == jnp.float32
    return np.asarray(yr) + 1j * np.asarray(yi)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_long_plan_matches_numpy_and_pallas(case, request):
    """The plan's plain version, through the wrapper on CPU tensors,
    against np.fft and the Pallas kernel on the same inputs."""
    dtype, n, b, inv, tw, parts = case
    assert radix.kernel_path(n, dtype) == "long"
    x, t = _inputs(case)
    tfm.reset_launch_counts()
    got = tfm.fft_fourstep(torch.from_numpy(x), inverse=inv,
                           twiddle=None if t is None else torch.from_numpy(t),
                           pack_parts=parts)
    assert tfm.fft_fourstep.launches == 0
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


def test_wrapper_runs_the_emulation_on_cpu_tensors():
    """For a long N the CPU wrapper's result is ``longline.emulate``'s,
    bit for bit; the counters stay at 0 with a "long" key."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 8192)).astype(np.complex64))
    tfm.reset_launch_counts()
    assert torch.equal(tfm.fft_fourstep(x, inverse=True),
                       longline.emulate(x, inverse=True))
    packed = tfm.fft_fourstep(x, pack_parts=4)
    assert torch.equal(packed.transpose(0, 1),
                       longline.emulate(x, pack_parts=4))
    assert tfm.fft_fourstep.path_launches == {"radix": 0, "dense": 0,
                                              "long": 0, "split": 0,
                                              "chirp": 0}


@pytest.mark.parametrize("dtype,n", POW2)
def test_long_plan_sizes_fit_a_block(dtype, n):
    """Three factors of at most 32 whose product is N, one RM-value item
    per thread, and a block within the 227 KB of shared memory: two line
    buffers where they fit, else one."""
    plan = longline.long_plan(n, dtype)
    assert plan.r1 * plan.r2 * plan.r3 == n
    assert all(r & (r - 1) == 0 and 2 <= r <= 32
               for r in (plan.r1, plan.r2, plan.r3))
    assert plan.threads * plan.rmax == n and plan.threads <= 1024
    assert plan.line_elems == n + plan.r3
    tile = longline.long_tile(n, dtype)
    item = dtype.itemsize
    assert tile.smem_bytes == longline.smem_bytes(plan, item, tile.depth)
    assert tile.smem_bytes <= radix.SMEM_MAX_BYTES
    two = longline.smem_bytes(plan, item, 2)
    assert tile.depth == (2 if two <= radix.SMEM_MAX_BYTES else 1)
    # line buffers and the constants keep 16-byte alignment (bulk copy)
    assert plan.line_elems * item % 16 == 0
    assert plan.const_elems * item % 16 == 0


@pytest.mark.parametrize("dtype,n,depth", [
    (torch.complex64, 8192, 2), (torch.complex64, 16384, 1),
    (torch.complex128, 2048, 2), (torch.complex128, 4096, 2),
    (torch.complex128, 8192, 1)])
def test_ring_depth_by_length(dtype, n, depth):
    """Two line buffers where two 64 KB-or-smaller lines fit in a block,
    one for the 128 KB lines (the kernel instantiates the same depths)."""
    assert longline.long_tile(n, dtype).depth == depth


@pytest.mark.parametrize("inverse", [False, True])
def test_long_constants_are_the_two_level_twiddles(inverse):
    """TA[k1, m3] * TB[k1, m2] is W_N^(k1*mb) for every pass-1 item
    mb = m2*R3 + m3, TC[k2, m3] is W_(R2*R3)^(k2*m3), W the codelet table;
    the cached device copy is their cast."""
    n, dtype = 16384, torch.complex64
    p = longline.long_plan(n, dtype)
    c = longline.constants(n, dtype, inverse)
    assert c.dtype == np.complex128 and c.size == p.const_elems
    ta, tb, tc, w = np.split(c, np.cumsum([p.r1 * p.r3, p.r1 * p.r2,
                                           p.r2 * p.r3]))
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
        w, np.exp(sign * 2j * np.pi * np.arange(p.rmax // 2) / p.rmax),
        atol=1e-15)
    dev = tfm._long_constants(n, inverse, dtype, torch.device("cpu"))
    assert dev.dtype == dtype
    assert torch.equal(dev, torch.from_numpy(c).to(dtype))
    assert tfm._long_constants(n, inverse, dtype, torch.device("cpu")) is dev


def test_long_plan_rejects_other_lengths():
    for n, dtype in ((1024, torch.complex64), (32768, torch.complex64),
                     (256, torch.complex128), (16384, torch.complex128),
                     (7424, torch.complex64)):
        with pytest.raises(ValueError, match="long route takes N"):
            longline.long_plan(n, dtype)


def test_long_lines_along_any_axis_and_their_gradient():
    """``ops.fft1d`` on a long N: contiguous lines in place, a strided axis
    copied contiguous first (``ops.copies``); the transform's gradient
    (``LineTransform``, the adjoint on the same path) against
    ``torch.fft``'s."""
    r = np.random.default_rng(4)
    x = (r.standard_normal((2, 8192, 3)) + 1j * r.standard_normal(
        (2, 8192, 3))).astype(np.complex64)
    ops.copies["lines"] = 0
    got = ops.fft1d(torch.from_numpy(x), 1)
    assert ops.copies["lines"] == 1
    assert_scaled_close(got.numpy(), np.fft.fft(x, axis=1), 5e-6)
    lines = torch.from_numpy(np.ascontiguousarray(x[:, :, 0]))
    got = ops.ifft1d(lines, -1)
    assert ops.copies["lines"] == 1
    assert_scaled_close(got.numpy(), np.fft.ifft(x[:, :, 0], axis=-1), 5e-6)
    g = torch.from_numpy(r.standard_normal((2, 8192)).astype(np.complex64))
    grads = []
    for fn in (ops.fft1d, torch.fft.fft):
        xx = lines.clone().requires_grad_(True)
        (fn(xx) * g).real.sum().backward()
        grads.append(xx.grad.numpy())
    assert_scaled_close(grads[0], grads[1], 5e-6)


def test_fft_conv_at_4096_takes_the_long_path_and_matches_reference():
    """``fft_conv`` at S=4096 (lines of 8192, the long path) on the kernel
    backend's plain version against the reference's mixer, float32."""
    from lm_parity import F32_TOL, f32, jax_init, port_module, randn, \
        scaled_err, tt
    from repro.configs import smoke_config as ref_smoke_config
    from repro.distributed.sharding import MeshRules
    from repro.models import ssm as ref_ssm
    from repro_torch.models import ssm

    cfg = f32(dataclasses.replace(ref_smoke_config("jamba_v0_1_52b"),
                                  ssm_impl="fft_conv"))
    tree, ref_p = jax_init(ref_ssm.init_fft_conv, cfg, "ssm", seed=2)
    p = port_module(ssm.init_fft_conv, tree, "ssm", cfg)
    s = 4096
    assert radix.kernel_path(2 * s, torch.complex64) == "long"
    x = randn((1, s, cfg.d_model), 9)
    y_ref, _ = ref_ssm.fft_conv(ref_p, cfg, MeshRules(), jnp.asarray(x))
    y, _ = ssm.fft_conv(p, cfg, None, tt(x), fft_backend="kernel")
    assert scaled_err(y, y_ref) < F32_TOL
