"""The chirp route of the four-step kernel (``kernels/chirp.py``): every
line length that no other route takes, as Bluestein's
convolution over two transforms of M, the cheapest 13-smooth length at
or above 2N - 1 (``chirp.chirp_plan``), on the dense route's kernel or a
split plan, the input read at pitch N times the chirp (zeros past N) by
the first transform's load, the filter and the output chirp in the
``twiddle`` epilogues, the first N kept by the second transform's store
in the ``pack_parts`` segments.  Its plain version, ``chirp.emulate``
(the wrapper runs it for CPU tensors), runs the same steps and index
maps over the inner routes' plain versions; it is held against
``np.fft`` (complex64 N of 101 and 10007, primes, M on the dense route's
kernel, and 4831, a prime, and 7424 = 29*256, M on the long-line route;
complex128 N of 3001 and 3712 = 29*128, M on the long-line route; both
directions, the twiddle and ``pack_parts``
epilogues; a forced split plan of M) and against the JAX package's
Pallas kernel in interpret mode on the same numpy inputs where the
reference factors N or its dense DFT matrix is small (101, 4831, 7424,
29106 and 3712), at the reference's
tolerances (``tests/test_kernels.py:27``: 5e-6 max-scaled in complex64,
1e-12 in complex128); so are 4864 = 19*256, 5888 = 23*256 and
complex128 2432 = 19*128 and 2944 = 23*128, which the chirp held until
the radix-19 and radix-23 codelets, on the long-line route now, and
33792 = 33*2^10, on the split route's rule now, and 29106 =
2*14553, on the split route's general plans now.
Then the chirp tables' phase at large N, the routing by length, the line
copies, the gradient, and ``fft_conv`` at S = 2432 (lines of 4864, the
long-line route now, the chirp before) and S = 2880 (lines of 5760 = 30
x 12 x 16, the long-line route since R2 may be mixed) forward and
backward against the reference's mixer.  The mixed lengths r*2^k, r in
``radix.EVERY_ROUTE_ODD`` = {3, 5, 7, 9, 11, 13, 15, 17, 19, 21, 23,
25, 27}, take the radix, long-line and split routes
(``test_torch_long_mixed_fft.py``, ``test_torch_split_mixed_fft.py``,
``test_torch_wide_fft.py``), and the other 13-smooth odd parts the radix
and long-line routes up to a 128 KB line and the dense route to one
block, so the chirp keeps the lengths whose generic stages cost the
dense route more (``dense.GENERIC_COST``) and, past the dense route's
old limit, any prime
factor from 17 that no codelet takes (since the split route's general
plans no 13-smooth length).
The CUDA launches are tested in ``test_torch_cuda.py`` and
``chip_smoke.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft_matmul as jfm
from repro_torch.kernels import chirp, dense, longline, ops, radix, split
from repro_torch.kernels import fft_matmul as tfm
from torch_harness import assert_scaled_close, pallas_lines_c128

TOL = {torch.complex64: 5e-6, torch.complex128: 1e-12}
NP = {torch.complex64: np.complex64, torch.complex128: np.complex128}
#: (batch, inverse, twiddle, pack_parts) per length: both directions,
#: each epilogue (pack_parts where 2 divides N).
VARIANTS = [(2, False, False, None), (1, True, True, None),
            (2, False, True, 2), (1, True, False, 2)]
LENGTHS = [(torch.complex64, 101), (torch.complex64, 4831),
           (torch.complex64, 4864), (torch.complex64, 10007),
           (torch.complex64, 33792), (torch.complex128, 3001),
           (torch.complex128, 2432), (torch.complex64, 5888),
           (torch.complex128, 2944), (torch.complex64, 7424),
           (torch.complex128, 3712), (torch.complex64, 29106)]
#: The lengths above that the chirp held until the radix-19 and radix-23
#: codelets moved them to the long-line route (19 x 16 x 16, 19 x 8 x 16,
#: 23 x 16 x 16 and 23 x 8 x 16) or the split route's rule did (33792 =
#: 256 x 132) or its general plans did (29106 = 882 x 33), where the
#: wrapper's plain version is ``longline.emulate`` or ``split.emulate``;
#: the rest stay here: 101 and 10007, M on the dense route's kernel, and
#: 4831, 7424 = 29*256 and complex128 3001 and 3712 = 29*128, M on the
#: long-line route.
ROUTE = {4864: "long", 2432: "long", 5888: "long", 2944: "long",
         33792: "split", 29106: "split"}
CASES = [(dtype, n, b, inv, tw, parts if n % 2 == 0 else None)
         for dtype, n in LENGTHS for b, inv, tw, parts in VARIANTS]
#: Where the reference's four-step factors N, or its one dense DFT
#: matrix at a prime N is small (101, 4831): 10007 x 10007 is too large
#: to run here, and at complex128 3001 its sums of 3001 terms differ from
#: np.fft by about 1e-12 themselves, so those are held to np.fft alone.
PALLAS = {101, 4831, 4864, 2432, 5888, 2944, 7424, 3712, 29106}


def _case_id(case):
    dtype, n, b, inv, tw, parts = case
    return (f"{str(dtype).removeprefix('torch.')}-{n}-b{b}-"
            f"{'inv' if inv else 'fwd'}-tw{int(tw)}-p{parts}")


def _inputs(case):
    dtype, n, b, inv, tw, parts = case
    r = np.random.default_rng(n + 10 * b + int(inv) + 100 * int(tw))
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
        if case[0] != torch.complex128 or case[1] not in PALLAS:
            continue
        x, t = _inputs(case)
        cases[_case_id(case).replace("-", "_")] = (x, t, case[3], case[5])
    return pallas_lines_c128(cases,
                             str(tmp_path_factory.mktemp("chirp_x64")))


def _pallas_c64(case, x, t):
    dtype, n, b, inv, tw, parts = case
    twp = None if t is None else (jnp.asarray(t.real), jnp.asarray(t.imag))
    yr, yi = jfm.fft1d_planes(jnp.asarray(x.real), jnp.asarray(x.imag),
                              inverse=inv, twiddle=twp, pack_parts=parts)
    assert yr.dtype == jnp.float32
    return np.asarray(yr) + 1j * np.asarray(yi)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_chirp_route_matches_numpy_and_pallas(case, request):
    """The route's plain version, through the wrapper on CPU tensors,
    against np.fft and (where it runs) the Pallas kernel on the same
    inputs; no launch is counted on the CPU and no line copied (the
    chirp's second transform stores the ``pack_parts`` segments)."""
    dtype, n, b, inv, tw, parts = case
    route = ROUTE.get(n, "chirp")
    assert radix.kernel_path(n, dtype) == route
    x, t = _inputs(case)
    tfm.reset_launch_counts()
    ops.copies["lines"] = 0
    got = tfm.fft_fourstep(torch.from_numpy(x), inverse=inv,
                           twiddle=None if t is None else torch.from_numpy(t),
                           pack_parts=parts)
    counts = tfm.launch_counts()
    assert counts["launches"] == 0 and counts["chirp_calls"] == 0
    assert ops.copies["lines"] == 0
    assert got.dtype == dtype
    want_shape = (b, n) if parts is None else (b, parts, n // parts)
    assert tuple(got.shape) == want_shape
    if parts is not None:       # destination-major (p, B, N/p) storage
        assert got.transpose(0, 1).is_contiguous()
    got = got.numpy()
    assert_scaled_close(got, _numpy_ref(case, x, t), TOL[dtype])
    if n not in PALLAS:
        return
    if dtype == torch.complex64:
        pallas = _pallas_c64(case, x, t)
    else:
        pallas = request.getfixturevalue("pallas_c128")[
            _case_id(case).replace("-", "_")]
    assert pallas.dtype == NP[dtype]
    assert_scaled_close(got, pallas, TOL[dtype])


@pytest.mark.parametrize("n", [2_097_143, 1_000_003, (1 << 20) + 7])
def test_chirp_tables_keep_the_phase_at_large_n(n):
    """The chirp's phase pi*k^2/N is reduced mod 2N in integers before it
    meets a float: the float64 table matches the exact phase at every k,
    and so does its complex64 cast, where a phase taken from k^2 in
    float32 is off by whole radians.  M is 13-smooth, from 2N - 1 to
    twice that; the output chirp is the input's (N values: the second
    transform keeps the first N)."""
    m = chirp.chirp_length(n)
    assert 2 * n - 1 <= m <= 2 * (2 * n - 1) and radix.smooth(m)
    pre, filt, post = chirp.constants(n, False, m)
    assert pre.shape == (n,) and filt.shape == (m,) and post.shape == (n,)
    k = np.array([0, 1, 2, n // 3, n // 2, n - 2, n - 1], dtype=np.int64)
    exact = np.array([complex(np.exp(-1j * np.pi * float(int(j) * int(j)
                                                       % (2 * n)) / n))
                      for j in k])
    assert np.abs(pre[k] - exact).max() < 1e-12
    assert np.abs(pre[k].astype(np.complex64) - exact).max() < 1e-6
    naive = np.exp(-1j * np.pi * k.astype(np.float32) ** 2
                   / np.float32(n)).astype(np.complex64)
    assert np.abs(naive - exact).max() > 1e-2
    assert np.allclose(np.abs(pre), 1.0, atol=1e-12)
    assert np.allclose(post, pre)
    inv_pre, _, inv_post = chirp.constants(n, True, m)
    assert np.allclose(inv_pre, np.conj(pre), atol=1e-12)
    assert np.allclose(inv_post, np.conj(pre) / n, atol=1e-12)


def test_chirp_filter_is_the_transformed_conjugate_chirp():
    n = 5000
    m = chirp.chirp_length(n)
    pre, filt, _ = chirp.constants(n, True, m)
    b = np.fft.ifft(filt)
    assert_scaled_close(b[:n], np.conj(pre), 1e-12)
    assert_scaled_close(b[m - n + 1:], np.conj(pre[1:])[::-1], 1e-12)
    assert np.abs(b[n:m - n + 1]).max() < 1e-12


@pytest.mark.parametrize("n,dtype,path", [
    (4835, torch.complex64, "chirp"), (4836, torch.complex64, "chirp"),
    (4480, torch.complex64, "long"), (5000, torch.complex64, "long"),
    (5760, torch.complex64, "long"), (10007, torch.complex64, "chirp"),
    (11520, torch.complex64, "long"), ((1 << 23) - 1, torch.complex64,
                                        "chirp"),
    (1 << 23, torch.complex64, "split"),
    ((1 << 23) + 1, torch.complex64, "chirp"),
    (2419, torch.complex128, "chirp"), (2420, torch.complex128, "dense"),
    (3001, torch.complex128, "chirp"), (5760, torch.complex128, "long"),
    (4864, torch.complex64, "long"), (23040, torch.complex64, "dense"),
    (5460, torch.complex64, "dense"), (2432, torch.complex128, "long"),
    (8448, torch.complex128, "dense"), (16896, torch.complex64, "dense"),
    (33792, torch.complex64, "split"), (2421, torch.complex128, "chirp"),
    (1 << 21, torch.complex128, "split"),
    ((1 << 21) + 1, torch.complex128, "chirp"),
    (4096, torch.complex64, "radix"), (3840, torch.complex64, "radix"),
    (4831, torch.complex64, "chirp"), (5888, torch.complex64, "long"),
    (2944, torch.complex128, "long"), (521, torch.complex64, "chirp"),
    (816, torch.complex64, "dense"), (19 << 19, torch.complex64, "split"),
    (7424, torch.complex64, "chirp"), (3712, torch.complex128, "chirp"),
    (29106, torch.complex64, "split"), (20011, torch.complex64, "chirp"),
    (8388617, torch.complex64, "chirp"), (33 << 18, torch.complex64, "split"),
    (23 << 19, torch.complex64, "split"), (23 << 17, torch.complex128,
                                            "split"),
    ((1 << 30) + 1, torch.complex64, "dense"),
    ((1 << 30) + 1, torch.complex128, "dense")])
def test_chirp_routing_by_length(n, dtype, path):
    """The chirp route takes every length that no other route takes, up
    to ``split.MAX_LENGTH`` = 2^30: up to the dense route's old
    limit (complex64 4835, complex128 2419) generic stages that cost the
    dense route more (``dense.GENERIC_COST``: 4835 = 5*967, the primes
    521 and 4831); past it a prime factor from 17 that no codelet takes
    (4836 = 4*3*13*31, 7424 = 29*256, 10007, 20011, complex128 2421 =
    9*269, 3712 = 29*128); since the split route's general plans no
    13-smooth line past one block (29106 = 2*14553, one factor of 2, is
    split).  The dense route keeps the lengths to that limit whose
    generic stages cost it less (816 = 17*48; complex128 2419 = 41*59 left
    it when the chirp's glue went into its kernels) and takes the
    13-smooth lengths past it whose line fits one block (complex128 2420
    = 4*5*11^2 and 8448, complex64 5460 = 4*1365, 16896 = 33*512 and
    23040 = 45*512, past the long-line route's 128 KB line); the chirp
    also takes what raised past its old limit, half the split route's
    longest power of two (the prime 8388617, 2^23 + 1 = 3*2796203,
    complex128 2^21 + 1 = 9*233017), its M 13-smooth from 2N - 1 to twice
    that on the dense route's kernel or a split plan; past 2^30 the
    dense route raises, its message naming the kernels' 32-bit line
    index.  The
    long-line route takes 45*2^k (5760 = 30 x 12 x 16, 11520) and 35*2^7
    = 4480 up to its line, 5000 = 25 x 25 x 8 too, and 19*2^k since the
    radix-19 codelet (4864 = 19 x 16 x 16, complex128 2432 = 19 x 8 x
    16) and 23*2^k since the radix-23 codelet (5888 = 23 x 16 x 16,
    complex128 2944 = 23 x 8 x 16); the split route 19*2^19, past the
    chirp's old limit, 23*2^19 and complex128 23*2^17, which raised, and
    by its rule (``split.rule_factors``) 33792 = 256 x 132, the chirp's
    before, and 33*2^18 = 1024 x 8448, which raised."""
    if path == "radix" and n in longline.WIDE.get(dtype, {}):
        path = "long"       # the radix route's wide lines: the wide kernel
    assert radix.kernel_path(n, dtype) == path
    if path in ("chirp", "dense"):
        assert chirp.takes(n, dtype) == (path == "chirp")
    if path == "chirp":
        plan = chirp.chirp_plan(n, dtype)
        assert 2 * n - 1 <= plan.m <= 2 * (2 * n - 1)
        assert radix.smooth(plan.m) and plan.m <= split.LINE_MAX
        assert plan.route == (
            "long" if plan.m in longline.FOLD_SIZES[dtype]
            else "dense" if dense.fits(plan.m, dtype) else "split")
    if path == "dense" and n > 1 << 20:
        with pytest.raises(ValueError, match="32-bit ints"):
            tfm.launch_config(n, dtype.itemsize)


def test_chirp_lines_along_any_axis_and_their_gradient():
    """``ops.fft1d`` on a chirp N: contiguous lines in place, a strided
    axis copied contiguous first (``ops.copies``); the transform's
    gradient (``LineTransform``: the adjoint runs on the same route)
    against ``torch.fft``'s, both directions."""
    n = 4864
    r = np.random.default_rng(5)
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


def test_fft_conv_at_2432_takes_the_long_route_and_matches_reference():
    """``fft_conv`` at S=2432 (lines of 4864 = 19 x 16 x 16, the
    long-line route since the radix-19 codelet; the chirp before) with 8
    channels on the kernel backend's plain version against the
    reference's mixer, float32: the output, and the gradients of w_in,
    basis_w, decay, w_out and the input against ``jax.grad`` of the
    reference's ``fft_backend="xla"``."""
    _fft_conv_matches_reference(2432, "long")


def test_fft_conv_at_2880_takes_the_long_route_and_matches_reference():
    """``fft_conv`` at S=2880 (lines of 5760 = 30 x 12 x 16, the long-line
    route with a mixed R2, off the chirp) as at S=2432."""
    _fft_conv_matches_reference(2880, "long")


def _fft_conv_matches_reference(s, route):
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
    assert radix.kernel_path(2 * s, torch.complex64) == route
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
