"""Tests that need an NVIDIA GPU: the CUDA four-step kernel against its
plain version, the kernel-backend plan on the card (bulk and chunked), the
CUDA-event timer the tuner and calibration use, and on 4 cards over NCCL
the plans, the plan-stream executor's mixed queue (plain, and under the
static verifier and the sanitizer) and the service losing one card; the LM
smoke serving path on the card against the CPU, the split route (lines
longer than one block) and the FFT long-convolution mixer on it at
S=16384, the radix route's mixed lengths (every one, strided axes, an
unaligned view), the long-line and split routes' mixed lengths (every
one, against the plain version and ``torch.fft``) and the mixer on them
at S=2688, 3072, 3328 and 3584 (no chirp call) and S=12288, the power-of-two
long-line and
split lengths bitwise equal to their plain versions, the chirp route at
the lengths it keeps, the dense route's mixed-radix kernel at a length
per family, the mixer on the kernel, its gradient through the
kernel, and a
smoke train step on the card against the CPU; ``[train]``'s 8 layers
lowering the loss of the batches they trained on; the LM's mesh path on one card (a
(1, 1) NCCL mesh against no mesh) and on 4 cards (qwen3-8b at 36 layers
trained on (1, 4) and (2, 2) and served on (1, 4), a full-width step
against one card, ``fft_conv`` split over the cards; each writes its
record to ``chiprun_out/``).  They skip where CUDA is absent.  This file imports no JAX, so on a GPU machine without
JAX it runs with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import json
import math
import os

import numpy as np
import pytest
import torch

from repro_torch.kernels import fft_matmul as tfm
from repro_torch.kernels import ops, radix
from torch_harness import assert_scaled_close, cplx, run_ranks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in fp32
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,parts,use_tw", [
    ((130, 512), torch.complex64, None, False),
    ((5, 1024), torch.complex64, 4, True),
    ((7, 53), torch.complex64, None, False),       # a prime: the chirp
    ((300, 64), torch.complex64, 8, False),         # ragged last tile
    ((5, 48), torch.complex128, 2, True),
    ((67, 4096), torch.complex64, None, True),      # radix, N1 = N2 = 64
    ((33, 2), torch.complex64, 2, False),           # radix, N1 = 1
    ((130, 512), torch.complex128, 4, True),        # radix complex128
    ((9, 2048), torch.complex128, None, False),     # long: three passes
])
@pytest.mark.parametrize("inverse", [False, True])
def test_cuda_kernel_matches_plain_version(cuda, shape, dtype, parts,
                                           use_tw, inverse):
    x = torch.from_numpy(cplx(shape, 5)).to(cuda, dtype)
    n = shape[1]
    tw = (torch.exp(-1j * math.pi * torch.arange(n, device=cuda) / (2 * n))
          .to(dtype) if use_tw else None)
    tfm.reset_launch_counts()
    got = tfm.fft_fourstep(x, inverse=inverse, twiddle=tw, pack_parts=parts)
    want = tfm.fft_fourstep_plain(x, inverse=inverse, twiddle=tw,
                                  pack_parts=parts)
    torch.cuda.synchronize()
    path = radix.kernel_path(n, dtype)
    # the chirp (the prime 53's route) is two transforms of M
    launches = 2 if path == "chirp" else 1
    assert tfm.fft_fourstep.launches == launches
    assert tfm.fft_fourstep.path_launches[path] == launches
    tol = 5e-6 if dtype == torch.complex64 else 1e-12
    assert_scaled_close(got.cpu().numpy(), want.cpu().numpy(), tol)
    # torch.fft with the epilogue: a yardstick independent of the plain
    # version, which on the long path mirrors the kernel's index maps
    lib = (torch.fft.ifft if inverse else torch.fft.fft)(x)
    if tw is not None:
        lib = lib * tw
    if parts is not None:
        lib = lib.reshape(shape[0], parts, n // parts)
    assert_scaled_close(got.cpu().numpy(), lib.cpu().numpy(), tol)
    if parts is not None:
        assert got.transpose(0, 1).is_contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,use_tw", [
    ((8, 512, 512), torch.complex64, False),      # the main path's dim 1
    ((1, 512, 4096), torch.complex64, True),
    ((3, 512, 1000), torch.complex64, True),      # ragged last inner group
    ((5, 1024, 16), torch.complex64, False),
    ((4, 256, 40), torch.complex128, True),
])
@pytest.mark.parametrize("inverse", [False, True])
def test_cuda_strided_kernel_matches_plain_version(cuda, shape, dtype,
                                                   use_tw, inverse):
    x = torch.from_numpy(cplx(shape, 7)).to(cuda, dtype)
    n = shape[1]
    tw = (torch.exp(-1j * math.pi * torch.arange(n, device=cuda) / (2 * n))
          .to(dtype) if use_tw else None)
    tfm.reset_launch_counts()
    got = tfm.fft_fourstep_strided(x, inverse=inverse, twiddle=tw)
    want = tfm.fft_fourstep_strided_plain(x, inverse=inverse, twiddle=tw)
    torch.cuda.synchronize()
    assert tfm.fft_fourstep.layout_launches == {"lines": 0, "strided": 1}
    assert tfm.fft_fourstep.path_launches == {"radix": 1, "dense": 0,
                                              "long": 0, "split": 0,
                                              "chirp": 0}
    tol = 5e-6 if dtype == torch.complex64 else 1e-12
    assert_scaled_close(got.cpu().numpy(), want.cpu().numpy(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("conj_twiddle", [False, True])
def test_cuda_kernel_reads_conjugate_views(cuda, conj_twiddle):
    """``x.conj()`` (and a conjugated twiddle) is a lazy view sharing the
    original's memory; the kernel must transform the conjugate."""
    x = torch.from_numpy(cplx((130, 512), 6)).to(cuda)
    tw = None
    if conj_twiddle:
        tw = torch.exp(-1j * math.pi * torch.arange(512, device=cuda)
                       / 1024).to(torch.complex64).conj()
    got = tfm.fft_fourstep(x.conj(), twiddle=tw)
    want = torch.fft.fft(x.conj())
    if tw is not None:
        want = want * tw
    torch.cuda.synchronize()
    assert_scaled_close(got.cpu().numpy(), want.cpu().numpy(), 5e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n", [(torch.complex64, 8192),
                                     (torch.complex64, 16384),
                                     (torch.complex128, 2048),
                                     (torch.complex128, 4096),
                                     (torch.complex128, 8192)])
@pytest.mark.parametrize("b,inverse,parts,use_tw", [
    (5, False, None, False), (3, True, None, True), (7, False, 2, False),
    (301, True, 4, True)])
def test_cuda_long_kernel_matches_plain_version_and_torch_fft(
        cuda, dtype, n, b, inverse, parts, use_tw):
    """The long-line kernel (one launch on the "long" path) against its
    plain version (``longline.emulate``) and ``torch.fft``, at the
    kernel's tolerances, with both epilogues."""
    assert radix.kernel_path(n, dtype) == "long"
    x = torch.from_numpy(cplx((b, n), 11)).to(cuda, dtype)
    tw = (torch.exp(-1j * math.pi * torch.arange(n, device=cuda) / (2 * n))
          .to(dtype) if use_tw else None)
    want = tfm.fft_fourstep_plain(x, inverse=inverse, twiddle=tw,
                                  pack_parts=parts)
    lib = (torch.fft.ifft if inverse else torch.fft.fft)(x)
    if tw is not None:
        lib = lib * tw
    if parts is not None:
        lib = lib.reshape(b, parts, n // parts)
    tol = 5e-6 if dtype == torch.complex64 else 1e-12
    tfm.reset_launch_counts()
    got = tfm.fft_fourstep(x, inverse=inverse, twiddle=tw, pack_parts=parts)
    torch.cuda.synchronize()
    assert tfm.fft_fourstep.path_launches == {"radix": 0, "dense": 0,
                                              "long": 1, "split": 0,
                                              "chirp": 0}
    assert_scaled_close(got.cpu().numpy(), want.cpu().numpy(), tol)
    assert_scaled_close(got.cpu().numpy(), lib.cpu().numpy(), tol)
    if parts is not None:
        assert got.transpose(0, 1).is_contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n", [(torch.complex64, 2944),
                                     (torch.complex64, 1000),
                                     (torch.complex128, 864)])
def test_cuda_wide_kernel_against_torch_fft_and_its_gradient(cuda, dtype, n):
    """The long route's wide kernel (``fft_wide.cuh``: tiles of LT lines)
    at a wide line: one launch on "long" a call, on a batch whose last
    tile is ragged (complex64 1000, complex128 864: tiles of 3 and 2
    lines) and whose tiles outnumber twice the blocks, forward and
    inverse with the twiddle and ``pack_parts``, against its plain
    version (``longline.emulate``) and ``torch.fft``; a view off 16 bytes
    cloned once (``aligned_copies``); then the gradient of a real loss
    through ``LineTransform`` (the transform and its adjoint, 2 launches)
    against ``torch.fft``'s."""
    from repro_torch.kernels import longline
    plan = longline.long_plan(n, dtype)
    assert isinstance(plan, longline.WidePlan)
    # More than twice the tiles of the largest grid, so that every block
    # wraps the ring of two (its mbarriers' parity flips) in both
    # directions; a ragged last tile where LT > 1.
    per_sm = min(16, 233472 // (plan.smem_bytes + 1024))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    b = 3 * per_sm * sms * plan.lt + 1
    x = torch.from_numpy(cplx((b, n), 31)).to(cuda, dtype)
    tw = torch.exp(-1j * math.pi * torch.arange(n, device=cuda)
                   / (2 * n)).to(dtype)
    tol = 5e-6 if dtype == torch.complex64 else 1e-12
    for inverse, t, parts in ((False, None, None), (True, tw, 4)):
        tfm.reset_launch_counts()
        got = tfm.fft_fourstep(x, inverse=inverse, twiddle=t,
                               pack_parts=parts)
        torch.cuda.synchronize()
        counts = tfm.launch_counts()
        assert counts["launches"] == counts["long"] == 1, counts
        assert counts["aligned_copies"] == 0
        want = tfm.fft_fourstep_plain(x, inverse=inverse, twiddle=t,
                                      pack_parts=parts)
        lib = (torch.fft.ifft if inverse else torch.fft.fft)(x)
        if t is not None:
            lib = (lib * t).reshape(b, parts, n // parts)
        assert_scaled_close(got.cpu().numpy(), want.cpu().numpy(), tol)
        assert_scaled_close(got.cpu().numpy(), lib.cpu().numpy(), tol)
    if dtype == torch.complex64:      # a complex128 view starts on 16
        view = x.reshape(-1)[1:1 + 3 * n].view(3, n)
        assert view.data_ptr() % 16
        tfm.reset_launch_counts()
        got = tfm.fft_fourstep(view)
        torch.cuda.synchronize()
        assert tfm.launch_counts()["aligned_copies"] == 1
        assert_scaled_close(got.cpu().numpy(),
                            torch.fft.fft(view).cpu().numpy(), tol)
    w = torch.from_numpy(np.random.default_rng(32).standard_normal(
        (b, n))).to(cuda, torch.float64 if dtype == torch.complex128
                    else torch.float32)
    xg = x.clone().requires_grad_(True)
    tfm.reset_launch_counts()
    (ops.fft1d(xg).real * w).sum().backward()
    torch.cuda.synchronize()
    assert tfm.launch_counts()["long"] == 2
    yg = x.clone().requires_grad_(True)
    (torch.fft.fft(yg).real * w).sum().backward()
    assert_scaled_close(xg.grad.cpu().numpy(), yg.grad.cpu().numpy(),
                        10 * tol)


@pytest.mark.cuda
def test_cuda_long_kernel_reads_an_unaligned_view(cuda):
    """The bulk copy reads 16-byte aligned lines: a contiguous view 8 bytes
    into its storage is transformed all the same (one launch)."""
    base = torch.from_numpy(cplx((3 * 8192 + 1,), 12)).to(cuda)
    x = base[1:].view(3, 8192)
    assert x.data_ptr() % 16 == 8
    tfm.reset_launch_counts()
    got = tfm.fft_fourstep(x)
    torch.cuda.synchronize()
    assert tfm.fft_fourstep.path_launches["long"] == 1
    assert_scaled_close(got.cpu().numpy(), torch.fft.fft(x).cpu().numpy(),
                        5e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n", [(torch.complex64, 1 << 16),
                                     (torch.complex64, 1 << 23),
                                     (torch.complex128, 1 << 14)])
@pytest.mark.parametrize("b,inverse,parts,use_tw", [
    (2, False, None, False), (1, True, None, True), (3, False, 2, False),
    (2, True, 4, True)])
def test_cuda_split_kernel_matches_plain_version_and_torch_fft(
        cuda, dtype, n, b, inverse, parts, use_tw):
    """The split route (one split call of two launches, both on the "split"
    path: pass A strided, pass B on lines, on the long-line route through a
    cluster with pass C folded in) against its plain version
    (``split.emulate``)
    and ``torch.fft``, at the kernel's tolerances, with both epilogues;
    rows on the radix route (2^16, complex128 2^14) and on the long-line
    route (2^23)."""
    from repro_torch.kernels import split
    assert radix.kernel_path(n, dtype) == "split"
    plan = split.split_plan(n, dtype)
    x = torch.from_numpy(cplx((b, n), 13)).to(cuda, dtype)
    tw = (torch.exp(-1j * math.pi * torch.arange(n, device=cuda) / (2 * n))
          .to(dtype) if use_tw else None)
    want = tfm.fft_fourstep_plain(x, inverse=inverse, twiddle=tw,
                                  pack_parts=parts)
    lib = (torch.fft.ifft if inverse else torch.fft.fft)(x)
    if tw is not None:
        lib = lib * tw
    if parts is not None:
        lib = lib.reshape(b, parts, n // parts)
    tol = 5e-6 if dtype == torch.complex64 else 1e-12
    tfm.reset_launch_counts()
    got = tfm.fft_fourstep(x, inverse=inverse, twiddle=tw, pack_parts=parts)
    torch.cuda.synchronize()
    counts = tfm.launch_counts()
    long_rows = plan.row_path == "long"
    assert counts["split_calls"] == 1
    assert counts["launches"] == 2
    assert counts["strided"] == 1 and counts["lines"] == 1
    assert counts["fold_long"] == long_rows and counts["fold_dense"] == 0
    assert tfm.fft_fourstep.path_launches == {
        "radix": 0, "dense": 0, "long": 0, "split": 2, "chirp": 0}
    assert_scaled_close(got.cpu().numpy(), want.cpu().numpy(), tol)
    assert_scaled_close(got.cpu().numpy(), lib.cpu().numpy(), tol)
    if parts is not None:
        assert got.transpose(0, 1).is_contiguous()


@pytest.mark.cuda
def test_cuda_split_kernel_reads_an_unaligned_view(cuda):
    """A contiguous view 8 bytes into its storage (pass A's loads are 8
    bytes a value; pass B reads the scratch block): transformed all the
    same, two launches."""
    n = 1 << 15
    base = torch.from_numpy(cplx((2 * n + 1,), 14)).to(cuda)
    x = base[1:].view(2, n)
    assert x.data_ptr() % 16 == 8
    tfm.reset_launch_counts()
    got = ops.fft1d(x)
    torch.cuda.synchronize()
    assert tfm.launch_counts()["split_calls"] == 1
    assert tfm.fft_fourstep.launches == tfm.launch_counts()["split"] == 2
    assert_scaled_close(got.cpu().numpy(), torch.fft.fft(x).cpu().numpy(),
                        5e-6)


@pytest.mark.cuda
def test_fft_conv_at_16384_on_the_split_route(cuda):
    """``fft_conv`` at S=16384 (lines of 32768) on the kernel, 64
    channels, float32, forward and backward: 3 split calls forward and 3
    more backward (2 launches each), no dense launch and no line copy;
    the output and every gradient within 1e-4 of ``cufft``'s."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.distributed.sharding import ParamBuilder
    from repro_torch.models import ssm
    cfg = dataclasses.replace(smoke_config("jamba_v0_1_52b"),
                              ssm_impl="fft_conv", dtype="float32")
    params = ssm.init_fft_conv(ParamBuilder(0, device=cuda), "ssm", cfg)
    params.requires_grad_(True)
    s = 16384
    x = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (1, s, cfg.d_model)).astype(np.float32)).to(cuda)

    def fwd_bwd(backend):
        for prm in params.parameters():
            prm.grad = None
        xx = x.detach().requires_grad_(True)
        y, _ = ssm.fft_conv(params, cfg, None, xx, fft_backend=backend)
        y.square().sum().backward()
        return [y.detach()] + [prm.grad for prm in params.parameters()] \
            + [xx.grad]

    ref = fwd_bwd("cufft")
    tfm.reset_launch_counts()
    ops.copies["lines"] = 0
    got = fwd_bwd("kernel")
    torch.cuda.synchronize()
    counts = tfm.launch_counts()
    assert counts["split_calls"] == 6, counts
    assert counts["launches"] == counts["split"] == 12, counts
    assert counts["dense"] == 0 and ops.copies["lines"] == 0
    for g, r in zip(got, ref):
        assert_scaled_close(g.cpu().numpy(), r.cpu().numpy(), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("inverse", [False, True])
def test_cuda_mixed_radix_lengths_match_plain_version_and_torch_fft(
        cuda, dtype, inverse):
    """Every mixed radix length (N = r*2^k, r in ``radix.RADIX_ODD``: 3
    to 19, the odd products 21 to 63 and the odd parts from 65 whose N
    has both factors within a codelet, 600 = 24 x 25 to 3780 = 60 x 63;
    17*2^k and 19*2^k to 2176 = 34 x 64 and 2432 = 38 x 64, 23*2^k to
    2944 = 46 x 64): one launch each, on the radix route or, for the wide
    lines (``longline.WIDE``), the long route's wide kernel, against
    the plain version and ``torch.fft`` at the
    kernel's tolerances, without an epilogue and with both (a pack_parts
    segment that is not a power of two where 3 divides N)."""
    tol = 5e-6 if dtype == torch.complex64 else 1e-12
    mixed = [n for n in radix.RADIX_SIZES[dtype] if not radix.is_pow2(n)]
    assert len(mixed) == (320 if dtype == torch.complex64 else 155)
    for n in mixed:
        x = torch.from_numpy(cplx((21, n), n)).to(cuda, dtype)
        tw = torch.exp(-1j * math.pi * torch.arange(n, device=cuda)
                       / (2 * n)).to(dtype)
        parts = 3 if n % 3 == 0 else 2
        lib = (torch.fft.ifft if inverse else torch.fft.fft)(x)
        for t, p in ((None, None), (tw, parts)):
            tfm.reset_launch_counts()
            got = tfm.fft_fourstep(x, inverse=inverse, twiddle=t,
                                   pack_parts=p)
            torch.cuda.synchronize()
            # the wide lines take the long route's wide kernel
            assert tfm.fft_fourstep.path_launches[
                radix.kernel_path(n, dtype)] == 1, n
            assert tfm.fft_fourstep.launches == 1, n
            want = tfm.fft_fourstep_plain(x, inverse=inverse, twiddle=t,
                                          pack_parts=p)
            ref = lib if t is None else (lib * t).reshape(21, p, n // p)
            assert_scaled_close(got.cpu().numpy(), want.cpu().numpy(), tol)
            assert_scaled_close(got.cpu().numpy(), ref.cpu().numpy(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((2, 384, 300), torch.complex64),
                                         ((3, 1280, 40), torch.complex64),
                                         ((4, 96, 17), torch.complex64),
                                         ((2, 480, 33), torch.complex128),
                                         ((2, 600, 40), torch.complex64),
                                         ((3, 338, 17), torch.complex64),
                                         ((2, 300, 33), torch.complex128)])
def test_cuda_strided_mixed_axis(cuda, shape, dtype):
    """A mixed length on a strided axis runs in place on the strided
    entry (``ops``: no line copy), with a ragged last group of inner
    indices, against ``torch.fft`` along that axis."""
    x = torch.from_numpy(cplx(shape, 16)).to(cuda, dtype)
    tol = 5e-6 if dtype == torch.complex64 else 1e-12
    tfm.reset_launch_counts()
    ops.copies["lines"] = 0
    got = ops.ifft1d(x, 1)
    torch.cuda.synchronize()
    assert tfm.fft_fourstep.layout_launches == {"lines": 0, "strided": 1}
    assert tfm.fft_fourstep.path_launches["radix"] == 1
    assert ops.copies["lines"] == 0
    assert_scaled_close(got.cpu().numpy(),
                        torch.fft.ifft(x, dim=1).cpu().numpy(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,b,inverse,parts,use_tw,route", [
    (torch.complex64, 7424, 3, False, None, True, "long"),     # M 16384
    (torch.complex64, 7424, 2, True, 4, False, "long"),
    (torch.complex64, 10007, 2, True, None, True, "dense"),    # M 20449
    (torch.complex64, 20011, 1, False, None, True, "split"),   # M 40040
    (torch.complex64, 29 << 10, 2, True, 4, True, "split"),    # M 59400
    (torch.complex128, 3001, 2, False, None, True, "long"),    # M 8192
    (torch.complex128, 3712, 1, True, 29, False, "long"),
    (torch.complex128, 8009, 1, True, None, True, "split"),    # M 16038
    (torch.complex128, 4099, 2, True, None, True, "dense"),    # M 8281
    (torch.complex64, 521, 5, False, None, True, "dense"),     # M 1183
    (torch.complex128, 101, 3, True, None, True, "dense"),     # M 208
    (torch.complex64, 4831, 2, True, None, False, "long")])    # left dense
def test_cuda_chirp_route_matches_plain_version_and_torch_fft(
        cuda, dtype, n, b, inverse, parts, use_tw, route):
    """The chirp route (one chirp call; its two transforms' launches all
    on the "chirp" path, M on the dense or long-line route, one launch each,
    or a split plan, the folded load in pass A and store in pass C; M's
    route is the one ``route`` names, so that each runs in both dtypes)
    against its plain version (``chirp.emulate``) at the kernel's
    tolerances and ``torch.fft`` within 2e-4, with both epilogues (the
    ``pack_parts`` segments stored by the second transform, no line
    copy); the primes 521, 4831 and complex128 101, whose generic stage
    costs the dense route more (``dense.GENERIC_COST``), left it too."""
    from repro_torch.kernels import chirp
    assert radix.kernel_path(n, dtype) == "chirp"
    plan = chirp.chirp_plan(n, dtype)
    assert plan.route == route, (n, plan)
    x = torch.from_numpy(cplx((b, n), 17)).to(cuda, dtype)
    tw = (torch.exp(-1j * math.pi * torch.arange(n, device=cuda) / (2 * n))
          .to(dtype) if use_tw else None)
    want = tfm.fft_fourstep_plain(x, inverse=inverse, twiddle=tw,
                                  pack_parts=parts)
    lib = (torch.fft.ifft if inverse else torch.fft.fft)(x)
    if tw is not None:
        lib = lib * tw
    if parts is not None:
        lib = lib.reshape(b, parts, n // parts)
    tol = 5e-6 if dtype == torch.complex64 else 1e-12
    tfm.reset_launch_counts()
    ops.copies["lines"] = 0
    got = tfm.fft_fourstep(x, inverse=inverse, twiddle=tw, pack_parts=parts)
    torch.cuda.synchronize()
    counts = tfm.launch_counts()
    inner = 1 if plan.route in ("dense", "long") else any_launches(
        plan.split, dtype)
    assert counts["chirp_calls"] == 1 and counts["split_calls"] == 0
    assert counts["launches"] == counts["chirp"] == 2 * inner, counts
    assert tfm.fft_fourstep.path_launches["dense"] == 0
    assert ops.copies["lines"] == 0
    assert_scaled_close(got.cpu().numpy(), want.cpu().numpy(), tol)
    assert_scaled_close(got.cpu().numpy(), lib.cpu().numpy(), 2e-4)
    if parts is not None:
        assert got.transpose(0, 1).is_contiguous()


def transform_launches(n, dtype) -> int:
    """Launches of one transform of contiguous lines of ``n``: one, or a
    split call's two, or a nested plan's pass A, its rows' and pass C
    where its rows keep pass C."""
    from repro_torch.kernels import split
    if radix.kernel_path(n, dtype) != "split":
        return 1
    return any_launches(split.split_plan(n, dtype), dtype)


def any_launches(plan, dtype) -> int:
    """Launches of one call of a split plan: two (pass A and pass B, pass
    C folded in where the rows take the dense or long-line route's
    stages), or pass A, the rows' own launches and pass C."""
    from repro_torch.kernels import split
    if plan.row_path == "any" and split.fold_layout(plan, dtype) is None:
        return 2 + transform_launches(plan.q, dtype)
    return split.call_launches(plan, dtype)


@pytest.mark.cuda
def test_cuda_nested_line_of_2_to_the_28(cuda):
    """A nested plan on complex64 (4, 2^28): 2^33 bytes a buffer, so a
    32-bit byte offset would fail there (pass A on the radix route at P =
    512, the rows of 2^19 on the split route one level down, pass C); 16
    sampled bins of each line against a float64 direct sum on the card,
    within 2e-4 of the samples' largest."""
    from repro_torch.kernels import split
    b, n = 4, 1 << 28
    assert radix.kernel_path(n, torch.complex64) == "split"
    assert split.split_plan(n, torch.complex64).row_path == "any"
    gen = torch.Generator(device=cuda).manual_seed(28)
    x = torch.randn((b, n), dtype=torch.complex64, device=cuda,
                    generator=gen)
    tfm.reset_launch_counts()
    y = tfm.fft_fourstep(x)
    torch.cuda.synchronize()
    counts = tfm.launch_counts()
    assert counts["split_calls"] == 1
    assert counts["launches"] == counts["split"] == transform_launches(
        n, torch.complex64)
    ks = [0, 1, n // 2, n - 1] + [int(k) for k in torch.randint(
        0, n, (12,), generator=torch.Generator().manual_seed(2))]
    idx = torch.arange(n, device=cuda, dtype=torch.int64)
    for line in range(b):
        xl = x[line].to(torch.complex128)
        got, ref = [], []
        for k in ks:
            phase = ((idx * k) % n).to(torch.float64) * (-2 * math.pi / n)
            ref.append(complex((xl * torch.polar(torch.ones_like(phase),
                                                 phase)).sum()))
            got.append(complex(y[line, k]))
            del phase
        err = np.abs(np.array(got) - np.array(ref)).max()
        assert err <= 2e-4 * np.abs(np.array(ref)).max(), (line, err)
        del xl


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,route", [
    (torch.complex64, 2432, "radix"), (torch.complex64, 544, "radix"),
    (torch.complex128, 608, "radix"), (torch.complex128, 544, "radix"),
    (torch.complex64, 4864, "long"), (torch.complex64, 9728, "long"),
    (torch.complex128, 2432, "long"), (torch.complex128, 4864, "long"),
    (torch.complex64, 17 << 10, "split"), (torch.complex64, 19 << 19,
                                           "split"),
    (torch.complex128, 19 << 9, "split"), (torch.complex128, 17 << 17,
                                           "split"),
    (torch.complex64, 2944, "radix"), (torch.complex128, 736, "radix"),
    (torch.complex64, 5888, "long"), (torch.complex64, 11776, "long"),
    (torch.complex128, 1472, "long"), (torch.complex128, 2944, "long"),
    (torch.complex128, 5888, "long"), (torch.complex64, 23 << 10, "split"),
    (torch.complex64, 23 << 19, "split"), (torch.complex128, 23 << 9,
                                           "split"),
    (torch.complex128, 23 << 17, "split")])
@pytest.mark.parametrize("inverse", [False, True])
def test_cuda_wide_lengths_on_their_routes(cuda, dtype, n, route, inverse):
    """17*2^k, 19*2^k and 23*2^k on the route ``kernel_path`` names (the
    radix-17, radix-19 and radix-23 codelets: radix, long-line with an
    odd R1, split with the odd part in Q, 23*2^k by the split route's
    rule; the longest split ones lay past the chirp's limit), one call's
    launches all on it, with the twiddle and a ``pack_parts`` of N/17,
    N/19 or N/23, against the plain version at the kernel's tolerances
    and ``torch.fft``; the radix route's wide lines (``longline.WIDE``)
    take the long route's wide kernel on contiguous lines and keep the
    radix kernel's strided entry."""
    from repro_torch.kernels import longline
    if n in longline.WIDE[dtype]:
        route = "long"
    assert radix.kernel_path(n, dtype) == route
    b = max(1, (1 << 24) // (n * dtype.itemsize))
    x = torch.from_numpy(cplx((b, n), 23)).to(cuda, dtype)
    tw = torch.exp(-1j * math.pi * torch.arange(n, device=cuda)
                   / (2 * n)).to(dtype)
    parts = radix.odd_part(n)
    tol = 5e-6 if dtype == torch.complex64 else 1e-12
    tfm.reset_launch_counts()
    got = tfm.fft_fourstep(x, inverse=inverse, twiddle=tw, pack_parts=parts)
    torch.cuda.synchronize()
    counts = tfm.launch_counts()
    assert counts["launches"] == counts[route] >= 1, counts
    assert counts["chirp_calls"] == 0
    want = tfm.fft_fourstep_plain(x, inverse=inverse, twiddle=tw,
                                  pack_parts=parts)
    lib = ((torch.fft.ifft if inverse else torch.fft.fft)(x) * tw).reshape(
        b, parts, n // parts)
    assert_scaled_close(got.cpu().numpy(), want.cpu().numpy(), tol)
    assert_scaled_close(got.cpu().numpy(), lib.cpu().numpy(), tol)
    if tfm.strided_supported(n, dtype, False):      # the strided entry
        y = torch.from_numpy(cplx((3, n, 40), 24)).to(cuda, dtype)
        tfm.reset_launch_counts()
        got = tfm.fft_fourstep_strided(y, inverse=inverse)
        torch.cuda.synchronize()
        assert tfm.fft_fourstep.layout_launches["strided"] == 1
        assert_scaled_close(
            got.cpu().numpy(),
            (torch.fft.ifft if inverse else torch.fft.fft)(
                y, dim=1).cpu().numpy(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,b", [
    (torch.complex64, 75, 67), (torch.complex64, 4725, 3),     # odd
    (torch.complex64, 2730, 5), (torch.complex128, 990, 9),    # no codelets
    (torch.complex64, 504, 17), (torch.complex128, 22, 300),   # spills
    (torch.complex64, 816, 37), (torch.complex128, 323, 11),   # generic
    (torch.complex64, 53, 301),                                # prime
    (torch.complex64, 23040, 3), (torch.complex128, 8448, 2),  # off chirp
    (torch.complex64, 28431, 2)])
@pytest.mark.parametrize("inverse", [False, True])
def test_cuda_dense_route_matches_plain_version_and_torch_fft(
        cuda, dtype, n, b, inverse):
    """The dense route's mixed-radix kernel, one launch on "dense", at a
    length per family (batches ragged against its tile of lines), both
    directions, with the twiddle and with ``pack_parts`` by turns, against
    its plain version (``dense.emulate``) at the kernel's tolerances and
    ``torch.fft``."""
    assert radix.kernel_path(n, dtype) == "dense"
    x = torch.from_numpy(cplx((b, n), 21)).to(cuda, dtype)
    parts = (3 if n % 3 == 0 else 2 if n % 2 == 0 else None) \
        if inverse else None
    tw = None if inverse else torch.exp(
        -1j * math.pi * torch.arange(n, device=cuda) / (2 * n)).to(dtype)
    want = tfm.fft_fourstep_plain(x, inverse=inverse, twiddle=tw,
                                  pack_parts=parts)
    lib = (torch.fft.ifft if inverse else torch.fft.fft)(x)
    if tw is not None:
        lib = lib * tw
    if parts is not None:
        lib = lib.reshape(b, parts, n // parts)
    tol = 5e-6 if dtype == torch.complex64 else 1e-12
    tfm.reset_launch_counts()
    got = tfm.fft_fourstep(x, inverse=inverse, twiddle=tw, pack_parts=parts)
    torch.cuda.synchronize()
    assert tfm.fft_fourstep.launches == tfm.fft_fourstep.path_launches[
        "dense"] == 1
    assert_scaled_close(got.cpu().numpy(), want.cpu().numpy(), tol)
    assert_scaled_close(got.cpu().numpy(), lib.cpu().numpy(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [384, 6144, 7424, 24576, 10752, 4800, 4725,
                               5888, 33792])
def test_cuda_mixed_and_chirp_read_an_unaligned_view(cuda, n):
    """A contiguous view 8 bytes into its storage, at mixed lengths on the
    radix, long-line (its row copies are 16-byte aligned: the wrapper
    clones; 10752 = 21 x 16 x 32 and 5888 = 23 x 16 x 16, an odd R1; 4800
    = 30 x 10 x 16, a mixed R2) and split routes (33792 = 256 x 132, the
    split route's rule), on the chirp route (7424 = 29*256) and on the
    dense route (4725, odd: its copies take 8 bytes at a time):
    transformed all the same."""
    base = torch.from_numpy(cplx((2 * n + 1,), 18)).to(cuda)
    x = base[1:].view(2, n)
    assert x.data_ptr() % 16 == 8
    tfm.reset_launch_counts()
    got = ops.fft1d(x)
    torch.cuda.synchronize()
    path = radix.kernel_path(n, torch.complex64)
    assert tfm.fft_fourstep.path_launches[path] >= 1
    assert_scaled_close(got.cpu().numpy(), torch.fft.fft(x).cpu().numpy(),
                        2e-4 if path == "chirp" else 5e-6)


@pytest.mark.cuda
def test_fft_conv_at_2688_on_the_long_route(cuda):
    """``fft_conv`` at S=2688 (lines of 5376 = 21x16x16, an odd R1: the
    chirp route before the odd products), as at S=3072: 6 long-line
    launches forward and backward, no chirp call, every gradient within
    1e-4 of ``cufft``'s."""
    _fft_conv_on_the_long_route(cuda, 2688)


@pytest.mark.cuda
def test_fft_conv_at_3072_on_the_long_route(cuda):
    """``fft_conv`` at S=3072 (lines of 6144, a mixed length) on the
    kernel, float32, forward and backward: 3 long-line launches forward
    and 3 more backward, no chirp call, no dense launch and no line copy;
    the output and every gradient within 1e-4 of ``cufft``'s."""
    _fft_conv_on_the_long_route(cuda, 3072)


@pytest.mark.cuda
def test_fft_conv_at_3328_on_the_long_route(cuda):
    """``fft_conv`` at S=3328 (lines of 6656 = 26x16x16, the radix-13
    codelet's length), as at S=3072: 6 long-line launches forward and
    backward, no chirp call, every gradient within 1e-4 of ``cufft``'s."""
    _fft_conv_on_the_long_route(cuda, 3328)


@pytest.mark.cuda
def test_fft_conv_at_3584_on_the_long_route(cuda):
    """``fft_conv`` at S=3584 (lines of 7168 = 28x16x16, the radix-7
    codelet's length), as at S=3072: 6 long-line launches forward and
    backward, no chirp call, every gradient within 1e-4 of ``cufft``'s."""
    _fft_conv_on_the_long_route(cuda, 3584)


def _fft_conv_on_the_long_route(cuda, s):
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.distributed.sharding import ParamBuilder
    from repro_torch.models import ssm
    cfg = dataclasses.replace(smoke_config("jamba_v0_1_52b"),
                              ssm_impl="fft_conv", dtype="float32")
    params = ssm.init_fft_conv(ParamBuilder(0, device=cuda), "ssm", cfg)
    params.requires_grad_(True)
    assert radix.kernel_path(2 * s, torch.complex64) == "long"
    x = torch.from_numpy(np.random.default_rng(19).standard_normal(
        (1, s, cfg.d_model)).astype(np.float32)).to(cuda)

    def fwd_bwd(backend):
        for prm in params.parameters():
            prm.grad = None
        xx = x.detach().requires_grad_(True)
        y, _ = ssm.fft_conv(params, cfg, None, xx, fft_backend=backend)
        y.square().sum().backward()
        return [y.detach()] + [prm.grad for prm in params.parameters()] \
            + [xx.grad]

    ref = fwd_bwd("cufft")
    tfm.reset_launch_counts()
    ops.copies["lines"] = 0
    got = fwd_bwd("kernel")
    torch.cuda.synchronize()
    counts = tfm.launch_counts()
    assert counts["chirp_calls"] == 0 and counts["chirp"] == 0, counts
    assert counts["launches"] == counts["long"] == 6, counts
    assert counts["dense"] == 0 and ops.copies["lines"] == 0
    for g, r in zip(got, ref):
        assert bool(r.abs().max() > 0)
        assert_scaled_close(g.cpu().numpy(), r.cpu().numpy(), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("inverse", [False, True])
def test_cuda_long_mixed_lengths_match_plain_version_and_torch_fft(
        cuda, dtype, inverse):
    """Every mixed long-line length (complex64 4352-15360, complex128
    1088-7680, r in ``radix.EVERY_ROUTE_ODD``: 3 to 19, 21, 23, 25, 27): one
    launch on "long" each,
    against the plain version (``longline.emulate``) and ``torch.fft`` at
    the kernel's tolerances, without an epilogue and with both (segments
    of N/r, r the least odd prime of N)."""
    from repro_torch.kernels import longline
    tol = 5e-6 if dtype == torch.complex64 else 1e-12
    mixed = [n for n in sorted(longline.FACTORS[dtype])
             if radix.odd_part(n) in radix.EVERY_ROUTE_ODD]
    assert len(mixed) == (26 if dtype == torch.complex64 else 39)
    for n in mixed:
        x = torch.from_numpy(cplx((37, n), n)).to(cuda, dtype)
        tw = torch.exp(-1j * math.pi * torch.arange(n, device=cuda)
                       / (2 * n)).to(dtype)
        parts = next(r for r in (3, 5, 7, 11, 13, 17, 19, 23) if n % r == 0)
        lib = (torch.fft.ifft if inverse else torch.fft.fft)(x)
        for t, p in ((None, None), (tw, parts)):
            tfm.reset_launch_counts()
            got = tfm.fft_fourstep(x, inverse=inverse, twiddle=t,
                                   pack_parts=p)
            torch.cuda.synchronize()
            assert tfm.fft_fourstep.path_launches["long"] == 1, n
            assert tfm.fft_fourstep.launches == 1, n
            want = tfm.fft_fourstep_plain(x, inverse=inverse, twiddle=t,
                                          pack_parts=p)
            ref = lib if t is None else (lib * t).reshape(37, p, n // p)
            assert_scaled_close(got.cpu().numpy(), want.cpu().numpy(), tol)
            assert_scaled_close(got.cpu().numpy(), ref.cpu().numpy(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("inverse", [False, True])
def test_cuda_split_rule_lengths_match_plain_version_and_torch_fft(
        cuda, dtype, inverse):
    """Every length of the split route's rule (``split.rule_factors``:
    complex64 396, complex128 269, past the long-line route to 2^24 /
    2^22): one split call of 2 launches (radix rows, or long-line rows
    with pass C folded in), all on "split", against ``torch.fft`` at the
    kernel's tolerances; the first length of each Q with both epilogues
    (segments of N/2) against the plain version too."""
    from repro_torch.kernels import split
    tol = 5e-6 if dtype == torch.complex64 else 1e-12
    rule = [n for n in sorted(split.FACTORS[dtype])
            if n not in split._TABLE[dtype]]
    assert len(rule) == (396 if dtype == torch.complex64 else 269)
    seen = set()
    for n in rule:
        plan = split.split_plan(n, dtype)
        b = max(1, (1 << 21) // n)
        x = torch.from_numpy(cplx((b, n), n)).to(cuda, dtype)
        tfm.reset_launch_counts()
        got = tfm.fft_fourstep(x, inverse=inverse)
        torch.cuda.synchronize()
        counts = tfm.launch_counts()
        assert counts["launches"] == counts["split"] == 2, (n, counts)
        assert counts["fold_long"] == (plan.row_path == "long"), n
        assert counts["split_calls"] == 1
        lib = (torch.fft.ifft if inverse else torch.fft.fft)(x)
        assert_scaled_close(got.cpu().numpy(), lib.cpu().numpy(), tol)
        if plan.q in seen:
            continue
        seen.add(plan.q)
        tw = torch.exp(-1j * math.pi * torch.arange(n, device=cuda)
                       / (2 * n)).to(dtype)
        got = tfm.fft_fourstep(x, inverse=inverse, twiddle=tw, pack_parts=2)
        want = tfm.fft_fourstep_plain(x, inverse=inverse, twiddle=tw,
                                      pack_parts=2)
        assert_scaled_close(got.cpu().numpy(), want.cpu().numpy(), tol)
        assert_scaled_close(got.cpu().numpy(), (lib * tw).reshape(
            b, 2, n // 2).cpu().numpy(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,b", [
    (torch.complex64, 33075, 3),        # odd: a dense pass A
    (torch.complex64, 96000, 2),        # 256 x 375: a radix pass A
    (torch.complex64, 3 ** 15, 1),      # past the chirp's limit
    (torch.complex128, 4084223, 1)])    # past it, a column tile of 4
def test_cuda_split_general_plans_match_plain_version_and_torch_fft(
        cuda, dtype, n, b):
    """The split route's general plans (``split.general_factors``): one
    split call of 2 launches on "split" (pass A strided, the dense rows
    with pass C folded in on lines), both directions with both
    epilogues (segments of N/r, r the least prime factor of N) against
    the plain version (``split.emulate``) and ``torch.fft`` at the
    kernel's tolerances; then the first candidate plan of each pass A
    route (``split.general_candidates``) forced, against
    ``split.emulate_plan``."""
    from repro_torch.kernels import split
    assert radix.kernel_path(n, dtype) == "split"
    tol = 5e-6 if dtype == torch.complex64 else 1e-12
    x = torch.from_numpy(cplx((b, n), n)).to(cuda, dtype)
    tw = torch.exp(-1j * math.pi * torch.arange(n, device=cuda)
                   / (2 * n)).to(dtype)
    parts = next(r for r in (2, 3, 5, 7, 11, 13) if n % r == 0)
    for inverse in (False, True):
        lib = (torch.fft.ifft if inverse else torch.fft.fft)(x)
        for t, p in ((None, None), (tw, parts)):
            tfm.reset_launch_counts()
            got = tfm.fft_fourstep(x, inverse=inverse, twiddle=t,
                                   pack_parts=p)
            torch.cuda.synchronize()
            counts = tfm.launch_counts()
            assert counts["launches"] == counts["split"] == 2, counts
            assert counts["strided"] == 1 and counts["split_calls"] == 1
            assert counts["fold_dense"] == 1, counts
            want = tfm.fft_fourstep_plain(x, inverse=inverse, twiddle=t,
                                          pack_parts=p)
            ref = lib if t is None else (lib * t).reshape(b, p, n // p)
            assert_scaled_close(got.cpu().numpy(), want.cpu().numpy(), tol)
            assert_scaled_close(got.cpu().numpy(), ref.cpu().numpy(), 2e-4)
    for col in ("radix", "dense"):
        cand = next((c for c in split.general_candidates(n, dtype)
                     if c[2] == col), None)
        if cand is None:
            continue
        plan = split.SplitPlan(n, cand[0], cand[1], "dense", col)
        got = tfm._launch_split(x, tw, inverse=True, pack_parts=parts,
                                plan=plan)
        want = split.emulate_plan(x, plan, inverse=True, twiddle=tw,
                                  pack_parts=parts)
        assert_scaled_close(got.transpose(0, 1).cpu().numpy(),
                            want.cpu().numpy(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,b,rows,cluster,ragged", [
    (torch.complex64, 3 ** 15, 1, "dense", 8, True),    # 2187 x 6561
    (torch.complex128, 2278125, 1, "dense", 1, True),   # 1875 x 1215
    (torch.complex128, 1397760, 1, "dense", 2, False),  # 256 x 5460
    (torch.complex64, 1 << 23, 2, "long", 8, False),    # 512 x 16384
    (torch.complex128, 25 << 17, 2, "long", 2, False)])  # 512 x 6400
def test_cuda_split_fold_kernels_match_torch_fft_and_their_gradient(
        cuda, dtype, n, b, rows, cluster, ragged):
    """The split route's pass B with pass C folded in
    (``split.fold_layout``: ``split_fold_dense_kernel`` on dense rows,
    ``split_fold_long_kernel`` / ``split_fold_mixed_kernel`` on long-line
    rows, a cluster's rows stored transposed; the dense rows with a
    ragged P on a cluster and in one block, a complex128 cluster, a mixed
    long row):
    one split call of 2
    launches, the second on the folded kernel, both directions with both
    epilogues against the plain version (``split.emulate``) at the
    kernel's tolerances and ``torch.fft`` within 2e-4; then the gradient
    through ``ops.LineTransform`` (the adjoint, the same route) against
    ``torch.fft``'s within 2e-4."""
    from repro_torch.kernels import split
    plan = split.split_plan(n, dtype)
    layout = split.fold_layout(plan, dtype)
    assert layout is not None and layout.rows == rows, (plan, layout)
    assert layout.cluster == cluster, (plan, layout)
    assert (plan.p % layout.group != 0) == ragged, (plan, layout)
    tol = 5e-6 if dtype == torch.complex64 else 1e-12
    x = torch.from_numpy(cplx((b, n), n)).to(cuda, dtype)
    tw = torch.exp(-1j * math.pi * torch.arange(n, device=cuda)
                   / (2 * n)).to(dtype)
    parts = next(r for r in (2, 3, 5) if n % r == 0)
    for inverse in (False, True):
        lib = (torch.fft.ifft if inverse else torch.fft.fft)(x)
        for t, p in ((None, None), (tw, parts)):
            tfm.reset_launch_counts()
            got = tfm.fft_fourstep(x, inverse=inverse, twiddle=t,
                                   pack_parts=p)
            torch.cuda.synchronize()
            counts = tfm.launch_counts()
            assert counts["launches"] == counts["split"] == 2, counts
            assert counts["fold_" + rows] == 1, counts
            want = tfm.fft_fourstep_plain(x, inverse=inverse, twiddle=t,
                                          pack_parts=p)
            ref = lib if t is None else (lib * t).reshape(b, p, n // p)
            assert_scaled_close(got.cpu().numpy(), want.cpu().numpy(), tol)
            assert_scaled_close(got.cpu().numpy(), ref.cpu().numpy(), 2e-4)
            del got, want, ref
        del lib
    g = torch.from_numpy(cplx((b, n), n + 1)).to(cuda, dtype)
    grads = []
    for fn in (ops.fft1d, torch.fft.fft):
        xx = x.clone().requires_grad_(True)
        (fn(xx) * g).real.sum().backward()
        grads.append(xx.grad)
    assert_scaled_close(grads[0].cpu().numpy(), grads[1].cpu().numpy(),
                        2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("inverse", [False, True])
def test_cuda_long_rule_lengths_match_plain_version_and_torch_fft(
        cuda, dtype, inverse):
    """Every long-line length with a second mixed factor R2
    (``longline.rule_factors``: complex64 3168-16128, complex128 792-8064,
    odd parts 33 to 729): one launch on "long" each, against the plain
    version and ``torch.fft`` at the kernel's tolerances, without an
    epilogue and with both (segments of N/2)."""
    from repro_torch.kernels import longline
    tol = 5e-6 if dtype == torch.complex64 else 1e-12
    rule = [n for n in sorted(longline.FACTORS[dtype])
            if longline.long_plan(n, dtype).mixed_r2]
    assert len(rule) == (90 if dtype == torch.complex64 else 135)
    for n in rule:
        x = torch.from_numpy(cplx((37, n), n)).to(cuda, dtype)
        tw = torch.exp(-1j * math.pi * torch.arange(n, device=cuda)
                       / (2 * n)).to(dtype)
        lib = (torch.fft.ifft if inverse else torch.fft.fft)(x)
        for t, p in ((None, None), (tw, 2)):
            tfm.reset_launch_counts()
            got = tfm.fft_fourstep(x, inverse=inverse, twiddle=t,
                                   pack_parts=p)
            torch.cuda.synchronize()
            assert tfm.fft_fourstep.path_launches["long"] == 1, n
            assert tfm.fft_fourstep.launches == 1, n
            want = tfm.fft_fourstep_plain(x, inverse=inverse, twiddle=t,
                                          pack_parts=p)
            ref = lib if t is None else (lib * t).reshape(37, p, n // p)
            assert_scaled_close(got.cpu().numpy(), want.cpu().numpy(), tol)
            assert_scaled_close(got.cpu().numpy(), ref.cpu().numpy(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_cuda_split_mixed_lengths_match_plain_version_and_torch_fft(
        cuda, dtype):
    """Every mixed split length (rows on the radix route at a mixed Q, or
    on the mixed long-line kernel's body with pass C folded in): one split
    call each, two launches on "split", against the plain
    version (``split.emulate``) and ``torch.fft`` at the kernel's
    tolerances, both directions by turns, with the twiddle and a segment
    of N/r (r the least odd prime of N) by turns."""
    from repro_torch.kernels import split
    tol = 5e-6 if dtype == torch.complex64 else 1e-12
    mixed = [n for n in sorted(split.FACTORS[dtype])
             if not radix.is_pow2(n)]
    for i, n in enumerate(mixed):
        inverse, use_tw = i % 2 == 1, i % 3 == 0
        parts = (next(r for r in (3, 5, 7, 11, 13, 17, 19, 23) if n % r == 0)
                 if i % 2 else None)
        b = max(1, (1 << 24) // (n * dtype.itemsize))
        x = torch.from_numpy(cplx((b, n), i)).to(cuda, dtype)
        tw = (torch.exp(-1j * math.pi * torch.arange(n, device=cuda)
                        / (2 * n)).to(dtype) if use_tw else None)
        tfm.reset_launch_counts()
        got = tfm.fft_fourstep(x, inverse=inverse, twiddle=tw,
                               pack_parts=parts)
        torch.cuda.synchronize()
        counts = tfm.launch_counts()
        long_rows = split.split_plan(n, dtype).row_path == "long"
        assert counts["split_calls"] == 1, n
        assert counts["launches"] == counts["split"] == 2, n
        assert counts["fold_long"] == long_rows, n
        want = tfm.fft_fourstep_plain(x, inverse=inverse, twiddle=tw,
                                      pack_parts=parts)
        lib = (torch.fft.ifft if inverse else torch.fft.fft)(x)
        if tw is not None:
            lib = lib * tw
        if parts is not None:
            lib = lib.reshape(b, parts, n // parts)
        assert_scaled_close(got.cpu().numpy(), want.cpu().numpy(), tol)
        assert_scaled_close(got.cpu().numpy(), lib.cpu().numpy(), tol)
        del x, got, want, lib


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n", [
    (torch.complex64, 8192), (torch.complex64, 16384),
    (torch.complex128, 2048), (torch.complex128, 8192),
    (torch.complex64, 1 << 16), (torch.complex64, 1 << 22),
    (torch.complex128, 1 << 14), (torch.complex128, 1 << 19)])
def test_cuda_power_of_two_long_and_split_unchanged(cuda, dtype, n):
    """The power-of-two long-line and split kernels, whose instantiations
    the mixed lengths leave as they were, still equal their plain versions
    bit for bit, both directions."""
    x = torch.from_numpy(cplx((3, n), 20)).to(cuda, dtype)
    for inverse in (False, True):
        got = tfm.fft_fourstep(x, inverse=inverse)
        want = tfm.fft_fourstep_plain(x, inverse=inverse)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (n, inverse)


@pytest.mark.cuda
def test_fft_conv_at_12288_on_the_split_route(cuda):
    """``fft_conv`` at S=12288 (lines of 24576 = 256 x 96, a mixed Q) on
    the kernel, float32, forward: 3 split calls of 2 launches, no chirp
    call and no line copy; the output within 1e-4 of ``cufft``'s."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.distributed.sharding import ParamBuilder
    from repro_torch.models import ssm
    cfg = dataclasses.replace(smoke_config("jamba_v0_1_52b"),
                              ssm_impl="fft_conv", dtype="float32")
    params = ssm.init_fft_conv(ParamBuilder(0, device=cuda), "ssm", cfg)
    x = torch.from_numpy(np.random.default_rng(21).standard_normal(
        (1, 12288, cfg.d_model)).astype(np.float32)).to(cuda)
    ref, _ = ssm.fft_conv(params, cfg, None, x, fft_backend="cufft")
    tfm.reset_launch_counts()
    ops.copies["lines"] = 0
    got, _ = ssm.fft_conv(params, cfg, None, x, fft_backend="kernel")
    torch.cuda.synchronize()
    counts = tfm.launch_counts()
    assert counts["split_calls"] == 3 and counts["chirp_calls"] == 0, counts
    assert counts["launches"] == counts["split"] == 6, counts
    assert ops.copies["lines"] == 0
    assert_scaled_close(got.cpu().numpy(), ref.cpu().numpy(), 1e-4)


@pytest.mark.cuda
def test_cuda_kernel_empty_batch_launches_nothing(cuda):
    tfm.reset_launch_counts()
    out = tfm.fft_fourstep(torch.zeros((0, 16), dtype=torch.complex64,
                                       device=cuda), pack_parts=4)
    assert out.shape == (0, 4, 4) and tfm.fft_fourstep.launches == 0


@pytest.mark.cuda
def test_kernel_plan_on_the_card(cuda):
    """A 3-D kernel-backend plan on one card: 3 launches per direction,
    forward within 2e-4 of torch.fft.fftn, round trip within 1e-4."""
    from repro_torch import make_mesh, plan_fft
    mesh = make_mesh((1, 1), ("data", "model"))
    assert mesh.device.type == "cuda"
    plan = plan_fft(mesh, (32, 64, 48), backend="kernel")
    x = torch.from_numpy(cplx((32, 64, 48), 9)).to(cuda)
    tfm.reset_launch_counts()
    ops.copies["lines"] = 0
    y = plan.forward(x)
    back = plan.inverse(y, sharded_in=True)
    torch.cuda.synchronize()
    assert tfm.fft_fourstep.launches == 6
    # 32, 64 and the mixed 48 on the radix path (32 and 64 strided, in
    # place)
    assert tfm.fft_fourstep.path_launches == {"radix": 6, "dense": 0,
                                              "long": 0, "split": 0,
                                              "chirp": 0}
    assert tfm.fft_fourstep.layout_launches == {"lines": 2, "strided": 4}
    assert ops.copies["lines"] == 0 and y.is_contiguous()
    assert_scaled_close(y.cpu().numpy(), torch.fft.fftn(x).cpu().numpy(),
                        2e-4)
    assert_scaled_close(back.cpu().numpy(), x.cpu().numpy(), 1e-4)
    assert np.isfinite(y.cpu().numpy()).all()


@pytest.mark.cuda
def test_kernel_plan_at_odd_parts_from_65_on_the_card(cuda):
    """A 3-D kernel-backend plan at (130, 150, 162), odd parts 65, 75 and
    81: every stage on the radix route (2 strided, in place), no dense
    launch, forward within 2e-4 of ``torch.fft.fftn``, round trip within
    1e-4."""
    from repro_torch import make_mesh, plan_fft
    mesh = make_mesh((1, 1), ("data", "model"))
    grid = (130, 150, 162)
    plan = plan_fft(mesh, grid, backend="kernel")
    x = torch.from_numpy(cplx(grid, 10)).to(cuda)
    tfm.reset_launch_counts()
    ops.copies["lines"] = 0
    y = plan.forward(x)
    back = plan.inverse(y, sharded_in=True)
    torch.cuda.synchronize()
    assert tfm.fft_fourstep.path_launches == {"radix": 6, "dense": 0,
                                              "long": 0, "split": 0,
                                              "chirp": 0}
    assert tfm.fft_fourstep.layout_launches == {"lines": 2, "strided": 4}
    assert ops.copies["lines"] == 0 and y.is_contiguous()
    assert_scaled_close(y.cpu().numpy(), torch.fft.fftn(x).cpu().numpy(),
                        2e-4)
    assert_scaled_close(back.cpu().numpy(), x.cpu().numpy(), 1e-4)


@pytest.mark.cuda
def test_poisson_ppb_on_the_card(cuda):
    """The (periodic, periodic, bounded) solve on the kernel backend: the
    DCT-II stage runs the twiddle epilogue once per plane (2 per forward),
    the rest plain four-step lines (2 forward, 4 inverse), and phi matches
    the cufft backend's solve within 2e-4."""
    from repro_torch import PoissonSolver, make_mesh
    mesh = make_mesh((1, 1), ("data", "model"))
    grid = (32, 64, 48)
    topo = ("periodic", "periodic", "bounded")
    rhs = torch.from_numpy(np.random.default_rng(4).standard_normal(grid)
                           .astype(np.float32)).to(cuda)
    rhs -= rhs.mean()
    solver = PoissonSolver(mesh, grid, topology=topo, backend="kernel")
    tfm.reset_launch_counts()
    phi = solver(rhs)
    torch.cuda.synchronize()
    assert tfm.fft_fourstep.variant_launches == {"fourstep": 6, "pack": 0,
                                                 "twiddle": 2}
    # the bounded dim (48, mixed: its 2 twiddle launches and the 2 inverse
    # ones) and the dims of 32 and 64 all take the radix path
    assert tfm.fft_fourstep.path_launches == {"radix": 8, "dense": 0,
                                              "long": 0, "split": 0,
                                              "chirp": 0}
    assert phi.dtype == torch.float32 and phi.device.type == "cuda"
    want = PoissonSolver(mesh, grid, topology=topo, backend="cufft")(rhs)
    assert_scaled_close(phi.cpu().numpy(), want.cpu().numpy(), 2e-4)



@pytest.mark.cuda
@pytest.mark.parametrize("n_chunks,fwd_launches,inv_launches",
                         [(2, 5, 5), ((4, 2), 7, 7)])
def test_chunked_kernel_plan_matches_bulk_on_the_card(cuda, n_chunks,
                                                      fwd_launches,
                                                      inv_launches):
    """A chunked kernel plan runs one launch per chunk of each hop's next
    stage and matches the bulk plan within 5e-6 (max-scaled)."""
    from repro_torch import make_mesh, plan_fft
    mesh = make_mesh((1, 1), ("data", "model"))
    grid = (32, 64, 128)
    bulk = plan_fft(mesh, grid, backend="kernel")
    plan = plan_fft(mesh, grid, backend="kernel", n_chunks=n_chunks)
    x = torch.from_numpy(cplx(grid, 10)).to(cuda)
    tfm.reset_launch_counts()
    y = plan.forward(x)
    torch.cuda.synchronize()
    assert tfm.fft_fourstep.launches == fwd_launches
    back = plan.inverse(y, sharded_in=True)
    torch.cuda.synchronize()
    assert tfm.fft_fourstep.launches == fwd_launches + inv_launches
    assert tfm.fft_fourstep.path_launches["dense"] == 0
    yb = bulk.forward(x)
    assert_scaled_close(y.cpu().numpy(), yb.cpu().numpy(), 5e-6)
    assert_scaled_close(back.cpu().numpy(),
                        bulk.inverse(yb, sharded_in=True).cpu().numpy(), 5e-6)


@pytest.mark.cuda
def test_cuda_event_timer_and_tuner_on_the_card(cuda, tmp_path):
    """``perfmodel._time_best`` times with CUDA events after a warm-up; a
    GPU-bound call times longer than a tenth of it; calibration and a
    tuned plan run on the card, keyed by the card's name."""
    from repro_torch import make_mesh, plan_fft
    from repro_torch.core import perfmodel
    from repro_torch.core.plan import TuningCache
    big = torch.randn((1 << 24,), device=cuda)
    small = big[: 1 << 20]
    t_big = perfmodel._time_best(lambda: big * 2.0, 3, cuda)
    t_small = perfmodel._time_best(lambda: small * 2.0, 3, cuda)
    assert 0 < t_small < t_big
    mesh = make_mesh((1, 1), ("data", "model"))
    prof = perfmodel.calibrate(mesh, n=64, batch=256, repeats=2)
    assert prof.platform == torch.cuda.get_device_name(cuda)
    assert not prof.net_calibrated and prof.base == perfmodel.H100_SXM
    assert set(dict(prof.backend_flops)) == {"cufft", "matmul", "kernel"}
    cache = TuningCache(str(tmp_path / "tuning.json"))
    plan = plan_fft(mesh, (32, 64, 128), tuning="auto", tune_cache=cache)
    assert plan.tuned.measured_s <= plan.tuned.baseline_s
    x = torch.from_numpy(cplx((32, 64, 128), 11)).to(cuda)
    assert_scaled_close(plan.forward(x).cpu().numpy(),
                        torch.fft.fftn(x).cpu().numpy(), 2e-4)


@pytest.mark.cuda
def test_chunked_and_tuned_plans_on_four_cards(cuda, tmp_path):
    """On a 2x2 mesh of cards over NCCL: bulk and chunked plans (chunk
    k+1's exchange in flight under chunk k's stage) match torch.fft.fftn
    at 2e-4 and their own bulk plan at 5e-6, round trips at 1e-4, and the
    ranks of ``tuning="auto"`` agree on one plan and one profile."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards")
    grid = (256, 256, 256)
    x = cplx(grid, 14)
    x_path = str(tmp_path / "x.npy")
    np.save(x_path, x)
    out_dir = run_ranks("nccl_body", 4, tmp_path, x_path, grid,
                        str(tmp_path / "wisdom" / "tuning.json"), 10,
                        backend="nccl")
    recs = []
    for rank in range(4):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
            recs.append(json.load(f))
    ref = np.fft.fftn(x)

    def load(name):
        return np.load(os.path.join(out_dir, f"{name}.npy"))

    for name in recs[0]["cases"]:
        assert_scaled_close(load(f"fwd_{name}"), ref, 2e-4)
        assert_scaled_close(load(f"rt_{name}"), x, 1e-4)
        backend = name.split("_")[0]
        assert_scaled_close(load(f"fwd_{name}"), load(f"fwd_{backend}_1"),
                            5e-6)
    for rec in recs:
        assert rec["tuned"] == recs[0]["tuned"]
        assert rec["profile"] == recs[0]["profile"]
    assert_scaled_close(load("fwd_tuned"), ref, 2e-4)
    print(json.dumps({"card": recs[0]["card"],
                      "fwd_ms": {n: [r["cases"][n]["fwd_ms"] for r in recs]
                                 for n in recs[0]["cases"]},
                      "tuned": recs[0]["tuned"],
                      "net_alpha_s": recs[0]["profile"]["net_alpha_s"],
                      "net_bw": recs[0]["profile"]["net_bw"]}))


@pytest.mark.cuda
def test_executor_mixed_queue_on_four_cards(cuda, tmp_path):
    """On a 2x2 mesh of cards over NCCL: the mixed queue (two batched 2-D
    entries, a chunked 256^3 kernel forward and its inverse) gives outputs
    bitwise equal to the solo runs in the async, pool and timed modes,
    with no hang (the dispatch order is the same on every rank), and
    donation empties only the donated operand.  Prints the interleaved
    time against the solo sum per rank."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards")
    out_dir = run_ranks("executor_body", 4, tmp_path, None, (256, 256, 256),
                        (16, 512, 512), (2, 2), 10, backend="nccl")
    recs = []
    for rank in range(4):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
            recs.append(json.load(f))
    for rec in recs:
        for mode in ("async", "pool", "timed"):
            assert rec[mode] == [True] * 4, (mode, rec[mode])
        assert rec["donation"] == {"donated_emptied": True,
                                   "neighbours_intact": True,
                                   "outputs_bitwise": True}
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "solo_sum_ms": [sum(r["solo_ms"]) for r in recs],
                      "solo_ms": [r["solo_ms"] for r in recs],
                      "interleaved_async_ms": [r["interleaved_async_ms"]
                                               for r in recs],
                      "interleaved_pool_ms": [r["interleaved_pool_ms"]
                                              for r in recs]}))


@pytest.mark.cuda
def test_sanitized_executor_queue_on_four_cards(cuda, tmp_path):
    """On a 2x2 mesh of cards over NCCL: the executor's mixed queue (two
    batched 2-D entries, a chunked 256^3 kernel forward and its inverse)
    plus a donated entry under ``verify="strict", sanitize=True`` in the
    async, pool and timed modes: no verify error, 0 SAN001 (the ranks'
    all-gathered launch orders included), every rank's trace order equal
    to the others', outputs bitwise equal to the solo runs; a rank that
    reports another order is caught on every rank; an unserialized pool
    queue is refused before anything launches."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards")
    out_dir = run_ranks("analysis_body", 4, tmp_path, None, (256, 256, 256),
                        (16, 512, 512), (2, 2), backend="nccl")
    recs = []
    for rank in range(4):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
            recs.append(json.load(f))
    for rank, rec in enumerate(recs):
        for mode in ("async", "pool", "timed"):
            r = rec[mode]
            assert r["bitwise"] == [True] * 5, (rank, mode, r["bitwise"])
            assert r["sanitize"] == [] and r["san001"] == 0, (rank, mode)
            assert r["verify_errors"] == [] and r["donated_emptied"]
            assert r["order"] == recs[0][mode]["order"], (rank, mode)
        skewed = [w for code, w in rec["skewed"] if code == "SAN001"]
        assert any(w.startswith("ranks@") for w in skewed), rank
        u = rec["unserialized"]
        assert [c for c, _ in u["refused"]] == ["SCHED001"]
        assert u["queued"] == 5 and all(u["outs"])
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "launches": len(recs[0]["async"]["order"]),
                      "timed_findings": recs[0]["timed"]["verify_errors"]}))


@pytest.mark.cuda
def test_service_loses_one_of_four_cards(cuda, tmp_path):
    """``serve_fft`` on 4 cards over NCCL loses one mid-stream: every
    result within 1e-4 of ``torch.fft.fftn``, the recovered service equal
    to a fresh service on the survivors-only (2, 1) mesh bitwise, hit rate
    >= 0.8, a warmed first drain that builds nothing; the ranks left
    outside the degraded mesh refuse work."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards")
    kwargs = dict(requests=24, round_size=8, lose=1, seed=0, check=True,
                  primary=(256, 256), secondary=(256, 512),
                  odd=((250, 250), (240, 256), (256, 250)),
                  bucket_edges=(128, 256, 512), max_batch=4, verbose=False)
    out_dir = run_ranks("serve_body", 4, tmp_path, kwargs, backend="nccl")
    recs = []
    for rank in range(4):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
            recs.append(json.load(f))
    for rec in recs[:2]:
        drv = rec["driver"]
        assert drv["fresh_mesh_bitwise_ok"] and drv["max_rel_err"] < 1e-4
        assert drv["degraded_mesh"] == [2, 1]
        assert rec["plan_cache"]["hit_rate"] >= 0.8
        assert drv["first_drain"] == {"plan_builds": 0, "kernel_loads": 0}
    assert [r["lose_check"]["lost"] for r in recs] == [False, False, True,
                                                       True]
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "latency_ms": {k: recs[0]["latency"][k] * 1e3
                                     for k in ("p50_s", "p99_s")},
                      "rps": recs[0]["driver"]["rps"],
                      "degraded_rps": recs[0]["degraded_throughput_rps"],
                      "families": recs[0]["driver"]["families"]}))


def _scaled(got, ref) -> float:
    ref = ref.float().cpu()
    return float((got.float().cpu() - ref).abs().max()) \
        / max(float(ref.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3_8b", "jamba_v0_1_52b",
                                  "seamless_m4t_medium"])
def test_lm_smoke_prefill_and_decode_on_the_card(cuda, arch):
    """A smoke config's prefill and 3 greedy decode steps on the card
    against the same port code and weights on the CPU, in float32: logits
    within 1e-4 max-scaled and equal greedy tokens."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.launch.steps import (build_params, make_decode_step,
                                          make_prefill_step)
    from repro_torch.models.transformer import pad_caches

    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    cpu = torch.device("cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 32)))}
    if cfg.modality == "audio":
        batch["modality_embeds"] = torch.as_tensor(
            rng.standard_normal((2, 32, cfg.d_model)), dtype=torch.float32)
    runs = {}
    for dev in (cpu, cuda):
        model = build_params(cfg, device=cpu).to(dev)
        last, caches = make_prefill_step(cfg, device=dev)(model, batch)
        caches = pad_caches(caches, cfg, 36)
        step = make_decode_step(cfg, device=dev)
        logits, toks = [last], []
        cur = (runs[cpu][1][0] if dev == cuda
               else last.argmax(-1))[:, None]
        for i in range(3):
            nxt, lg, caches = step(model, caches, cur.to(dev), 32 + i)
            logits.append(lg)
            toks.append(nxt.cpu())
            cur = (runs[cpu][1][i + 1] if dev == cuda else nxt)[:, None]
        runs[dev] = (logits, [last.argmax(-1).cpu()] + toks)
    for got, ref in zip(runs[cuda][0], runs[cpu][0]):
        assert _scaled(got, ref) < 1e-4
    for got, ref in zip(runs[cuda][1], runs[cpu][1]):
        assert torch.equal(got, ref)


@pytest.mark.cuda
def test_fft_conv_kernel_on_the_card(cuda):
    """``ssm.fft_conv`` with ``fft_backend="kernel"`` at a smoke width:
    exactly 3 radix launches on lines, no line copy, and the output within
    1e-4 of ``"cufft"``."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.distributed.sharding import ParamBuilder
    from repro_torch.models.ssm import FFTConv

    cfg = dataclasses.replace(smoke_config("jamba_v0_1_52b"),
                              ssm_impl="fft_conv", dtype="float32")
    mixer = FFTConv(ParamBuilder(0, device=cuda), "ssm", cfg)
    x = torch.randn((2, 64, cfg.d_model), device=cuda)
    ref, _ = mixer(x, fft_backend="cufft")
    tfm.reset_launch_counts()
    copies = ops.copies["lines"]
    got, _ = mixer(x, fft_backend="kernel")
    torch.cuda.synchronize()
    counts = tfm.launch_counts()
    assert counts["launches"] == counts["radix"] == counts["lines"] == 3
    assert ops.copies["lines"] == copies
    assert _scaled(got, ref) < 1e-4


@pytest.mark.cuda
def test_fft_conv_grad_kernel_on_the_card(cuda):
    """``fft_conv``'s gradients on ``fft_backend="kernel"`` at a smoke width
    against the ``"cufft"`` backend's (torch.fft autograd), within 1e-4
    max-scaled, with exactly 6 radix launches on lines (3 forward, 3
    backward) and no line copy."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.distributed.sharding import ParamBuilder
    from repro_torch.models.ssm import FFTConv

    cfg = dataclasses.replace(smoke_config("jamba_v0_1_52b"),
                              ssm_impl="fft_conv", dtype="float32")
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((2, 64, cfg.d_model), device=cuda, generator=gen)
    r = torch.randn((2, 64, cfg.d_model), device=cuda, generator=gen)
    grads = {}
    for backend in ("cufft", "kernel"):
        mixer = FFTConv(ParamBuilder(0, device=cuda), "ssm", cfg)
        mixer.requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        tfm.reset_launch_counts()
        copies = ops.copies["lines"]
        y, _ = mixer(xx, fft_backend=backend)
        (y * r).sum().backward()
        torch.cuda.synchronize()
        counts = tfm.launch_counts()
        grads[backend] = {n: p.grad for n, p in mixer.named_parameters()}
        grads[backend]["x"] = xx.grad
    assert counts["launches"] == counts["radix"] == counts["lines"] == 6
    assert ops.copies["lines"] == copies
    for name, ref in grads["cufft"].items():
        assert _scaled(grads["kernel"][name], ref) < 1e-4, name


@pytest.mark.cuda
def test_fft_conv_grad_epilogues_raise_on_the_card(cuda):
    """The twiddle and pack epilogues raise under grad on a CUDA tensor
    (before any launch), and run under ``torch.no_grad``."""
    x = torch.randn((4, 64), dtype=torch.complex64, device=cuda,
                    requires_grad=True)
    tw = torch.ones(64, dtype=torch.complex64, device=cuda)
    tfm.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="twiddle"):
        ops.fft1d(x, -1, twiddle=tw)
    with pytest.raises(NotImplementedError, match="pack_parts"):
        ops.fft1d(x, -1, pack_parts=2)
    with pytest.raises(NotImplementedError, match="pack_parts"):
        ops.packed_fft1d(x, -1, 2)
    assert tfm.fft_fourstep.launches == 0
    with torch.no_grad():
        ops.fft1d(x, -1, twiddle=tw)
    torch.cuda.synchronize()
    assert tfm.fft_fourstep.variant_launches["twiddle"] == 1


@pytest.mark.cuda
def test_train_step_smoke_on_the_card(cuda):
    """One 2-layer smoke train step (qwen3-8b's smoke config in float32) on
    the card against the same step on the CPU, from the same weights and
    batch: loss within 1e-4 relative, every gradient leaf within 1e-4
    max-scaled, and the parameters after the AdamW update within ``lr *
    (1e-5 + eps * dg / (|g| + eps)**2)``: the first step moves an entry
    by ``lr * g / (|g| + eps)``, and ``dg``, the gradient tolerance (1e-4
    of the leaf's largest entry), moves that by the second term where
    ``|g|`` is near ``eps``."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import (build_params, loss_and_grads,
                                          make_train_step)
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.convert import param_leaves
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = dataclasses.replace(smoke_config("qwen3_8b"), dtype="float32",
                              n_layers=2)
    cpu = torch.device("cpu")
    host = SyntheticLM(cfg, ShapeConfig("t", "train", 64, 2)) \
        .batch_for_step(0)
    opt = AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    runs = {}
    for dev in (cpu, cuda):
        model = build_params(cfg, device=cpu).to(dev)
        batch = SyntheticLM.to_device(host, dev)
        loss, _, grads = loss_and_grads(model, cfg, None, batch)
        state = adamw_init(param_leaves(model), opt)
        make_train_step(cfg, None, opt, grad_compress=False, device=dev)(
            model, state, batch)
        runs[dev] = (float(loss), grads,
                     {k: p.detach().cpu()
                      for k, p in param_leaves(model).items()})
    assert runs[cuda][0] == pytest.approx(runs[cpu][0], rel=1e-4)
    for k, g in runs[cpu][1].items():
        assert _scaled(runs[cuda][1][k], g) < 1e-4, k
    lr, eps = opt.lr_peak, opt.eps
    for k, p in runs[cpu][2].items():
        g = runs[cpu][1][k].abs()
        bound = lr * (1e-5 + eps * 1e-4 * float(g.max()) / (g + eps) ** 2)
        assert bool(((runs[cuda][2][k] - p).abs() <= bound).all()), k


# ---------------------------------------------------------------------------
# the LM sharded over a ("data", "model") mesh
# ---------------------------------------------------------------------------

def _card_record(name: str, rec: dict) -> None:
    """Keep an LM card test's record under ``chiprun_out/`` and print
    it."""
    root = os.path.join(os.path.dirname(__file__), "..", "chiprun_out")
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, f"{name}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec))


@pytest.mark.cuda
def test_lm_one_card_mesh_matches_no_mesh(cuda, tmp_path):
    """The mesh path on one card (an NCCL group of one, a (1, 1) mesh)
    serves the same tokens and trains the same losses, bit for bit, as no
    mesh: every collective is skipped on an axis of one rank."""
    out = run_ranks("lm_mesh_one_card_body", 1, tmp_path, backend="nccl")
    with open(os.path.join(out, "rank0.json")) as f:
        rec = json.load(f)
    assert rec["serve"][0] == rec["serve"][1]
    assert rec["train"][0] == rec["train"][1]
    assert all(math.isfinite(v) for v in rec["train"][0])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,batch,record", [
    ((1, 4), 1, "train36_1x4"), ((2, 2), 2, "train36_2x2"),
    ((1, 4), 2, "train36_1x4_b2")], ids=["1x4", "2x2", "1x4_b2"])
def test_qwen3_train_36_layers_on_four_cards(cuda, tmp_path, shape, batch,
                                             record):
    """qwen3-8b at its published widths and all 36 layers (about 131 GB of
    training state, a quarter on each card), ``train_4k``'s S=4096 with
    the batch cut from 256 to ``batch``: 5 steps, remat, bf16 gradients,
    ``AdamWConfig()``; losses finite and falling, the same seed twice
    bitwise equal, every rank reporting the same losses.  The record
    holds each training batch's loss before the first update and after
    the last (``torch_harness.held_losses``): what the updates did, apart
    from how the loss varies from batch to batch.  ``1x4_b2`` trains
    (1, 4) on (2, 2)'s data (B=2: the same two rows per step), so that
    the two meshes' losses can be compared directly."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards")
    out = run_ranks("lm_train_cards_body", 4, tmp_path, list(shape), batch,
                    4096, 5, backend="nccl")
    recs = []
    for rank in range(4):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            recs.append(json.load(f))
    first, again = recs[0]["runs"]
    _card_record(record, {
        "card": recs[0]["card"], "shape": list(shape), "batch": batch,
        "seq": 4096, "layers": recs[0]["layers"],
        "losses": first["losses"], "losses_again": again["losses"],
        "step_ms": [r["runs"][0]["step_ms"] for r in recs],
        "step_ms_again": [r["runs"][1]["step_ms"] for r in recs],
        "peak_bytes": [r["runs"][0]["peak_bytes"] for r in recs],
        "param_bytes": [r["runs"][0]["param_bytes"] for r in recs],
        "held": first["held"],
        "profile": [r["runs"][0]["profile"] for r in recs]})
    losses = first["losses"]
    assert recs[0]["layers"] == 36
    assert all(math.isfinite(v) for v in losses)
    assert losses[-1] < losses[0], losses
    assert again["losses"] == losses
    assert all(r["runs"][0]["losses"] == losses for r in recs)


@pytest.mark.cuda
def test_qwen3_8_layers_updates_lower_held_losses_on_the_card(cuda):
    """``[train]``'s setup on one card (qwen3-8b's widths at 8 of 36
    layers, B=1, S=4096, remat, bf16 gradients, ``AdamWConfig()``, 5
    steps): the 5 training batches' mean loss is lower after the updates
    than before them.  The steps' own losses read a new batch each; the
    record holds both, to tell the updates from the batches' spread."""
    import dataclasses

    from repro_torch.configs import get_config
    from torch_harness import card_name, train_losses
    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=8)
    rec = train_losses(cfg, 5, device=cuda)
    torch.cuda.empty_cache()
    _card_record("held8_one_card", {"card": card_name(), **rec})
    assert all(math.isfinite(v) for v in rec["losses"] + rec["held_after"])
    # the first step's loss is the first batch's before any update
    assert math.isclose(rec["held_before"][0], rec["losses"][0],
                        rel_tol=1e-5)
    assert sum(rec["held_after"]) < sum(rec["held_before"]), rec


@pytest.mark.cuda
def test_qwen3_full_width_on_four_cards_matches_one_card(cuda, tmp_path):
    """qwen3-8b's published widths on ``make_host_mesh()``'s (1, 4)
    against one card: one float32 step at 2 layers (S=256), the loss
    within 1e-5 relative and the gradient leaves within 1e-4 max-scaled
    (``[train]``'s card-vs-CPU gate); and ``[train]``'s 8-layer bf16 run
    (B=1, S=4096, 5 steps) recorded on both, with each training batch's
    loss before and after the updates."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards")
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models.config import SHAPES
    from torch_harness import (GRAD_LEAVES, card_name, full_width_grads,
                               train_losses)
    full = get_config("qwen3-8b")
    cut = dataclasses.replace(full, n_layers=2, dtype="float32")
    host = SyntheticLM(cut, SHAPES["train_4k"], seed=0, batch_override=1,
                       seq_override=256).batch_for_step(0)
    one = full_width_grads(cut, None, SyntheticLM.to_device(host, cuda),
                           device=cuda)
    torch.cuda.empty_cache()
    one8 = train_losses(dataclasses.replace(full, n_layers=8), 5,
                        device=cuda)
    torch.cuda.empty_cache()
    out = run_ranks("lm_check_cards_body", 4, tmp_path, 5, backend="nccl")
    got = np.load(os.path.join(out, "grads.npz"))
    with open(os.path.join(out, "rank0.json")) as f:
        rec = json.load(f)
    errs = {k: float(np.abs(got[k] - one[k]).max()
                     / max(np.abs(one[k]).max(), 1e-30))
            for k in one if k != "loss"}
    loss_rel = abs(float(got["loss"]) - one["loss"]) / abs(one["loss"])
    _card_record("check_1x4", {
        "card": card_name(), "loss_rel": loss_rel, "grad_errs": errs,
        "train8_one_card": one8, "train8_1x4": rec})
    assert set(errs) == {f"{p}|{r}" for p, r in GRAD_LEAVES}
    assert loss_rel < 1e-5
    assert all(e < 1e-4 for e in errs.values()), errs
    assert all(math.isfinite(v) for v in rec["losses"] + one8["losses"])


@pytest.mark.cuda
def test_qwen3_serve_36_layers_on_four_cards(cuda, tmp_path):
    """qwen3-8b at full width and depth served on ``make_host_mesh()``'s
    (1, 4) with the serve CLI's defaults against one card: the first
    token of every request equal, the prefill logits within 1e-2
    max-scaled, every rank the same tokens; the top-2 logit margins where
    later tokens differ are recorded."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards")
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_params, make_prefill_step
    from torch_harness import card_name, greedy_trace
    cfg = get_config("qwen3-8b")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32))
    np.save(tmp_path / "prompts.npy", prompts)
    dev = torch.device("cuda", torch.cuda.current_device())
    model = build_params(cfg, seed=0, device=cuda)
    one = greedy_trace(model, cfg, None, torch.as_tensor(prompts), 16, dev)
    # float32 activations on the same masters: where the bf16 runs'
    # rounding is measured from
    f32 = dataclasses.replace(cfg, dtype="float32")
    truth = make_prefill_step(f32, None, device=dev)(
        model, {"tokens": torch.as_tensor(prompts).to(dev)})[0]
    truth = truth.float().cpu().numpy()
    del model
    torch.cuda.empty_cache()
    out = run_ranks("lm_serve_cards_body", 4, tmp_path,
                    str(tmp_path / "prompts.npy"), 16, backend="nccl")
    recs = []
    for rank in range(4):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            recs.append(json.load(f))
    logits = np.load(os.path.join(out, "prefill_logits.npy"))
    ref = one["prefill_logits"].numpy()
    err = float(np.abs(logits - ref).max() / np.abs(ref).max())

    def from_truth(x):
        return float(np.abs(x - truth).max() / np.abs(truth).max())
    toks, want = recs[0]["tokens"], one["tokens"]
    differ = [(r, i, one["margins"][r][i], recs[0]["margins"][r][i])
              for r in range(len(want)) for i in range(len(want[r]))
              if toks[r][i] != want[r][i]]
    _card_record("serve36_1x4", {
        "card": recs[0]["card"], "card_one": card_name(),
        "prefill_scaled_err": err,
        "one_card_bf16_vs_f32": from_truth(ref),
        "four_cards_bf16_vs_f32": from_truth(logits),
        "tokens": toks, "one_card_tokens": want,
        "first_differ": differ[:8], "n_differ": len(differ),
        "decode_ms": recs[0]["decode_ms"],
        "one_card_decode_ms": one["decode_ms"],
        "peak_bytes": [r["peak_bytes"] for r in recs],
        "param_bytes": [r["param_bytes"] for r in recs]})
    assert all(r["tokens"] == toks and r["serve_tokens"] ==
               recs[0]["serve_tokens"] for r in recs)
    assert len(recs[0]["serve_tokens"]) == 8
    assert recs[0]["serve_tokens"][:4] == toks
    assert [t[0] for t in toks] == [t[0] for t in want]
    assert err < 1e-2


@pytest.mark.cuda
def test_fft_conv_sharded_on_four_cards(cuda, tmp_path):
    """``fft_conv`` at jamba-v0.1-52b's mixer width, 8192 channels split
    2048 per card over ``make_host_mesh()``'s (1, 4), S=2048, float32,
    forward and backward on the kernel: 6 radix launches on lines per rank
    and no line copy, the gathered gradients within 1e-4 of one card's."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards")
    out = run_ranks("fft_conv_cards_body", 4, tmp_path, 1, 2048,
                    backend="nccl")
    recs = []
    for rank in range(4):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            recs.append(json.load(f))
    _card_record("fft_conv_1x4", {
        "card": recs[0]["card"], "counts": [r["counts"] for r in recs],
        "grad_errs": [r["grad_errs"] for r in recs],
        "sharded_ms": [r["sharded_ms"] for r in recs],
        "one_card_ms": [r["one_card_ms"] for r in recs],
        "channels_per_card": recs[0]["channels_per_card"]})
    for r in recs:
        assert r["channels_per_card"] == 2048
        # lines of 4096: the long route's wide kernel
        assert r["counts"] == {"launches": 6, "long": 6, "lines": 6,
                               "copies": 0}, r["counts"]
        assert all(e < 1e-4 for e in r["grad_errs"].values()), r
