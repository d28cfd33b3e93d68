"""Tests that need an NVIDIA GPU: the CUDA four-step kernel against its
plain version, and the kernel-backend plan on the card.  They skip where
CUDA is absent.  This file imports no JAX, so on a GPU machine without
JAX it runs with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import fft_matmul as tfm
from repro_torch.kernels import ops, radix
from torch_harness import assert_scaled_close, cplx


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
    ((7, 521), torch.complex64, None, False),      # W2 streamed from L2
    ((300, 64), torch.complex64, 8, False),         # ragged last tile
    ((5, 48), torch.complex128, 2, True),
    ((67, 4096), torch.complex64, None, True),      # radix, N1 = N2 = 64
    ((33, 2), torch.complex64, 2, False),           # radix, N1 = 1
    ((130, 512), torch.complex128, 4, True),        # radix complex128
    ((9, 2048), torch.complex128, None, False),     # dense: no c128 codelet
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
    assert tfm.fft_fourstep.launches == 1
    path = radix.kernel_path(n, dtype)
    assert tfm.fft_fourstep.path_launches[path] == 1
    tol = 5e-6 if dtype == torch.complex64 else 1e-12
    assert_scaled_close(got.cpu().numpy(), want.cpu().numpy(), tol)
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
    assert tfm.fft_fourstep.path_launches == {"radix": 1, "dense": 0}
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
    # 32 and 64 on the radix path (strided, in place), 48 on the dense one
    assert tfm.fft_fourstep.path_launches == {"radix": 4, "dense": 2}
    assert tfm.fft_fourstep.layout_launches == {"lines": 2, "strided": 4}
    assert ops.copies["lines"] == 0 and y.is_contiguous()
    assert_scaled_close(y.cpu().numpy(), torch.fft.fftn(x).cpu().numpy(),
                        2e-4)
    assert_scaled_close(back.cpu().numpy(), x.cpu().numpy(), 1e-4)
    assert np.isfinite(y.cpu().numpy()).all()


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
    # the bounded dim (48) takes the dense path: its 2 twiddle launches and
    # the 2 inverse ones; dims of 32 and 64 the radix path
    assert tfm.fft_fourstep.path_launches == {"radix": 4, "dense": 4}
    assert phi.dtype == torch.float32 and phi.device.type == "cuda"
    want = PoissonSolver(mesh, grid, topology=topo, backend="cufft")(rhs)
    assert_scaled_close(phi.cpu().numpy(), want.cpu().numpy(), 2e-4)

