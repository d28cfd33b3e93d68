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
    tol = 5e-6 if dtype == torch.complex64 else 1e-12
    assert_scaled_close(got.cpu().numpy(), want.cpu().numpy(), tol)
    if parts is not None:
        assert got.transpose(0, 1).is_contiguous()


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
    y = plan.forward(x)
    back = plan.inverse(y, sharded_in=True)
    torch.cuda.synchronize()
    assert tfm.fft_fourstep.launches == 6
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
    assert phi.dtype == torch.float32 and phi.device.type == "cuda"
    want = PoissonSolver(mesh, grid, topology=topo, backend="cufft")(rhs)
    assert_scaled_close(phi.cpu().numpy(), want.cpu().numpy(), 2e-4)

