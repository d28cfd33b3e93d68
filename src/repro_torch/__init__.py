"""PyTorch/CUDA port of the distributed FFT framework in ``repro``.

The package mirrors ``src/repro/`` module for module and imports no JAX.
Entry points run on CUDA unless the caller passes ``device="cpu"``
(``compat.make_mesh``); the local line transforms go through a
hand-written four-step CUDA kernel (``backend="kernel"``), cuFFT
(``"cufft"``) or einsum contractions (``"matmul"``).  ``PoissonSolver``
runs the Oceananigans-style pressure solve on one paired plan.
"""
from .compat import Mesh, gather, local_block, make_mesh
from .core import (DistributedFFT, PoissonSolver, TunedPlan, fft2d, fft3d,
                   fftnd, ifft2d, ifft3d, ifftnd, plan_fft,
                   poisson_eigenvalues, poisson_solve)

__all__ = ["Mesh", "make_mesh", "local_block", "gather", "DistributedFFT",
           "TunedPlan", "plan_fft", "fftnd", "ifftnd", "fft2d", "ifft2d",
           "fft3d", "ifft3d", "PoissonSolver", "poisson_solve",
           "poisson_eigenvalues"]
