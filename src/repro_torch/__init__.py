"""PyTorch/CUDA port of the distributed FFT framework in ``repro``.

The package mirrors ``src/repro/`` module for module and imports no JAX.
Entry points run on CUDA unless the caller passes ``device="cpu"``
(``compat.make_mesh``); the local line transforms go through a
hand-written four-step CUDA kernel (``backend="kernel"``), cuFFT
(``"cufft"``) or einsum contractions (``"matmul"``).  ``PoissonSolver``
runs the Oceananigans-style pressure solve on one paired plan.  Hops may
be chunk-pipelined (``n_chunks``), and ``tuning="heuristic"``/``"auto"``
let the tuner pick the schedule, with its decisions kept in the port's own
wisdom file (``TuningCache``).  ``PlanStreamExecutor`` runs a queue of
plans as interleaved stage segments on CUDA streams, and ``serving``'s
``FFTService`` (driven by ``launch/serve_fft.py``) serves mixed-shape
traffic on warmed plans and survives the loss of ranks.
"""
from .compat import Mesh, gather, local_block, make_mesh
from .core import (DistributedFFT, PlanStreamExecutor, PoissonSolver,
                   TunedPlan, TuningCache, execute_many, fft2d, fft3d, fftnd,
                   ifft2d, ifft3d, ifftnd, plan_fft, poisson_eigenvalues,
                   poisson_solve, tune)

__all__ = ["Mesh", "make_mesh", "local_block", "gather", "DistributedFFT",
           "TunedPlan", "TuningCache", "tune", "plan_fft", "fftnd",
           "ifftnd", "fft2d", "ifft2d", "fft3d", "ifft3d", "PoissonSolver",
           "poisson_solve", "poisson_eigenvalues", "PlanStreamExecutor",
           "execute_many"]
