# The distributed FFT framework on PyTorch: stage-specific decompositions,
# bulk redistribution over torch.distributed, plan caching, the plan API and
# the spectral Poisson solver.
from .api import (DistributedFFT, PoissonSolver, clear_plan_memo, fft2d,
                  fft3d, fftnd, ifft2d, ifft3d, ifftnd, plan_cache_stats,
                  plan_fft, poisson_eigenvalues, poisson_solve)
from .decomp import (Decomposition, RedistHop, Redistribution, StageLayout,
                     default_dim_groups, hybrid_nd, local_shape,
                     make_decomposition, pencil, pencil_nd, slab, slab_nd,
                     validate_grid)
from .pipeline import (PipelineSpec, TensorStruct, build_pipeline,
                       effective_grid, input_struct, make_spec,
                       output_struct)
from .plan import GLOBAL_PLAN_CACHE, PlanCache, TunedPlan, plan_key
from .redistribute import (PackedBlock, free_chunk_dim, redistribute,
                           send_buffer, transpose_cost_bytes)
from . import transforms

__all__ = [
    "DistributedFFT", "plan_fft", "plan_cache_stats", "clear_plan_memo",
    "fft3d", "ifft3d", "fft2d", "ifft2d", "fftnd", "ifftnd",
    "PoissonSolver", "poisson_solve", "poisson_eigenvalues",
    "Decomposition", "RedistHop", "Redistribution", "StageLayout",
    "default_dim_groups", "hybrid_nd", "local_shape",
    "make_decomposition", "pencil", "pencil_nd", "slab", "slab_nd",
    "validate_grid",
    "PipelineSpec", "TensorStruct", "build_pipeline", "effective_grid",
    "input_struct", "make_spec", "output_struct",
    "GLOBAL_PLAN_CACHE", "PlanCache", "TunedPlan", "plan_key",
    "PackedBlock", "free_chunk_dim", "redistribute", "send_buffer",
    "transpose_cost_bytes", "transforms",
]
