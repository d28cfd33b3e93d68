# The distributed FFT framework on PyTorch: stage-specific decompositions,
# chunk-pipelined redistribution over torch.distributed, plan caching, the
# plan API and the spectral Poisson solver, the tuner that picks the
# schedule (scheduler policy engine, calibrated perf model, wisdom cache),
# and the plan-stream executor that interleaves plans' stage segments.
from .api import (DistributedFFT, PoissonSolver, clear_plan_memo, fft2d,
                  fft3d, fftnd, ifft2d, ifft3d, ifftnd, plan_cache_stats,
                  plan_fft, poisson_eigenvalues, poisson_solve)
from .executor import PlanStreamExecutor, SegmentTask, execute_many
from .decomp import (Decomposition, RedistHop, Redistribution, StageLayout,
                     default_dim_groups, hybrid_nd, local_shape,
                     make_decomposition, pencil, pencil_nd, slab, slab_nd,
                     validate_grid)
from .perfmodel import (Machine, MachineProfile, calibrate, hop_cost_terms,
                        predict_plan_time, profile_from_machine,
                        stage_comp_times)
from .pipeline import (PipelineSpec, TensorStruct, build_pipeline,
                       build_segment, compile_segment, effective_grid,
                       input_struct, make_spec, n_segments, output_struct,
                       segment_in_spec, segment_out_spec, segment_structs)
from .plan import (GLOBAL_PLAN_CACHE, PlanCache, TunedPlan, TuningCache,
                   global_tuning_cache, parse_tuning_key, plan_key,
                   tuning_key)
from .redistribute import (PackedBlock, free_chunk_dim, redistribute,
                           send_buffer, transpose_cost_bytes)
from .scheduler import (CostModel, ScheduleSimulator, TaskSpec,
                        WorkStealingPool, choose_chunk_schedule,
                        hop_phase_time, place_tasks)
from .tuner import (Candidate, enumerate_candidates,
                    feasible_hop_chunk_counts, measure_candidate,
                    propose_chunk_schedule, rank_candidates,
                    resolve_profile, resolve_tuned_plan, synth_input, tune,
                    warm_candidates)
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
    "input_struct", "make_spec", "output_struct", "n_segments",
    "segment_in_spec", "segment_out_spec", "segment_structs",
    "build_segment", "compile_segment",
    "PlanStreamExecutor", "SegmentTask", "execute_many",
    "CostModel", "ScheduleSimulator", "TaskSpec", "WorkStealingPool",
    "place_tasks", "choose_chunk_schedule", "hop_phase_time",
    "GLOBAL_PLAN_CACHE", "PlanCache", "TunedPlan", "plan_key",
    "TuningCache", "global_tuning_cache", "parse_tuning_key", "tuning_key",
    "Machine", "MachineProfile", "calibrate", "hop_cost_terms",
    "predict_plan_time", "profile_from_machine", "stage_comp_times",
    "Candidate", "enumerate_candidates", "feasible_hop_chunk_counts",
    "measure_candidate", "propose_chunk_schedule", "rank_candidates",
    "resolve_profile", "resolve_tuned_plan", "synth_input", "tune",
    "warm_candidates",
    "PackedBlock", "free_chunk_dim", "redistribute", "send_buffer",
    "transpose_cost_bytes", "transforms",
]
