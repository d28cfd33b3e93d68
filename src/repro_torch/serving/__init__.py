"""Spectral serving: the long-running FFT service layer.

Composes the plan-once/execute-many core (``DistributedFFT`` and the
``PlanStreamExecutor`` segment stream), the wisdom cache (warm start) and
the fault layer (``StepWatchdog`` straggler attribution, degraded-mesh
recovery) under mixed-shape traffic, as the JAX package's ``serving``.
"""
from .metrics import ServingMetrics
from .router import (BATCH_BUCKETS, DEFAULT_BUCKET_EDGES, FFTRequest,
                     FFTResult, PlanFamily, ShapeRouter)
from .service import FFTService
from .warmer import PlanWarmer, WarmReport

__all__ = [
    "ServingMetrics",
    "FFTRequest", "FFTResult", "PlanFamily", "ShapeRouter",
    "DEFAULT_BUCKET_EDGES", "BATCH_BUCKETS",
    "FFTService",
    "PlanWarmer", "WarmReport",
]
