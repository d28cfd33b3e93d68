"""Fault tolerance: the straggler watchdog and degraded-mesh shapes."""
from .fault import StepWatchdog, choose_fft_mesh_shape, choose_mesh_shape

__all__ = ["StepWatchdog", "choose_fft_mesh_shape", "choose_mesh_shape"]
