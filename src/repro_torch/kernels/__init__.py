"""The port's hand-written GPU kernels, their plain versions and wrappers."""
from .fft_matmul import (fft_fourstep, fft_fourstep_plain, launch_config,
                         reset_launch_counts)
from .ops import fft1d, ifft1d, packed_fft1d

__all__ = ["fft_fourstep", "fft_fourstep_plain", "launch_config",
           "reset_launch_counts", "fft1d", "ifft1d", "packed_fft1d"]
