"""torch.fft oracles for the four-step kernel (the allclose targets)."""
from __future__ import annotations

import torch


def fft1d_ref(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.fft.fft(x, dim=axis)


def ifft1d_ref(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.fft.ifft(x, dim=axis)


def fft1d_planes_ref(xr: torch.Tensor, xi: torch.Tensor, *,
                     inverse: bool = False):
    """Planes-in/planes-out oracle at the planes' precision."""
    out = (torch.fft.ifft if inverse else torch.fft.fft)(
        torch.complex(xr, xi), dim=-1)
    return out.real, out.imag
