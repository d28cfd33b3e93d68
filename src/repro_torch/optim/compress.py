"""Gradient compression for the data-parallel reduction (the port's
counterpart of the JAX package's ``optim/compress.py``).

* ``bf16_compress`` — cast gradients to bfloat16 before the cross-replica
  reduce (half the bytes); the optimizer re-accumulates in float32.  The
  train step applies it by default, as the reference.
* int8 error feedback — quantize a gradient to int8 with a per-tensor
  scale and carry the quantization error into the next step (EF-SGD);
  the decoded sum over steps tracks the true gradient sum.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch


def bf16_compress(grads: Mapping[object, torch.Tensor]
                  ) -> Dict[object, torch.Tensor]:
    return {k: g.to(torch.bfloat16) for k, g in grads.items()}


def error_feedback_int8_encode(g: torch.Tensor, err: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Returns (q_int8, scale, new_err).  g and err are float32."""
    target = g + err
    scale = torch.clamp(torch.max(torch.abs(target)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(target / scale), -127, 127) \
        .to(torch.int8)
    new_err = target - q.float() * scale
    return q, scale, new_err


def error_feedback_int8_decode(q: torch.Tensor,
                               scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
