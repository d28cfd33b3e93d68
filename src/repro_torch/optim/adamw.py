"""AdamW with global-norm clipping and a cosine schedule (the port's
counterpart of the JAX package's ``optim/adamw.py``).

Trees here are flat dicts: ``params`` and ``grads`` map the same keys to
tensors (``models.convert.param_leaves`` keys a model's parameters by the
reference's tree path and super-block), and the state is ``{"m": {key:
tensor}, "v": {key: tensor}, "count": int32 0-d tensor}`` on the
parameters' device.  The arithmetic is the reference's, in its order:
clip by the global norm, float32 moments (bfloat16 under
``moment_dtype="bfloat16"``, computed in float32 and stored rounded), bias
correction, ``lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``, the schedule
read at the count before the step.  ``torch.optim.AdamW`` is not used: its
schedule, clipping and order of operations differ.

Unlike the reference, :func:`adamw_update` writes the new parameters and
moments into the tensors it is given (the model's own parameters), so a
step holds no second copy of the masters; it returns them all the same.
A schedule read at a 0-d tensor step stays on its device (no host sync).

On a mesh (``rules.mesh``) the leaves are this rank's blocks and every
step is elementwise but the clip: :func:`global_norm` sums the squares of
the leaves split over the same mesh axes, all-reduces each such sum over
those axes and counts a replicated leaf once, so the clip is the
one-process clip.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple, Union

import torch

from ..compat import _spec_axes


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


def moment_dtype(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" \
        else torch.float32


def cosine_schedule(cfg: AdamWConfig,
                    step: Union[int, torch.Tensor]) -> torch.Tensor:
    """Linear warm-up to ``lr_peak``, then a cosine to 0 at
    ``total_steps``; float32, on ``step``'s device."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = cfg.lr_peak * (step + 1) / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.lr_peak * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: Mapping[object, torch.Tensor],
                specs: Optional[Mapping[object, tuple]] = None,
                rules=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32.

    With ``rules`` on a mesh, ``tree`` holds this rank's blocks and
    ``specs`` their specs: the sums of the leaves split over one set of
    axes are all-reduced over those axes (their ranks hold different
    blocks), and the replicated ones are each rank's own."""
    sq = [torch.sum(torch.square(t.float())) for t in tree.values()]
    if rules is None or rules.mesh is None or rules.mesh.size == 1:
        return torch.sqrt(torch.stack(sq).sum())
    by_axes: Dict[tuple, list] = {}
    for (k, t), s in zip(tree.items(), sq):
        axes = tuple(sorted({a for e in specs[k] for a in _spec_axes(e)
                             if rules.size(a) > 1}))
        by_axes.setdefault(axes, []).append(s)
    total = torch.zeros((), dtype=torch.float32, device=sq[0].device)
    for axes, parts in sorted(by_axes.items()):
        part = torch.stack(parts).sum()
        for ax in axes:   # the blocks along each splitting axis add up
            torch.distributed.all_reduce(part, group=rules.group(ax))
        total = total + part
    return torch.sqrt(total)


def adamw_init(params: Mapping[object, torch.Tensor],
               cfg: AdamWConfig) -> Dict[str, object]:
    dt = moment_dtype(cfg)
    dev = next(iter(params.values())).device
    return {"m": {k: torch.zeros_like(p, dtype=dt)
                  for k, p in params.items()},
            "v": {k: torch.zeros_like(p, dtype=dt)
                  for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(grads: Mapping[object, torch.Tensor],
                 state: Dict[str, object],
                 params: Mapping[object, torch.Tensor], cfg: AdamWConfig,
                 rules=None) -> Tuple[Mapping[object, torch.Tensor],
                                      Dict[str, object]]:
    """One AdamW step, in place on ``params`` and the moments (this rank's
    blocks on ``rules.mesh``; each parameter's ``.spec`` names its
    split)."""
    count = state["count"] + 1
    lr = cosine_schedule(cfg, state["count"])
    gnorm = global_norm(grads, {k: getattr(p, "spec", None)
                                for k, p in params.items()}, rules)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    c = count.float()
    bc1 = 1.0 - torch.pow(b1, c)
    bc2 = 1.0 - torch.pow(b2, c)
    m_all, v_all = state["m"], state["v"]
    for k, p in params.items():
        m, v = m_all[k], v_all[k]
        g = grads[k].float() * scale
        m_new = m.float() * b1 + g * (1 - b1)
        v_new = v.float() * b2 + (g * (1 - b2)).mul_(g)
        del g
        upd = (m_new / bc1).div_(torch.sqrt(v_new / bc2).add_(cfg.eps))
        upd.add_(p.float() * cfg.weight_decay).mul_(lr)
        p.copy_(p.float() - upd)
        m.copy_(m_new)
        v.copy_(v_new)
    state["count"] = count
    return params, state
