"""Mixture-of-Experts FFN (the port's counterpart of the JAX package's
``models/moe.py``).

Two dispatch implementations, as in the reference, both dropless-with-
capacity (GShard capacity factor):

* ``grouped`` (default) — tokens are grouped by batch row; each group sorts
  only its own tokens by expert and packs them into a per-group capacity
  buffer (G, E, Cg, D);
* ``global`` — one sort over all B*S tokens, the reference's baseline.

The drop order is the reference's: a stable sort of the flattened (token,
choice) expert ids (``torch.sort(stable=True)`` for ``argsort(stable=
True)``), so the first ``cap`` arrivals at an expert in token order are
kept and the rest dropped; the top k are taken with ``lax.top_k``'s
ordering of ties (lower expert first).
:func:`dispatch` returns the sorted order and the keep mask, which the
tests hold against the reference's.

On a mesh the experts are split over "model" (``w_gate/w_up/w_down`` dim
0).  Every rank routes every token of its batch rows (the router is
replicated over "model"), so capacity and drops are the reference's; it
runs its own experts on their capacity buffers, combines their outputs
and the ranks' combinations are summed over "model" (``sharding.tp_sum``).
No token moves between ranks.  The router balance loss reads the whole
batch's statistics (``sharding.batch_mean`` over the batch axes).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import (MeshRules, batch_mean, shard,
                                    tp_copy, tp_sum, use)
from .config import ModelConfig
from .layers import as_param


class MoE(nn.Module):
    def __init__(self, b, path: str, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = as_param(b.param(f"{path}/router", (d, e),
                                       ("fsdp", None)))
        self.w_gate = as_param(b.param(f"{path}/w_gate", (e, d, f),
                                       ("tp", "fsdp", None)))
        self.w_up = as_param(b.param(f"{path}/w_up", (e, d, f),
                                     ("tp", "fsdp", None)))
        self.w_down = as_param(b.param(
            f"{path}/w_down", (e, f, d), ("tp", None, "fsdp"),
            scale=0.02 / math.sqrt(2 * cfg.n_layers)))

    def forward(self, x: torch.Tensor, rules: Optional[MeshRules] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return moe_ffn(self, self.cfg, rules, x)


def init_moe(b, path: str, cfg: ModelConfig) -> MoE:
    return MoE(b, path, cfg)


def _route(p: MoE, cfg: ModelConfig, xf: torch.Tensor,
           rules: Optional[MeshRules] = None):
    """Router: returns (gate weights (..., k), expert ids (..., k), aux)."""
    e, k = cfg.n_experts, cfg.top_k
    logits = (xf @ use(p.router, rules).to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k puts the lower index first among equal values, and bfloat16
    # logits tie often; torch.topk leaves ties in no set order, so the
    # top k come from a stable descending sort
    gate_w, gate_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_e = gate_w[..., :k], gate_e[..., :k]
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    lead = tuple(range(gate_e.dim() - 1))
    density = batch_mean(torch.mean(F.one_hot(gate_e[..., 0], e).float(),
                                    dim=lead), rules)
    aux = e * torch.sum(density * batch_mean(torch.mean(probs, dim=lead),
                                             rules))
    # the ranks of "model" combine different experts' outputs: the gate
    # weights' gradients are partial there
    return tp_copy(gate_w, rules), gate_e, aux


def _local_experts(cfg: ModelConfig, rules: Optional[MeshRules]):
    """(first expert, count) of this rank's experts."""
    n = cfg.n_experts // (rules.tp_size if rules is not None else 1)
    return (rules.tp_index * n if rules is not None else 0), n


def _expert_mlp(p: MoE, dt, buf: torch.Tensor,
                rules: Optional[MeshRules] = None) -> torch.Tensor:
    """Batched per-expert SwiGLU over this rank's experts.  buf: (..., E,
    C, D) -> same shape."""
    hid = F.silu(torch.einsum("...ecd,edf->...ecf", buf,
                              use(p.w_gate, rules).to(dt))) \
        * torch.einsum("...ecd,edf->...ecf", buf, use(p.w_up, rules).to(dt))
    return torch.einsum("...ecf,efd->...ecd", hid,
                        use(p.w_down, rules).to(dt))


def dispatch(flat_e: torch.Tensor, n_experts: int, cap: int):
    """Capacity dispatch of expert ids ``flat_e`` (..., T) along the last
    dim: ``(order, slot, keep)``, the stable sort's permutation, each
    sorted entry's buffer slot (``E*cap`` for a dropped one) and whether
    it is kept."""
    t = flat_e.shape[-1]
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    se = torch.gather(flat_e, -1, order)
    counts = F.one_hot(flat_e, n_experts).sum(dim=-2)         # (..., E)
    starts = torch.cumsum(counts, dim=-1) - counts
    pos_in_e = torch.arange(t, device=flat_e.device) \
        - torch.gather(starts, -1, se)
    keep = pos_in_e < cap
    slot = torch.where(keep, se * cap + pos_in_e,
                       torch.full_like(se, n_experts * cap))
    return order, slot, keep


def moe_ffn(p: MoE, cfg: ModelConfig, rules: Optional[MeshRules],
            x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if getattr(cfg, "moe_impl", "grouped") == "global":
        return moe_ffn_global(p, cfg, rules, x)
    return moe_ffn_grouped(p, cfg, rules, x)


def moe_ffn_grouped(p: MoE, cfg: ModelConfig, rules: Optional[MeshRules],
                    x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux).  Groups = batch rows."""
    b_, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    dt = x.dtype
    gate_w, gate_e, aux = _route(p, cfg, x, rules)
    cap = max(4, int(cfg.capacity_factor * s * k / e))
    e0, ne = _local_experts(cfg, rules)

    flat_e = gate_e.reshape(b_, s * k)
    flat_t = torch.arange(s, device=x.device).repeat_interleave(k) \
        .expand(b_, s * k)
    flat_w = gate_w.reshape(b_, s * k)
    order, slot, keep = dispatch(flat_e, e, cap)
    st_ = torch.gather(flat_t, -1, order)
    sw = torch.gather(flat_w, -1, order)

    xtok = torch.gather(tp_copy(x, rules), 1,
                        st_[..., None].expand(-1, -1, d)).to(dt)
    xtok = shard(xtok, rules, "batch", None, "tp")
    buf = torch.zeros((b_, e * cap + 1, d), dtype=dt, device=x.device)
    buf.scatter_add_(1, slot[..., None].expand(-1, -1, d), xtok)
    buf = buf[:, :-1].reshape(b_, e, cap, d)[:, e0:e0 + ne]
    buf = shard(buf, rules, "batch", "tp", None, None)

    out_e = _expert_mlp(p, dt, buf, rules)
    out_e = shard(out_e, rules, "batch", "tp", None, None)

    # this rank's experts' slots (a kept entry elsewhere is dropped here)
    flat_out = out_e.reshape(b_, ne * cap, d)
    local = slot - e0 * cap
    keep = keep & (local >= 0) & (local < ne * cap)
    safe_slot = torch.clamp(local, min=0, max=ne * cap - 1)
    gathered = torch.gather(flat_out, 1, safe_slot[..., None].expand(-1, -1, d))
    gathered = shard(gathered, rules, "batch", None, "tp")
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=dt, device=x.device))
    contrib = gathered * sw[..., None].to(dt)
    out = torch.zeros((b_, s, d), dtype=dt, device=x.device)
    out.scatter_add_(1, st_[..., None].expand(-1, -1, d), contrib)
    out = tp_sum(shard(out, rules, "batch", None, "tp"), rules)
    return shard(out, rules, "batch", None, None), aux


def moe_ffn_global(p: MoE, cfg: ModelConfig, rules: Optional[MeshRules],
                   x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Baseline: one global sort over all B*S tokens."""
    b_, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b_ * s
    dt = x.dtype
    if rules is not None and rules.batch_size > 1:
        raise NotImplementedError(
            "moe_impl='global' sorts the whole batch's tokens: it runs with "
            "the batch on one rank (a mesh whose batch axes have size 1)")
    xf = x.reshape(t, d)
    gate_w, gate_e, aux = _route(p, cfg, xf, rules)
    e0, ne = _local_experts(cfg, rules)

    cap = max(4, int(cfg.capacity_factor * t * k / e))
    flat_e = gate_e.reshape(-1)
    flat_t = torch.arange(t, device=x.device).repeat_interleave(k)
    flat_w = gate_w.reshape(-1)
    order, slot, keep = dispatch(flat_e, e, cap)
    st_, sw = flat_t[order], flat_w[order]

    buf = torch.zeros((e * cap + 1, d), dtype=dt, device=x.device)
    buf.index_add_(0, slot, tp_copy(xf, rules)[st_].to(dt))
    buf = buf[:-1].reshape(e, cap, d)[e0:e0 + ne]
    buf = shard(buf, rules, "tp", None, None)

    out_e = _expert_mlp(p, dt, buf, rules)
    out_e = shard(out_e, rules, "tp", None, None)

    flat_out = out_e.reshape(ne * cap, d)
    local = slot - e0 * cap
    keep = keep & (local >= 0) & (local < ne * cap)
    gathered = torch.where(keep[:, None],
                           flat_out[torch.clamp(local, min=0,
                                                max=ne * cap - 1)],
                           torch.zeros((), dtype=dt, device=x.device))
    contrib = gathered * sw[:, None].to(dt)
    out = torch.zeros((t, d), dtype=dt, device=x.device)
    out.index_add_(0, st_, contrib)
    out = tp_sum(out, rules)
    return shard(out.reshape(b_, s, d), rules, "batch", None, None), aux
