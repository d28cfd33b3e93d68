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
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import MeshRules, shard
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


def _route(p: MoE, cfg: ModelConfig, xf: torch.Tensor):
    """Router: returns (gate weights (..., k), expert ids (..., k), aux)."""
    e, k = cfg.n_experts, cfg.top_k
    logits = (xf @ p.router.to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k puts the lower index first among equal values, and bfloat16
    # logits tie often; torch.topk leaves ties in no set order, so the
    # top k come from a stable descending sort
    gate_w, gate_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_e = gate_w[..., :k], gate_e[..., :k]
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    lead = tuple(range(gate_e.dim() - 1))
    density = torch.mean(F.one_hot(gate_e[..., 0], e).float(), dim=lead)
    aux = e * torch.sum(density * torch.mean(probs, dim=lead))
    return gate_w, gate_e, aux


def _expert_mlp(p: MoE, dt, buf: torch.Tensor) -> torch.Tensor:
    """Batched per-expert SwiGLU.  buf: (..., E, C, D) -> same shape."""
    hid = F.silu(torch.einsum("...ecd,edf->...ecf", buf, p.w_gate.to(dt))) \
        * torch.einsum("...ecd,edf->...ecf", buf, p.w_up.to(dt))
    return torch.einsum("...ecf,efd->...ecd", hid, p.w_down.to(dt))


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
    gate_w, gate_e, aux = _route(p, cfg, x)
    cap = max(4, int(cfg.capacity_factor * s * k / e))

    flat_e = gate_e.reshape(b_, s * k)
    flat_t = torch.arange(s, device=x.device).repeat_interleave(k) \
        .expand(b_, s * k)
    flat_w = gate_w.reshape(b_, s * k)
    order, slot, keep = dispatch(flat_e, e, cap)
    st_ = torch.gather(flat_t, -1, order)
    sw = torch.gather(flat_w, -1, order)

    xtok = torch.gather(x, 1, st_[..., None].expand(-1, -1, d)).to(dt)
    xtok = shard(xtok, rules, "batch", None, "tp")
    buf = torch.zeros((b_, e * cap + 1, d), dtype=dt, device=x.device)
    buf.scatter_add_(1, slot[..., None].expand(-1, -1, d), xtok)
    buf = buf[:, :-1].reshape(b_, e, cap, d)
    buf = shard(buf, rules, "batch", "tp", None, None)

    out_e = _expert_mlp(p, dt, buf)
    out_e = shard(out_e, rules, "batch", "tp", None, None)

    flat_out = out_e.reshape(b_, e * cap, d)
    safe_slot = torch.clamp(slot, max=e * cap - 1)
    gathered = torch.gather(flat_out, 1, safe_slot[..., None].expand(-1, -1, d))
    gathered = shard(gathered, rules, "batch", None, "tp")
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=dt, device=x.device))
    contrib = gathered * sw[..., None].to(dt)
    out = torch.zeros((b_, s, d), dtype=dt, device=x.device)
    out.scatter_add_(1, st_[..., None].expand(-1, -1, d), contrib)
    out = shard(out, rules, "batch", None, "tp")
    return shard(out, rules, "batch", None, None), aux


def moe_ffn_global(p: MoE, cfg: ModelConfig, rules: Optional[MeshRules],
                   x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Baseline: one global sort over all B*S tokens."""
    b_, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b_ * s
    dt = x.dtype
    xf = x.reshape(t, d)
    gate_w, gate_e, aux = _route(p, cfg, xf)

    cap = max(4, int(cfg.capacity_factor * t * k / e))
    flat_e = gate_e.reshape(-1)
    flat_t = torch.arange(t, device=x.device).repeat_interleave(k)
    flat_w = gate_w.reshape(-1)
    order, slot, keep = dispatch(flat_e, e, cap)
    st_, sw = flat_t[order], flat_w[order]

    buf = torch.zeros((e * cap + 1, d), dtype=dt, device=x.device)
    buf.index_add_(0, slot, xf[st_].to(dt))
    buf = buf[:-1].reshape(e, cap, d)
    buf = shard(buf, rules, "tp", None, None)

    out_e = _expert_mlp(p, dt, buf)
    out_e = shard(out_e, rules, "tp", None, None)

    flat_out = out_e.reshape(e * cap, d)
    gathered = torch.where(keep[:, None],
                           flat_out[torch.clamp(slot, max=e * cap - 1)],
                           torch.zeros((), dtype=dt, device=x.device))
    contrib = gathered * sw[:, None].to(dt)
    out = torch.zeros((t, d), dtype=dt, device=x.device)
    out.index_add_(0, st_, contrib)
    return shard(out.reshape(b_, s, d), rules, "batch", None, None), aux
