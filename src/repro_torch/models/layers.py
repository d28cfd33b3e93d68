"""Transformer building blocks: norms, RoPE, GQA attention, SwiGLU MLP (the
port's counterpart of the JAX package's ``models/layers.py``).

Attention supports the reference's four execution modes on one parameter
set:
  train    — full-sequence causal (or windowed / bidirectional) attention,
             computed flash-style in (q-block, kv-block) tiles with an online
             softmax, so no S^2 score matrix is materialized;
  prefill  — train-mode compute + returns the populated KV cache;
  decode   — one new token against a cache; for sliding-window attention the
             cache is a ring buffer of ``window`` slots;
  cross    — enc-dec cross attention (cache filled once from encoder output).

On a mesh (``rules.mesh``) attention and the MLP are Megatron's tensor-
parallel pairs: the q heads (and the K/V heads with them) and the MLP's
hidden columns are split over "model", ``wo`` and ``w_down`` are row-
parallel and their partial products summed over "model"
(``sharding.tp_sum``, where the reference's ``shard(y, ..., None)`` makes
the output whole).  With fewer K/V heads than "model" ranks each rank
computes the one K/V head its q heads read (``wk``/``wv`` replicated over
"model": a deviation from the reference's spec, which splits inside a
head).  The fsdp dims are gathered for each use (``sharding.use``).

Each block is an ``nn.Module`` whose parameter names are the reference's
leaf names (``wq``, ``q_norm.scale``, ...), so the weight converter
(``models/convert.py``) is a table.  Parameters are kept in their build
dtype (float32 masters) and cast to the activations' dtype at each use, as
the reference does; norms, RoPE and the softmax run in float32, and every
score and P·V contraction accumulates in float32 (the reference's
``preferred_element_type``), on plain torch ops.

Decode writes the new token's K/V into the cache tensors in place (the
reference's donated cache buffers) and returns the cache dict with its
advanced ``pos``; a cache's ``pos`` is a Python int.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import (MeshRules, shard, tp_copy, tp_split,
                                    tp_sum, use)
from .config import ModelConfig

NEG_INF = -2.0e38


def as_param(t: torch.Tensor) -> nn.Parameter:
    """A serving parameter: no gradient is kept (the train step's slice
    turns it on).  It keeps the builder's spec (``.spec``)."""
    p = nn.Parameter(t, requires_grad=False)
    p.spec = getattr(t, "spec", None)
    return p


# ---------------------------------------------------------------------------
# norms / embeddings / rope
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, b, path: str, d: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = as_param(b.param(f"{path}/scale", (d,), (None,),
                                      init="ones"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale, self.eps)


def init_norm(b, path: str, d: int, eps: float = 1e-5) -> RMSNorm:
    return RMSNorm(b, path, d, eps)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, head_dim//2)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, N, Hd); cos/sin: (B, S, half) or (S, half)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos = cos[None]
        sin = sin[None]
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    x1f, x2f = x1.float(), x2.float()
    return torch.cat([x1f * c - x2f * s, x2f * c + x1f * s],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# flash-style tiled attention (no S^2 materialization)
# ---------------------------------------------------------------------------

def _flash_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: Optional[int], q_offset: int = 0,
                  softcap: Optional[float] = None,
                  q_block: int = 256, kv_block: int = 1024) -> torch.Tensor:
    """q/k/v: (B, S, H, Hd) MHA layout -> (B, Sq, H, Hd).

    GQA callers expand k/v to the full head count first, as the reference.
    Online softmax over kv blocks, q blocks in an outer loop; ``q_offset``
    is the absolute position of q[0].
    """
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    q_block = min(q_block, sq)
    kv_block = min(kv_block, skv)
    pq = (-sq) % q_block
    pk = (-skv) % kv_block
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
    nq, nkv = q.shape[1] // q_block, k.shape[1] // kv_block
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    outs = []
    for qi in range(nq):
        qblk = q[:, qi * q_block:(qi + 1) * q_block].float()
        qpos = q_offset + qi * q_block + torch.arange(q_block, device=dev)
        o = torch.zeros((b, h, q_block, hd), dtype=torch.float32, device=dev)
        m = torch.full((b, h, q_block), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, h, q_block), dtype=torch.float32, device=dev)
        for kj in range(nkv):
            kblk = k[:, kj * kv_block:(kj + 1) * kv_block]
            vblk = v[:, kj * kv_block:(kj + 1) * kv_block]
            s = torch.einsum("bqhd,bthd->bhqt", qblk, kblk.float()) * scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            kpos = kj * kv_block + torch.arange(kv_block, device=dev)
            mask = torch.ones((q_block, kv_block), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if window is not None:
                mask &= qpos[:, None] - kpos[None, :] < window
            if pk:
                mask &= (kpos < skv)[None, :]
            s = torch.where(mask[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhqt,bthd->bhqd", p.to(vblk.dtype).float(),
                              vblk.float())
            o = o * corr[..., None] + pv
            m = m_new
        o = o / torch.clamp(l[..., None], min=1e-38)
        outs.append(o.to(q.dtype))
    # (nq, B, H, qb, Hd) -> (B, Sq, H, Hd)
    out = torch.stack(outs, dim=1).transpose(2, 3)
    return out.reshape(b, nq * q_block, h, hd)[:, :sq]


def _decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   length_mask: torch.Tensor,
                   softcap: Optional[float] = None) -> torch.Tensor:
    """One-token attention: q (B, 1, K, G, Hd) vs full cache (B, S, K, Hd);
    ``length_mask`` (B or 1, S) marks valid cache slots."""
    hd = q.shape[-1]
    s = torch.einsum("bqkgh,btkh->bkgqt", q.float(), k.float()) \
        / math.sqrt(hd)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(length_mask[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkh->bqkgh", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """GQA attention; ``forward`` returns ``(output, new_cache)``.

    Cache layout: {"k": (B, S, K, Hd), "v": ..., "pos": int} — for windowed
    attention S == window (ring buffer), else S == max sequence length.
    """

    def __init__(self, b, path: str, cfg: ModelConfig, cross: bool = False):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        hd = cfg.resolved_head_dim()
        h, k = cfg.n_heads, cfg.n_kv_heads
        kv = ("fsdp", "tp") if tp_split(b, k) else ("fsdp", None)
        self.wq = as_param(b.param(f"{path}/wq", (d, h * hd), ("fsdp", "tp")))
        self.wk = as_param(b.param(f"{path}/wk", (d, k * hd), kv))
        self.wv = as_param(b.param(f"{path}/wv", (d, k * hd), kv))
        self.wo = as_param(b.param(f"{path}/wo", (h * hd, d), ("tp", "fsdp"),
                                   scale=0.02 / math.sqrt(2 * cfg.n_layers)))
        if cfg.qk_norm:
            self.q_norm = init_norm(b, f"{path}/q_norm", hd, cfg.norm_eps)
            self.k_norm = init_norm(b, f"{path}/k_norm", hd, cfg.norm_eps)

    def forward(self, x: torch.Tensor, *, rules: Optional[MeshRules] = None,
                mode: str = "train",
                positions: Optional[torch.Tensor] = None,
                cache: Optional[Dict] = None,
                kv_source: Optional[torch.Tensor] = None,
                causal: bool = True, window: Optional[int] = None,
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        cfg = self.cfg
        b_, s, d = x.shape
        hd = cfg.resolved_head_dim()
        tp = rules.tp_size if rules is not None else 1
        # this rank's heads: h q heads in nk groups, split over "model"
        h = cfg.n_heads // tp
        if self.wk.spec[-1] is not None:
            nk = cfg.n_kv_heads // tp
            wk, wv = use(self.wk, rules), use(self.wv, rules)
        else:   # K/V replicated: the one head this rank's q heads read
            nk = 1
            j = rules.tp_index * h // (cfg.n_heads // cfg.n_kv_heads)
            wk = tp_copy(use(self.wk, rules), rules)[:, j * hd:(j + 1) * hd]
            wv = tp_copy(use(self.wv, rules), rules)[:, j * hd:(j + 1) * hd]
        g = h // nk
        compute_dt = x.dtype
        x = tp_copy(x, rules)

        q = (x @ use(self.wq, rules).to(compute_dt)).reshape(b_, s, nk, g,
                                                              hd)
        kv_in = x if kv_source is None else tp_copy(kv_source, rules)
        k = (kv_in @ wk.to(compute_dt)).reshape(b_, kv_in.shape[1], nk, hd)
        v = (kv_in @ wv.to(compute_dt)).reshape(b_, kv_in.shape[1], nk, hd)
        if cfg.qk_norm:
            # each rank normalizes its own heads: the scales' gradients
            # are partial over "model"
            q = rms_norm(q, tp_copy(self.q_norm.scale, rules),
                         self.q_norm.eps)
            k = rms_norm(k, tp_copy(self.k_norm.scale, rules),
                         self.k_norm.eps)

        is_cross = kv_source is not None
        if positions is None:
            positions = torch.arange(s, device=x.device)
        if not is_cross:  # RoPE on self-attention only
            cos, sin = rope_angles(positions, hd, cfg.rope_theta)
            q = apply_rope(q.reshape(b_, s, nk * g, hd), cos, sin) \
                .reshape(b_, s, nk, g, hd)
            k = apply_rope(k, cos, sin)

        new_cache = None
        if mode in ("train", "prefill"):
            kx = torch.repeat_interleave(k, g, dim=2)
            vx = torch.repeat_interleave(v, g, dim=2)
            out = _flash_attend(q.reshape(b_, s, h, hd), kx, vx,
                                causal=causal and not is_cross,
                                window=window,
                                softcap=cfg.attn_logit_softcap)
            out = out.reshape(b_, s, nk, g, hd)
            if mode == "prefill":
                ck, cv = k, v
                if window is not None and s > window:
                    # ring-buffer layout: token at absolute pos p lives in
                    # slot p % window, so future decode writes land there
                    ck = torch.roll(k[:, -window:], shifts=s % window, dims=1)
                    cv = torch.roll(v[:, -window:], shifts=s % window, dims=1)
                new_cache = {"k": ck, "v": cv, "pos": s}
        elif mode == "decode":
            if cache is None:
                raise ValueError("decode needs a cache")
            ck, cv = cache["k"], cache["v"]
            slots = ck.shape[1]
            pos = int(cache["pos"])
            slot = pos % slots if window is not None else pos
            if not is_cross:
                # lax.dynamic_update_slice clamps the start into
                # [0, slots - s]; the port writes where the reference does
                start = min(max(slot, 0), slots - s)
                ck[:, start:start + s] = k.to(ck.dtype)
                cv[:, start:start + s] = v.to(cv.dtype)
            idx = torch.arange(slots, device=x.device)
            if is_cross:
                valid = idx[None, :] < slots  # full encoder context
            elif window is not None:
                valid = idx[None, :] <= min(pos, slots - 1)
            else:
                valid = idx[None, :] <= pos
            out = _decode_attend(q, ck, cv, length_mask=valid,
                                 softcap=cfg.attn_logit_softcap)
            new_cache = {"k": ck, "v": cv,
                         "pos": pos + (0 if is_cross else s)}
        else:
            raise ValueError(f"unknown mode {mode!r}")

        out = out.reshape(b_, s, h * hd)
        out = shard(out, rules, "batch", None, "tp")
        y = tp_sum(out @ use(self.wo, rules).to(compute_dt), rules)
        return shard(y, rules, "batch", None, None), new_cache


def init_attention(b, path: str, cfg: ModelConfig,
                   cross: bool = False) -> Attention:
    return Attention(b, path, cfg, cross=cross)


def attention(p: Attention, cfg: ModelConfig, rules: MeshRules,
              x: torch.Tensor, **kw) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The reference's functional form: ``p`` is the :class:`Attention`."""
    return p(x, rules=rules, **kw)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, b, path: str, cfg: ModelConfig,
                 d_ff: Optional[int] = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.w_gate = as_param(b.param(f"{path}/w_gate", (d, f),
                                       ("fsdp", "tp")))
        self.w_up = as_param(b.param(f"{path}/w_up", (d, f), ("fsdp", "tp")))
        self.w_down = as_param(b.param(
            f"{path}/w_down", (f, d), ("tp", "fsdp"),
            scale=0.02 / math.sqrt(2 * cfg.n_layers)))

    def forward(self, x: torch.Tensor,
                rules: Optional[MeshRules] = None) -> torch.Tensor:
        dt = x.dtype
        x = tp_copy(x, rules)
        hid = F.silu(x @ use(self.w_gate, rules).to(dt)) \
            * (x @ use(self.w_up, rules).to(dt))
        hid = shard(hid, rules, "batch", None, "tp")
        out = tp_sum(hid @ use(self.w_down, rules).to(dt), rules)
        return shard(out, rules, "batch", None, None)


def init_mlp(b, path: str, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> MLP:
    return MLP(b, path, cfg, d_ff)


def mlp(p: MLP, rules: MeshRules, x: torch.Tensor) -> torch.Tensor:
    return p(x, rules)
