"""Analytic FLOP / parameter accounting per (architecture x shape): the
port's own copy of the JAX package's ``models/costs.py`` terms.

Everything here mirrors the module math in
models/{layers,moe,ssm,transformer}.py.  ``tests/test_torch_lm.py`` holds
``param_counts`` against the built model's ``numel()``, and
``chip_smoke.py``'s ``[lm]`` phase prices the decode step's HBM bound from
it.

Conventions: a matmul of (m,k)x(k,n) is 2mkn flops; training flops =
forward * (1 fwd + 2 bwd + 1 remat-recompute when remat is on); MODEL_FLOPS
is 6*N*D with N = active non-embedding params.
"""
from __future__ import annotations

import math
from typing import Dict

from .config import ModelConfig, ShapeConfig
from .transformer import block_pattern


# ---------------------------------------------------------------------------
# parameter counts
# ---------------------------------------------------------------------------

def param_counts(cfg: ModelConfig) -> Dict[str, float]:
    d, f, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    hd = cfg.resolved_head_dim()
    h, k = cfg.n_heads, cfg.n_kv_heads
    di = cfg.expand * d
    attn = d * h * hd + 2 * d * k * hd + h * hd * d
    mlp_p = 3 * d * f
    moe_p = cfg.n_experts * 3 * d * f + d * cfg.n_experts
    mlstm_p = d * 2 * di + 3 * di * di + di * 2 * h + di * d + di
    slstm_p = d * 4 * d + h * (d // h) * 4 * (d // h) + d * d
    dt_rank = max(1, math.ceil(d / 16))
    mamba_p = (d * 2 * di + cfg.d_conv * di + di
               + di * (dt_rank + 2 * cfg.d_state) + dt_rank * di
               + 2 * di + di * cfg.d_state + di * d)

    total = 0.0
    active = 0.0
    pattern = block_pattern(cfg)
    for kind, use_moe in zip(pattern.kinds, pattern.moe):
        layer_t = 2 * d  # norms
        layer_a = 2 * d
        mix = {"attn": attn, "mlstm": mlstm_p, "slstm": slstm_p,
               "mamba": mamba_p}[kind if kind != "mamba" or
                                 cfg.ssm_impl != "fft_conv" else "mamba"]
        layer_t += mix
        layer_a += mix
        if cfg.d_ff > 0:
            if use_moe:
                layer_t += moe_p
                layer_a += (d * cfg.n_experts
                            + cfg.top_k * 3 * d * f)
                if cfg.shared_expert:
                    layer_t += mlp_p
                    layer_a += mlp_p
            else:
                layer_t += mlp_p
                layer_a += mlp_p
        total += layer_t * pattern.n_repeat
        active += layer_a * pattern.n_repeat

    if cfg.n_enc_layers > 0:
        enc_layer = attn + mlp_p + 2 * d
        total += cfg.n_enc_layers * enc_layer
        active += cfg.n_enc_layers * enc_layer
        # decoder cross-attention
        total += cfg.n_layers * (attn + d)
        active += cfg.n_layers * (attn + d)

    embed = v * d
    head = 0 if cfg.tie_embeddings else d * v
    return {
        "total": total + embed + head,
        "active": active + head,          # lm_head participates in matmuls
        "embed": embed,
        "non_embed_total": total + head,
    }


# ---------------------------------------------------------------------------
# flops
# ---------------------------------------------------------------------------

def _attn_flops(cfg: ModelConfig, t: float, s_kv: float,
                causal_half: bool = False) -> float:
    """Projections + score/PV matmuls for t query tokens vs s_kv keys."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim()
    h, k = cfg.n_heads, cfg.n_kv_heads
    proj = 2 * t * d * (h * hd) + 2 * 2 * t * d * (k * hd) \
        + 2 * t * (h * hd) * d
    sc = 0.5 if causal_half else 1.0
    qk_pv = 2 * 2 * t * s_kv * h * hd * sc
    return proj + qk_pv


def _mlp_flops(cfg: ModelConfig, t: float) -> float:
    return 2 * 3 * t * cfg.d_model * cfg.d_ff


def _moe_flops(cfg: ModelConfig, t: float) -> float:
    route = 2 * t * cfg.d_model * cfg.n_experts
    expert = 2 * 3 * (cfg.top_k * cfg.capacity_factor * t) \
        * cfg.d_model * cfg.d_ff
    shared = _mlp_flops(cfg, t) if cfg.shared_expert else 0.0
    return route + expert + shared


def _mlstm_flops(cfg: ModelConfig, b: float, s: float,
                 quadratic: bool) -> float:
    d = cfg.d_model
    di = cfg.expand * d
    h = cfg.n_heads
    dh = di // h
    t = b * s
    proj = 2 * t * d * 2 * di + 3 * 2 * t * di * di + 2 * t * di * d \
        + 2 * t * di * 2 * h
    if quadratic:
        mix = 2 * 2 * b * s * s * h * dh
    else:  # recurrent decode: per token C update + readout
        mix = 2 * 2 * t * h * dh * dh
    return proj + mix


def _slstm_flops(cfg: ModelConfig, t: float) -> float:
    d = cfg.d_model
    dh = d // cfg.n_heads
    return 2 * t * d * 4 * d + 2 * t * d * 4 * dh + 2 * t * d * d


def _mamba_flops(cfg: ModelConfig, t: float) -> float:
    d = cfg.d_model
    di = cfg.expand * d
    n = cfg.d_state
    r = max(1, math.ceil(d / 16))
    proj = 2 * t * d * 2 * di + 2 * t * di * d
    conv = 2 * t * cfg.d_conv * di
    sel = 2 * t * di * (r + 2 * n) + 2 * t * r * di
    scan = 10 * t * di * n            # elementwise recurrence + readout
    return proj + conv + sel + scan


def _fft_conv_flops(cfg: ModelConfig, b: float, s: float) -> float:
    d = cfg.d_model
    di = cfg.expand * d
    t = b * s
    proj = 2 * t * d * 2 * di + 2 * t * di * d
    nfft = 2 * s
    ffts = 3 * b * di * 5 * nfft * math.log2(max(nfft, 2))
    return proj + ffts


def step_flops(cfg: ModelConfig, shape: ShapeConfig, *,
               remat: bool = True) -> Dict[str, float]:
    """Global flops for one step of this (arch, shape) cell."""
    b = shape.global_batch
    if shape.kind == "train":
        t_q = b * shape.seq_len
        s_kv = shape.seq_len
        mult = 4.0 if remat else 3.0     # fwd + 2 bwd (+ remat fwd)
        if remat and cfg.layer_remat:
            mult = 5.0                   # nested per-layer recompute
        quad = True
    elif shape.kind == "prefill":
        t_q = b * shape.seq_len
        s_kv = shape.seq_len
        mult = 1.0
        quad = True
    else:  # decode: one token vs a seq_len cache
        t_q = b * 1
        s_kv = shape.seq_len
        mult = 1.0
        quad = False

    pattern = block_pattern(cfg)
    fwd = 0.0
    for kind, use_moe in zip(pattern.kinds, pattern.moe):
        kind = kind if not (kind == "mamba" and cfg.ssm_impl == "fft_conv") \
            else "fft_conv"
        if kind == "attn":
            s_eff = min(cfg.window, s_kv) if cfg.window else s_kv
            fwd += _attn_flops(cfg, t_q, s_eff)
        elif kind == "mlstm":
            fwd += _mlstm_flops(cfg, b, shape.seq_len if quad else 1, quad)
        elif kind == "slstm":
            fwd += _slstm_flops(cfg, t_q)
        elif kind == "mamba":
            fwd += _mamba_flops(cfg, t_q)
        elif kind == "fft_conv":
            fwd += _fft_conv_flops(cfg, b, shape.seq_len) if quad \
                else _mamba_flops(cfg, t_q)
        if cfg.d_ff > 0:
            fwd += _moe_flops(cfg, t_q) if use_moe else _mlp_flops(cfg, t_q)
    fwd *= pattern.n_repeat / max(len(pattern.kinds), 1) * len(pattern.kinds)

    if cfg.n_enc_layers > 0 and shape.kind != "decode":
        enc_t = b * shape.seq_len
        fwd += cfg.n_enc_layers * (_attn_flops(cfg, enc_t, shape.seq_len)
                                   + _mlp_flops(cfg, enc_t))
        # decoder cross-attention
        fwd += cfg.n_layers * _attn_flops(cfg, t_q, shape.seq_len)
    elif cfg.n_enc_layers > 0 and shape.kind == "decode":
        fwd += cfg.n_layers * _attn_flops(cfg, t_q, shape.seq_len)

    fwd += 2 * t_q * cfg.d_model * cfg.padded_vocab  # lm head

    counts = param_counts(cfg)
    tokens = t_q
    model_flops = 6.0 * counts["active"] * tokens if shape.kind == "train" \
        else 2.0 * counts["active"] * tokens
    return {
        "forward": fwd,
        "total": fwd * mult,
        "model_flops": model_flops,
        "params_total": counts["total"],
        "params_active": counts["active"],
        "min_hbm_bytes": step_min_bytes(cfg, shape, counts),
    }


def step_min_bytes(cfg: ModelConfig, shape: ShapeConfig, counts=None, *,
                   param_bytes: int = 2, moment_bytes: int = 4,
                   cache_bytes: int = 2) -> float:
    """Mandatory global HBM traffic for one step — the memory roofline floor.

    train:   params read fwd + remat + bwd (3x) and written once (4x P),
             both Adam moments read + written (4x P).
    prefill: params read once + KV cache written once.
    decode:  params read once per step (weights stream from HBM; for MoE
             with small per-step batch only the routed experts' weights are
             touched) + the full KV/state cache read once + written slots.
    """
    counts = counts or param_counts(cfg)
    p_total = counts["total"]

    # attention/state cache bytes for the full batch at this seq_len
    hd = cfg.resolved_head_dim()
    cache = 0.0
    pattern = block_pattern(cfg)
    b = shape.global_batch
    for kind in pattern.kinds:
        if kind == "attn":
            slots = min(cfg.window or shape.seq_len, shape.seq_len)
            cache += (2 * b * slots * cfg.n_kv_heads * hd
                      * cache_bytes) * pattern.n_repeat
        elif kind == "mamba":
            di = cfg.expand * cfg.d_model
            cache += (b * di * cfg.d_state * 4) * pattern.n_repeat
        elif kind == "mlstm":
            di = cfg.expand * cfg.d_model
            dh = di // cfg.n_heads
            cache += (b * cfg.n_heads * dh * dh * 4) * pattern.n_repeat
        elif kind == "slstm":
            cache += (4 * b * cfg.d_model * 4) * pattern.n_repeat
    if cfg.n_enc_layers > 0:
        cache += 2 * b * shape.seq_len * cfg.n_kv_heads * hd * cache_bytes \
            * cfg.n_layers

    if shape.kind == "train":
        return 4 * p_total * param_bytes + 4 * p_total * moment_bytes
    if shape.kind == "prefill":
        return p_total * param_bytes + cache
    # decode: MoE touches ~min(1, B*k/E) of the routed expert weights
    p_touch = counts["total"]
    if cfg.n_experts:
        frac = min(1.0, b * max(cfg.top_k, 1) / cfg.n_experts)
        routed_only = max(counts["total"] - counts["active"]
                          - counts["embed"], 0.0)
        p_touch = counts["active"] + frac * routed_only
    return p_touch * param_bytes + cache
