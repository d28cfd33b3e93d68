"""Architecture registry: the 10 assigned configs (the port's own copy of
the JAX package's ``configs/``, pure Python).

``get_config(name)`` returns the exact published configuration;
``smoke_config(name)`` returns a reduced same-family config for CPU tests
(small widths, few experts, tiny vocab — same block pattern and features).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig, ShapeConfig, SHAPES

ARCHS: List[str] = [
    "xlstm_125m",
    "seamless_m4t_medium",
    "olmoe_1b_7b",
    "llama4_maverick_400b_a17b",
    "qwen3_8b",
    "phi3_medium_14b",
    "h2o_danube_1_8b",
    "stablelm_1_6b",
    "jamba_v0_1_52b",
    "llava_next_mistral_7b",
]

# canonical ids as given in the assignment (dashes/dots)
CANONICAL = {
    "xlstm-125m": "xlstm_125m",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "qwen3-8b": "qwen3_8b",
    "phi3-medium-14b": "phi3_medium_14b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "stablelm-1.6b": "stablelm_1_6b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}


def get_config(name: str) -> ModelConfig:
    mod_name = CANONICAL.get(name, name).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: one fwd/train step must run on 1 CPU."""
    cfg = get_config(name)
    kw: Dict = dict(
        n_layers=max(2, len(cfg.layer_kinds()) and _unit(cfg) * 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(4, max(1, cfg.n_kv_heads * 4 // cfg.n_heads)),
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=503,
        head_dim=16,
        window=16 if cfg.window else None,
        n_experts=4 if cfg.n_experts else 0,
        top_k=min(2, cfg.top_k) if cfg.n_experts else 0,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        d_state=8,
        n_modality_tokens=8 if cfg.modality == "vision" else 0,
        capacity_factor=2.0 if cfg.n_experts else cfg.capacity_factor,
    )
    return dataclasses.replace(cfg, **kw)


def _unit(cfg: ModelConfig) -> int:
    from repro_torch.models.transformer import block_pattern
    return block_pattern(cfg).size


def applicable_shapes(cfg: ModelConfig) -> List[str]:
    """Shape cells for this arch; long_500k only for sub-quadratic models."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        names.append("long_500k")
    return names
