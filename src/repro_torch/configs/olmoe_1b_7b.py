"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060; hf].

16L d_model=2048 16H (GQA kv=16) d_ff=1024 (per expert) vocab=50304,
MoE 64e top-8 on every layer.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    n_experts=64,
    top_k=8,
    moe_every=1,
    head_dim=128,
)
