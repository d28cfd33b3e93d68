"""llama4-maverick-400b-a17b [moe] — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.
Llama-4 style: MoE on every other layer with an always-on shared expert;
routed top-1.  ~400B total / ~17B active.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    n_experts=128,
    top_k=1,
    moe_every=2,
    shared_expert=True,
    head_dim=128,
    rope_theta=500000.0,
)
