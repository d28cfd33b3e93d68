"""llava-next-mistral-7b [vlm] — anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.  Backbone only per
the assignment: the vision tower is a STUB — input_specs provides
precomputed patch embeddings (anyres tiles flattened to n_modality_tokens)
that replace the first image-token positions after a linear projector.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    modality="vision",
    n_modality_tokens=576,
    head_dim=128,
    rope_theta=1000000.0,
)
