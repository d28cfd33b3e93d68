"""h2o-danube-1.8b [dense] — llama+mistral mix, SWA [arXiv:2401.16818; hf].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, sliding window 4096.
The window makes it sub-quadratic: long_500k decode runs with a 4096-slot
ring-buffer KV cache.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32000,
    window=4096,
    head_dim=80,
)
