"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Super-block of 8: attention at position 4, Mamba elsewhere; MoE FFN on
every other layer.  ssm_impl="fft_conv" swaps Mamba's scan for a Hyena-
style FFT long convolution driven by the paper's core transforms (the
arch-level tie-in to DaggerFFT; default remains the selective scan).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    ssm_kind="mamba",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    n_experts=16,
    top_k=2,
    moe_every=2,
    attn_every=8,
    d_state=16,
    d_conv=4,
    expand=2,
    head_dim=128,
    layer_remat=True,   # 8-layer super-block backward working set > HBM
)
