"""seamless-m4t-medium [audio] — enc-dec, multimodal [arXiv:2308.11596; hf].

12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206.  Encoder-decoder:
we read "12L" as 12 layers per stack (matching the HF config's
encoder_layers=12 / decoder_layers=12).  The speech frontend is a STUB per
the assignment: input_specs provides precomputed frame embeddings
(B, S, d_model) which the encoder consumes through a linear projector.
vocab is padded 256206 -> 256208 (divisible by the 16-way model axis).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    modality="audio",
    head_dim=64,
)
