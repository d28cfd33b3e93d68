"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

12L d_model=768 4H (GQA kv=4) d_ff=0 vocab=50304.  d_ff=0: xLSTM blocks
carry their own up/down projections (expand=2), no separate FFN.  Block
cadence: sLSTM every 4th layer (xLSTM[3:1] mix), mLSTM otherwise.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    ssm_kind="xlstm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    expand=2,
    slstm_every=4,
    head_dim=192,
)
