"""Model configuration for every assigned architecture family.

One dataclass covers dense / MoE / SSM / hybrid / enc-dec / VLM variants so
configs stay declarative (`src/repro_torch/configs/<id>.py` just fills fields).
The port's own copy of the JAX package's `models/config.py`: pure Python.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # attention details
    head_dim: Optional[int] = None          # default d_model // n_heads
    rope_theta: float = 10000.0
    qk_norm: bool = False                   # qwen3
    window: Optional[int] = None            # sliding-window attention (SWA)
    attn_logit_softcap: Optional[float] = None

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1                      # MoE layer every k-th layer
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    shared_expert: bool = False             # llama4: always-on shared expert
    moe_impl: str = "grouped"               # "grouped" | "global" (baseline)

    # SSM / hybrid
    ssm_kind: Optional[str] = None          # "xlstm" | "mamba"
    d_state: int = 16                       # mamba state size
    d_conv: int = 4                         # mamba conv width
    expand: int = 2                         # mamba/mLSTM inner expansion
    slstm_every: int = 4                    # xlstm: sLSTM block cadence
    attn_every: int = 8                     # jamba: attention layer cadence
    ssm_impl: str = "scan"                  # "scan" | "fft_conv" (paper tie-in)

    # enc-dec
    n_enc_layers: int = 0                   # 0 = decoder-only

    # multimodal stub frontends
    modality: Optional[str] = None          # "audio" | "vision"
    n_modality_tokens: int = 0              # patch/frame embeds per sample

    # remat policy: per-layer nested checkpoint inside the scanned
    # super-block (for deep hetero super-blocks whose combined backward
    # working set exceeds HBM — jamba's 8-layer block)
    layer_remat: bool = False

    # numerics / vocab padding
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 16
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # sub-quadratic? (drives long_500k applicability)
    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid") or self.window is not None

    @property
    def padded_vocab(self) -> int:
        return pad_to_multiple(self.vocab, self.vocab_pad_multiple)

    @property
    def kv_groups(self) -> int:
        return self.n_heads // self.n_kv_heads

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer mixer kind for the decoder stack."""
        kinds = []
        for i in range(self.n_layers):
            if self.family == "hybrid":
                kinds.append("attn" if (i % self.attn_every
                                        == self.attn_every // 2) else "mamba")
            elif self.family == "ssm" and self.ssm_kind == "xlstm":
                kinds.append("slstm" if (i % self.slstm_every
                                         == self.slstm_every - 1) else "mlstm")
            else:
                kinds.append("attn")
        return tuple(kinds)

    def moe_layer(self, i: int) -> bool:
        if self.n_experts == 0:
            return False
        return (i % self.moe_every) == (self.moe_every - 1)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (arch x input-shape) cell."""
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                 # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
