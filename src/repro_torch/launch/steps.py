"""Step builders, serving half: parameters, prefill and decode (the port's
counterpart of the JAX package's ``launch/steps.py``).

``build_params`` draws the model's float32 masters on a device; the step
builders return plain functions over (model, batch, caches) that run
eagerly under ``torch.no_grad``.  Both run on CUDA unless the caller passes
``device="cpu"``, and raise when there is no card and none was asked for
(``compat.resolve_device``).  The train step, the chunked loss and the
dry-run cell assembly belong to the training slice.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..compat import resolve_device
from ..distributed.sharding import MeshRules, ParamBuilder
from ..models import transformer as tfm
from ..models.config import ModelConfig


def build_params(cfg: ModelConfig, *, seed: int = 0,
                 param_dtype: torch.dtype = torch.float32,
                 device=None) -> tfm.Model:
    """The model with parameters drawn from ``seed`` on ``device``."""
    builder = ParamBuilder(seed, dtype=param_dtype,
                           device=resolve_device(device))
    with torch.no_grad():
        return tfm.init_model(builder, cfg)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            vocab: int) -> torch.Tensor:
    """Mean CE over tokens; padded-vocab logits masked out."""
    v_pad = logits.shape[-1]
    lf = logits.float()
    if v_pad > vocab:
        pad_mask = torch.arange(v_pad, device=lf.device) >= vocab
        lf = torch.where(pad_mask[None, None, :], -1e30, lf)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)


def _on(device: torch.device, model: tfm.Model, batch: Dict) -> Dict:
    if model.embed.device != device:
        raise ValueError(f"the model's parameters are on "
                         f"{model.embed.device}, the step runs on {device}")
    return {k: v.to(device) for k, v in batch.items()}


def make_prefill_step(cfg: ModelConfig, rules: Optional[MeshRules] = None,
                      *, device=None):
    """``prefill_step(model, batch) -> (last logits (B, V), caches)``."""
    dev = resolve_device(device)

    def prefill_step(params: tfm.Model, batch: Dict):
        with torch.no_grad():
            logits, caches, _ = tfm.forward(params, cfg, rules,
                                            _on(dev, params, batch),
                                            mode="prefill")
        return logits[:, -1], caches

    return prefill_step


def make_decode_step(cfg: ModelConfig, rules: Optional[MeshRules] = None,
                     *, device=None):
    """``decode_step(model, caches, tokens (B, 1), pos) -> (next token
    (B,), last logits (B, V), caches)``: greedy argmax over the padded
    vocabulary, as the reference.  ``pos`` (an int) is the new token's
    absolute position; the caches are updated in place."""
    dev = resolve_device(device)

    def decode_step(params: tfm.Model, caches: Dict, tokens: torch.Tensor,
                    pos: int):
        batch = _on(dev, params, {"tokens": tokens})
        positions = torch.full((1,), int(pos), dtype=torch.int64, device=dev)
        with torch.no_grad():
            logits, new_caches, _ = tfm.forward(
                params, cfg, rules, batch, mode="decode", caches=caches,
                positions=positions)
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        return next_tok, logits[:, -1], new_caches

    return decode_step
