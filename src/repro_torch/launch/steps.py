"""Step builders: parameters, train, prefill and decode (the port's
counterpart of the JAX package's ``launch/steps.py``).

``build_params`` draws the model's float32 masters on a device; the step
builders return plain functions over (model, batch, caches) that run
eagerly.  The serving steps run under ``torch.no_grad``; the train step
turns gradients on for the model's parameters (serving builds them with
``requires_grad=False``), runs forward and backward (with recomputation
under ``remat``, ``models.transformer.apply_stack``) through
:func:`chunked_lm_loss`, and applies AdamW in place.  Everything runs on
CUDA unless the caller passes ``device="cpu"``, and raises when there is
no card and none was asked for (``compat.resolve_device``).

The reference's ``build_cell``, ``input_specs`` and ``cache_state``
assemble XLA dry-run cells (``launch/dryrun.py``) and have no counterpart
here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..compat import resolve_device
from ..data.pipeline import batch_specs
from ..distributed.sharding import MeshRules, ParamBuilder
from ..models import transformer as tfm
from ..models.config import ModelConfig, ShapeConfig
from ..models.convert import param_leaves
from ..optim.adamw import AdamWConfig, adamw_update
from ..optim.compress import bf16_compress


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


def opt_pspecs(params_pspecs) -> Dict:
    """AdamW state specs: the moments follow their parameters."""
    return {"m": params_pspecs, "v": params_pspecs, "count": ()}


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig,
                 rules: MeshRules) -> Dict[str, tuple]:
    """One batch's specs; a batch of one is replicated."""
    specs = batch_specs(cfg, shape, rules)
    if shape.global_batch == 1:
        specs = {k: (None,) * len(v) for k, v in specs.items()}
    return specs


def chunked_lm_loss(hidden: torch.Tensor, head_w: torch.Tensor,
                    labels: torch.Tensor, vocab: int,
                    chunk: int = 512) -> torch.Tensor:
    """Fused head matmul + CE over sequence chunks, as the reference.

    Never builds the full (B, S, V) logits: each chunk computes (B, chunk,
    V) under ``torch.utils.checkpoint`` (recomputed in backward), reduces
    it to a summed loss, and only that sum is kept.  ``S % chunk`` falls
    back to one chunk of the whole sequence.  Returns the mean over B*S.
    """
    from torch.utils.checkpoint import checkpoint
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s  # fallback (tiny smoke shapes)
    v_pad = head_w.shape[-1]
    pad_mask = (torch.arange(v_pad, device=hidden.device) >= vocab) \
        if v_pad > vocab else None

    def one_chunk(h, lab, w):
        logits = (h @ w.to(h.dtype)).float()
        if pad_mask is not None:
            logits = torch.where(pad_mask[None, None, :], -1e30, logits)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab[..., None].long())[..., 0]
        return torch.sum(lse - gold)

    ckpt = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        h, lab = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        total = total + (checkpoint(one_chunk, h, lab, head_w,
                                    use_reentrant=False)
                         if ckpt else one_chunk(h, lab, head_w))
    return total / (b * s)


def loss_fn(model: tfm.Model, cfg: ModelConfig,
            rules: Optional[MeshRules], batch: Dict, *, remat: bool = True
            ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The reference's ``loss_fn``: ``(loss + router_aux_coef * aux,
    (loss, aux))`` through the chunked loss."""
    (hidden, head_w), _, aux = tfm.forward(
        model, cfg, rules, batch, mode="train", remat=remat,
        return_hidden=True)
    loss = chunked_lm_loss(hidden, head_w, batch["labels"], cfg.vocab)
    return loss + cfg.router_aux_coef * aux, (loss, aux)


def loss_and_grads(model: tfm.Model, cfg: ModelConfig,
                   rules: Optional[MeshRules], batch: Dict, *,
                   remat: bool = True):
    """``(loss, aux, grads)``: one forward and backward; ``grads`` keyed as
    ``models.convert.param_leaves`` (zeros for a parameter the loss does
    not reach, as ``jax.grad`` gives).  The parameters' ``.grad`` are
    cleared again."""
    leaves = param_leaves(model)
    model.requires_grad_(True)
    for p in leaves.values():
        p.grad = None
    try:
        with torch.enable_grad():
            total, (loss, aux) = loss_fn(model, cfg, rules, batch,
                                         remat=remat)
            total.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in leaves.items()}
    finally:
        for p in leaves.values():
            p.grad = None
        model.requires_grad_(False)
    return loss.detach(), aux.detach(), grads


def make_train_step(cfg: ModelConfig, rules: Optional[MeshRules] = None,
                    opt_cfg: Optional[AdamWConfig] = None, *,
                    remat: bool = True, grad_compress: bool = True,
                    accum_steps: int = 1, device=None):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``, the parameters and the state updated in place.

    ``accum_steps > 1`` runs sequential micro-batches (the batch's leading
    dim split into ``accum_steps`` contiguous parts, as the reference's
    reshape) and accumulates their gradients in bfloat16, then divides by
    ``accum_steps``; loss and aux are the micro-batches' means.  With
    ``grad_compress`` the gradients are cast to bfloat16 before the
    update, as the reference; AdamW re-accumulates in float32.  ``metrics``
    holds ``loss`` and ``aux_loss`` as 0-d tensors on the device."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(model: tfm.Model, opt_state: Dict, batch: Dict):
        batch = _on(dev, model, batch)
        if accum_steps == 1:
            loss, aux, grads = loss_and_grads(model, cfg, rules, batch,
                                              remat=remat)
        else:
            mb = batch["tokens"].shape[0] // accum_steps
            grads, loss, aux = None, 0.0, 0.0
            for i in range(accum_steps):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, a, g = loss_and_grads(model, cfg, rules, micro,
                                         remat=remat)
                if grads is None:
                    grads = {k: t.to(torch.bfloat16) for k, t in g.items()}
                else:
                    for k, t in g.items():
                        grads[k] = grads[k] + t.to(torch.bfloat16)
                del g
                loss, aux = loss + l, aux + a
            grads = {k: t / accum_steps for k, t in grads.items()}
            loss, aux = loss / accum_steps, aux / accum_steps
        if grad_compress:
            grads = bf16_compress(grads)
        adamw_update(grads, opt_state, param_leaves(model), opt_cfg)
        return model, opt_state, {"loss": loss, "aux_loss": aux}

    return train_step


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
