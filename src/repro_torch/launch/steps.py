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

On a mesh (``rules.mesh``, every rank running the same steps) the model
holds this rank's blocks (``build_params(mesh=)``), the batch is this
rank's rows (``data.pipeline.SyntheticLM.sharded_batch``), the loss is
vocab-parallel (:func:`chunked_lm_loss`), and after backward each
gradient is summed over the batch axes that do not split its parameter
(``sharding.reduce_grads``; the split ones were reduce-scattered in
backward), in bfloat16 under ``grad_compress``.  Each rank backpropagates
its rows' loss over the batch ranks' count, so the sums are the whole
batch's mean gradient; the loss and aux reported are the whole batch's.

The reference's ``build_cell``, ``input_specs`` and ``cache_state``
assemble XLA dry-run cells (``launch/dryrun.py``) and have no counterpart
here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..compat import resolve_device
from ..data.pipeline import batch_specs
from ..distributed.sharding import (MeshRules, ParamBuilder, batch_mean,
                                    param_pspecs, reduce_grads, tp_sum)
from ..models import transformer as tfm
from ..models.config import ModelConfig, ShapeConfig
from ..models.convert import param_leaves
from ..optim.adamw import AdamWConfig, adamw_update
from ..optim.compress import bf16_compress


def build_params(cfg: ModelConfig, *, seed: int = 0,
                 param_dtype: torch.dtype = torch.float32,
                 device=None, mesh=None) -> tfm.Model:
    """The model with parameters drawn from ``seed`` on ``device`` (the
    mesh's device with ``mesh``, holding this rank's block of each; the
    spec tree is ``sharding.param_pspecs(model)``)."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    builder = ParamBuilder(seed, dtype=param_dtype, device=dev,
                           rules=MeshRules.for_mesh(mesh))
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
                    chunk: int = 512,
                    rules: Optional[MeshRules] = None) -> torch.Tensor:
    """Fused head matmul + CE over sequence chunks, as the reference.

    Never builds the full (B, S, V) logits: each chunk computes (B, chunk,
    V) under ``torch.utils.checkpoint`` (recomputed in backward), reduces
    it to a summed loss, and only that sum is kept.  ``S % chunk`` falls
    back to one chunk of the whole sequence.  Returns the mean over B*S.

    Vocab-parallel on a mesh: ``head_w`` is this rank's vocab columns; the
    max and the sum of exponentials reduce over "model", and the target
    logit comes from the rank that holds it (the padded columns past
    ``vocab`` stay masked on whichever rank holds them).
    """
    from torch.utils.checkpoint import checkpoint
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s  # fallback (tiny smoke shapes)
    v_loc = head_w.shape[-1]
    tp = rules.tp_size if rules is not None else 1
    v0 = rules.tp_index * v_loc if tp > 1 else 0
    cols = v0 + torch.arange(v_loc, device=hidden.device)
    pad_mask = (cols >= vocab) if v0 + v_loc > vocab else None

    def one_chunk(h, lab, w):
        logits = (h @ w.to(h.dtype)).float()
        if pad_mask is not None:
            logits = torch.where(pad_mask[None, None, :], -1e30, logits)
        if tp == 1:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, lab[..., None].long())[..., 0]
            return torch.sum(lse - gold)
        m = logits.detach().amax(dim=-1)
        torch.distributed.all_reduce(m, torch.distributed.ReduceOp.MAX,
                                     group=rules.group(rules.tp))
        lse = m + torch.log(tp_sum(torch.exp(logits - m[..., None])
                                   .sum(dim=-1), rules))
        local = lab.long() - v0
        mine = (local >= 0) & (local < v_loc)
        gold = torch.gather(logits, -1,
                            torch.where(mine, local, 0)[..., None])[..., 0]
        gold = tp_sum(torch.where(mine, gold, 0.0), rules)
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
    loss = chunked_lm_loss(hidden, head_w, batch["labels"], cfg.vocab,
                           rules=rules)
    return loss + cfg.router_aux_coef * aux, (loss, aux)


def loss_and_grads(model: tfm.Model, cfg: ModelConfig,
                   rules: Optional[MeshRules], batch: Dict, *,
                   remat: bool = True):
    """``(loss, aux, grads)``: one forward and backward; ``grads`` keyed as
    ``models.convert.param_leaves`` (zeros for a parameter the loss does
    not reach, as ``jax.grad`` gives).  The parameters' ``.grad`` are
    cleared again.  On a mesh ``grads`` are this rank's blocks of the
    whole batch's gradients and ``loss``/``aux`` the whole batch's."""
    leaves = param_leaves(model)
    n_batch = rules.batch_size if rules is not None else 1
    model.requires_grad_(True)
    for p in leaves.values():
        p.grad = None
    try:
        with torch.enable_grad():
            total, (loss, aux) = loss_fn(model, cfg, rules, batch,
                                         remat=remat)
            (total / n_batch if n_batch > 1 else total).backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in leaves.items()}
    finally:
        for p in leaves.values():
            p.grad = None
        model.requires_grad_(False)
    if n_batch > 1:
        grads = reduce_grads(grads, param_pspecs(model), rules)
        loss = batch_mean(loss.detach(), rules)
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
    dev = _step_device(rules, device)
    opt_cfg = opt_cfg or AdamWConfig()
    if grad_compress and rules is not None:
        # the batch axes' gradient sums run in bfloat16, as the reference's
        # compression halves its reduce-scatter bytes
        rules = dataclasses.replace(rules, grad_dtype=torch.bfloat16)

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
        adamw_update(grads, opt_state, param_leaves(model), opt_cfg,
                     rules=rules)
        return model, opt_state, {"loss": loss, "aux_loss": aux}

    return train_step


def _step_device(rules: Optional[MeshRules], device) -> torch.device:
    """The mesh's device on a mesh, else ``device`` (CUDA unless asked)."""
    if rules is not None and rules.mesh is not None:
        return rules.mesh.device
    return resolve_device(device)


def _on(device: torch.device, model: tfm.Model, batch: Dict) -> Dict:
    if model.embed.device != device:
        raise ValueError(f"the model's parameters are on "
                         f"{model.embed.device}, the step runs on {device}")
    return {k: v.to(device) for k, v in batch.items()}


def make_prefill_step(cfg: ModelConfig, rules: Optional[MeshRules] = None,
                      *, device=None):
    """``prefill_step(model, batch) -> (last logits (B, V), caches)``."""
    dev = _step_device(rules, device)

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
    dev = _step_device(rules, device)

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
