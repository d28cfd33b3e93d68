"""Model assembly: embeddings, block stacks, LM heads, encoder-decoder and
multimodal wrappers, plus cache construction (the port's counterpart of
the JAX package's ``models/transformer.py``).

Layer heterogeneity (jamba's mamba:attn interleave, xlstm's sLSTM cadence,
MoE every k-th layer) is a repeating *super-block pattern*, as in the
reference.  The reference stacks identical super-blocks and runs them with
``lax.scan``; the port keeps one :class:`Block` module per layer, in a
:class:`Stack` keyed like the reference's tree — ``stack["layer{j}"][r]``
is layer ``j`` of super-block ``r`` — and runs them in a Python loop, super-
block by super-block.  A block's parameters are views of the stacked
``(n_repeat, ...)`` leaves the builder draws (``StackedBuilder``).

Caches mirror the tree too: ``caches["layer{j}"][r]`` is that layer's
cache dict (``{"attn": ..., "ssm": ..., "cross": ...}``), and ``pos`` in
each is a Python int.

Recomputation (``remat``, the reference's ``jax.checkpoint`` over each
scanned super-block, nested per layer under ``cfg.layer_remat``): in
train mode with grad enabled, ``apply_stack`` runs each layer (when
``cfg.layer_remat``) or else each super-block under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, so only the
residual stream between them is kept and backward recomputes the rest.
The reference's policy also saves each layer's ``mixer_out`` and
``ffn_out`` to spare their recomputation; the port recomputes them
(plain recomputation, no selective policy).  The values are the same
either way; only memory and time differ.

On a mesh (``rules.mesh``) the embedding and the LM head are vocab-
parallel: ``embed`` keeps its vocab rows over "model" (the lookup masks
the tokens outside this rank's rows and sums over "model") and the head's
columns are this rank's vocab slice (``forward`` gathers the logits whole;
``return_hidden`` gives the chunked loss this rank's slice).  The layers
below are tensor-parallel (``layers``, ``moe``, ``ssm``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..compat import resolve_device
from ..distributed.sharding import (MeshRules, StackedBuilder,
                                    gather_dim, shard, tp_copy, tp_sum,
                                    use)
from . import moe as moe_lib
from . import ssm as ssm_lib
from .config import ModelConfig
from .layers import as_param, init_attention, init_mlp, init_norm, rms_norm


# ---------------------------------------------------------------------------
# super-block pattern
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockPattern:
    kinds: Tuple[str, ...]        # mixer kind per layer in the super-block
    moe: Tuple[bool, ...]         # MoE FFN flag per layer
    n_repeat: int                 # number of super-blocks

    @property
    def size(self) -> int:
        return len(self.kinds)


def block_pattern(cfg: ModelConfig) -> BlockPattern:
    kinds = cfg.layer_kinds()
    moe_flags = tuple(cfg.moe_layer(i) for i in range(cfg.n_layers))
    # find the smallest repeating unit
    for unit in range(1, cfg.n_layers + 1):
        if cfg.n_layers % unit:
            continue
        reps = cfg.n_layers // unit
        if kinds == kinds[:unit] * reps and moe_flags == moe_flags[:unit] * reps:
            return BlockPattern(kinds[:unit], moe_flags[:unit], reps)
    return BlockPattern(kinds, moe_flags, 1)


def encoder_pattern(cfg: ModelConfig) -> BlockPattern:
    return BlockPattern(("attn",), (False,), cfg.n_enc_layers)


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------

_SSM_INITS = {"mlstm": ssm_lib.init_mlstm, "slstm": ssm_lib.init_slstm,
              "mamba": ssm_lib.init_mamba, "fft_conv": ssm_lib.init_fft_conv}


def _mixer_kind(cfg: ModelConfig, kind: str) -> str:
    if kind == "mamba" and cfg.ssm_impl == "fft_conv":
        return "fft_conv"
    return kind


class Block(nn.Module):
    """One layer: pre-norm mixer (attention or an SSM), optional cross
    attention, pre-norm FFN (MLP or MoE); ``forward`` returns
    ``(x, new_cache or None, aux)``."""

    def __init__(self, b, path: str, cfg: ModelConfig, kind: str,
                 use_moe: bool, cross: bool = False):
        super().__init__()
        self.cfg = cfg
        self.kind = _mixer_kind(cfg, kind)
        self.use_moe = use_moe
        d, eps = cfg.d_model, cfg.norm_eps
        self.norm1 = init_norm(b, f"{path}/norm1", d, eps)
        if self.kind == "attn":
            self.attn = init_attention(b, f"{path}/attn", cfg)
        else:
            self.ssm = _SSM_INITS[self.kind](b, f"{path}/ssm", cfg)
        if cross:
            self.norm_x = init_norm(b, f"{path}/norm_x", d, eps)
            self.cross = init_attention(b, f"{path}/cross", cfg, cross=True)
        if cfg.d_ff > 0:
            self.norm2 = init_norm(b, f"{path}/norm2", d, eps)
            if use_moe:
                self.moe = moe_lib.init_moe(b, f"{path}/moe", cfg)
                if cfg.shared_expert:
                    self.shared_mlp = init_mlp(b, f"{path}/shared_mlp", cfg)
            else:
                self.mlp = init_mlp(b, f"{path}/mlp", cfg)

    def forward(self, x: torch.Tensor, *, mode: str,
                positions: Optional[torch.Tensor], cache: Optional[Dict],
                enc_out: Optional[torch.Tensor], causal: bool = True,
                rules: Optional[MeshRules] = None
                ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new_cache: Dict = {}
        h = self.norm1(x)
        if self.kind == "attn":
            y, c = self.attn(h, rules=rules, mode=mode, positions=positions,
                             cache=None if cache is None
                             else cache.get("attn"),
                             causal=causal, window=cfg.window)
            if c is not None:
                new_cache["attn"] = c
        else:
            y, c = self.ssm(h, rules=rules, mode=mode,
                            cache=None if cache is None else cache.get("ssm"))
            if c is not None:
                new_cache["ssm"] = c
        x = x + y
        if hasattr(self, "cross"):
            h = self.norm_x(x)
            y, c = self.cross(h, rules=rules, mode=mode, positions=positions,
                              cache=None if cache is None
                              else cache.get("cross"),
                              kv_source=enc_out, causal=False)
            if c is not None:
                new_cache["cross"] = c
            x = x + y
        if cfg.d_ff > 0:
            h = self.norm2(x)
            if self.use_moe:
                y, a = self.moe(h, rules)
                aux = aux + a
                if cfg.shared_expert:
                    y = y + self.shared_mlp(h, rules)
            else:
                y = self.mlp(h, rules)
            x = x + y
        return x, (new_cache or None), aux


def init_layer(b, path: str, cfg: ModelConfig, kind: str, use_moe: bool,
               cross: bool = False) -> Block:
    return Block(b, path, cfg, kind, use_moe, cross)


def apply_layer(p: Block, cfg: ModelConfig, rules: Optional[MeshRules],
                x: torch.Tensor, **kw):
    return p(x, rules=rules, **kw)


# ---------------------------------------------------------------------------
# stacks (a loop over super-blocks)
# ---------------------------------------------------------------------------

class Stack(nn.ModuleDict):
    """``stack["layer{j}"][r]``: layer ``j`` of super-block ``r``."""

    def __init__(self, b, path: str, cfg: ModelConfig,
                 pattern: BlockPattern, cross: bool = False):
        stacked = StackedBuilder(b, pattern.n_repeat)
        super().__init__({
            f"layer{j}": nn.ModuleList(
                init_layer(stacked.at(r), f"{path}/layer{j}", cfg, kind,
                           use_moe, cross=cross)
                for r in range(pattern.n_repeat))
            for j, (kind, use_moe) in enumerate(zip(pattern.kinds,
                                                    pattern.moe))})
        self.pattern = pattern


def init_stack(b, path: str, cfg: ModelConfig, pattern: BlockPattern,
               cross: bool = False) -> Stack:
    return Stack(b, path, cfg, pattern, cross)


def apply_stack(p: Stack, cfg: ModelConfig, rules: Optional[MeshRules],
                x: torch.Tensor, *, mode: str,
                positions: Optional[torch.Tensor], caches: Optional[Dict],
                enc_out: Optional[torch.Tensor], causal: bool = True,
                remat: bool = True
                ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """caches: ``{"layer{j}": [cache of super-block r, ...]}``.

    ``remat`` (train mode, grad enabled): each super-block, or each layer
    under ``cfg.layer_remat``, is recomputed in backward (module
    docstring)."""
    pattern = p.pattern
    ckpt = remat and mode == "train" and torch.is_grad_enabled()
    layer_ckpt = ckpt and cfg.layer_remat
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches: Dict[str, List] = {}

    def layer(x, r: int, j: int):
        name = f"layer{j}"
        lc = None if caches is None else caches[name][r]
        return apply_layer(p[name][r], cfg, rules, x, mode=mode,
                           positions=positions, cache=lc, enc_out=enc_out,
                           causal=causal)

    def superblock(x, r: int):
        aux_r = torch.zeros((), dtype=torch.float32, device=x.device)
        for j in range(pattern.size):
            if layer_ckpt:
                x, nc, a = checkpoint(layer, x, r, j, use_reentrant=False)
            else:
                x, nc, a = layer(x, r, j)
            aux_r = aux_r + a
            if nc is not None:
                new_caches.setdefault(f"layer{j}",
                                      [None] * pattern.n_repeat)[r] = nc
        return x, aux_r

    for r in range(pattern.n_repeat):
        if ckpt and not layer_ckpt:
            x, a = checkpoint(superblock, x, r, use_reentrant=False)
        else:
            x, a = superblock(x, r)
        aux = aux + a
    return x, (new_caches or None), aux


# ---------------------------------------------------------------------------
# full models
# ---------------------------------------------------------------------------

class Model(nn.Module):
    """The LM: its parameter tree is the reference's ``init_model`` tree."""

    def __init__(self, b, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.embed = as_param(b.param("embed", (cfg.padded_vocab, d),
                                      ("tp", "fsdp")))
        self.final_norm = init_norm(b, "final_norm", d, cfg.norm_eps)
        self.decoder = init_stack(b, "decoder", cfg, block_pattern(cfg),
                                  cross=cfg.n_enc_layers > 0)
        if not cfg.tie_embeddings:
            self.lm_head = as_param(b.param(
                "lm_head", (d, cfg.padded_vocab), ("fsdp", "tp")))
        if cfg.n_enc_layers > 0:
            self.encoder = init_stack(b, "encoder", cfg,
                                      encoder_pattern(cfg))
            self.enc_norm = init_norm(b, "enc_norm", d, cfg.norm_eps)
        if cfg.modality is not None:
            self.modality_proj = as_param(b.param(
                "modality_proj", (d, d), ("fsdp", "tp")))


def init_model(b, cfg: ModelConfig) -> Model:
    return Model(b, cfg)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _embed(p: Model, tokens: torch.Tensor, dtype,
           rules: Optional[MeshRules] = None) -> torch.Tensor:
    w = use(p.embed, rules)
    if rules is None or rules.tp_size == 1:
        return F.embedding(tokens, w).to(dtype)
    # this rank's vocab rows; the one holding a token's row gives it
    v0 = rules.tp_index * w.shape[0]
    local = tokens - v0
    mine = (local >= 0) & (local < w.shape[0])
    emb = F.embedding(torch.where(mine, local, 0), w) * mine[..., None]
    return tp_sum(emb, rules).to(dtype)


def _head_weight(p: Model, cfg: ModelConfig,
                 rules: Optional[MeshRules]) -> torch.Tensor:
    """The head's (D, V) weight: this rank's vocab columns on a mesh."""
    return use(p.embed, rules).T if cfg.tie_embeddings \
        else use(p.lm_head, rules)


def _head(p: Model, cfg: ModelConfig, rules: Optional[MeshRules],
          x: torch.Tensor) -> torch.Tensor:
    x = tp_copy(rms_norm(x, p.final_norm.scale, cfg.norm_eps), rules)
    w = _head_weight(p, cfg, rules).to(x.dtype)
    logits = shard(x @ w, rules, "batch", None, "tp")
    return gather_dim(logits, -1, None if rules is None
                      else rules.group(rules.tp), "slice")


def _modality_tokens(p: Model, batch: Dict, dtype,
                     rules: Optional[MeshRules] = None) -> torch.Tensor:
    """Stub frontend output -> backbone embeddings (precomputed upstream)."""
    feats = batch["modality_embeds"].to(dtype)            # (B, S_m, D)
    return feats @ use(p.modality_proj, rules, tp="slice").to(dtype)


def forward(p: Model, cfg: ModelConfig, rules: Optional[MeshRules],
            batch: Dict, *, mode: str = "train",
            caches: Optional[Dict] = None,
            positions: Optional[torch.Tensor] = None, remat: bool = True,
            return_hidden: bool = False,
            ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (logits, new_caches, aux_loss).

    batch keys: "tokens" (B, S); encdec also "modality_embeds" (B, S_src, D)
    (audio frames) or "src_tokens" — vlm replaces the first
    n_modality_tokens embeddings with projected patch embeds.

    ``remat`` recomputes the stacks in backward (train mode with grad
    enabled only; see ``apply_stack``).  ``return_hidden`` returns
    ``(normalized hidden, head weight)`` in place of the logits, for the
    chunked loss (``launch.steps.chunked_lm_loss``) that never builds the
    (B, S, V) logits.
    """
    dtype = compute_dtype(cfg)
    x = _embed(p, batch["tokens"], dtype, rules)

    enc_out = None
    if cfg.n_enc_layers > 0 and mode in ("train", "prefill"):
        enc_in = _modality_tokens(p, batch, dtype, rules) \
            if cfg.modality == "audio" else \
            _embed(p, batch["src_tokens"], dtype, rules)
        enc_out, _, _ = apply_stack(p.encoder, cfg, rules, enc_in,
                                    mode="train", positions=None,
                                    caches=None, enc_out=None, causal=False,
                                    remat=remat)
        enc_out = rms_norm(enc_out, p.enc_norm.scale, cfg.norm_eps)
    # decode: cross-attention runs from its prefilled cache (enc_out=None)

    if cfg.modality == "vision" and mode in ("train", "prefill"):
        vis = _modality_tokens(p, batch, dtype, rules)
        nm = vis.shape[1]
        x = torch.cat([vis, x[:, nm:]], dim=1)

    x, new_caches, aux = apply_stack(p.decoder, cfg, rules, x, mode=mode,
                                     positions=positions, caches=caches,
                                     enc_out=enc_out, remat=remat)
    if return_hidden:
        xh = tp_copy(rms_norm(x, p.final_norm.scale, cfg.norm_eps), rules)
        return (xh, _head_weight(p, cfg, rules)), new_caches, aux
    return _head(p, cfg, rules, x), new_caches, aux


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch_size: int, max_seq: int,
                dtype=torch.bfloat16, device=None) -> Dict:
    """Zeroed cache tree matching ``forward(mode='decode')`` expectations.

    The caches are on CUDA unless ``device`` names another device, as the
    entry points' (``compat.resolve_device``).

    Attention caches hold ``min(window, max_seq)`` slots (SWA ring buffer);
    one cache dict per super-block, as the reference's stacked leaves.
    """
    device = resolve_device(device)
    pattern = block_pattern(cfg)
    hd = cfg.resolved_head_dim()
    di = cfg.expand * cfg.d_model
    h = cfg.n_heads

    def z(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def layer_cache(kind: str) -> Dict:
        kind = _mixer_kind(cfg, kind)
        c: Dict = {}
        if kind == "attn":
            slots = min(cfg.window or max_seq, max_seq)
            c["attn"] = {"k": z((batch_size, slots, cfg.n_kv_heads, hd)),
                         "v": z((batch_size, slots, cfg.n_kv_heads, hd)),
                         "pos": 0}
        elif kind == "mlstm":
            dh = di // h
            c["ssm"] = {"C": z((batch_size, h, dh, dh), torch.float32),
                        "n": z((batch_size, h, dh), torch.float32),
                        "m": z((batch_size, h), torch.float32), "pos": 0}
        elif kind == "slstm":
            d = cfg.d_model
            c["ssm"] = {k: z((batch_size, d), torch.float32)
                        for k in ("c", "n", "m", "h")}
            c["ssm"]["pos"] = 0
        elif kind in ("mamba", "fft_conv"):
            c["ssm"] = {"conv": z((batch_size, cfg.d_conv - 1, di)),
                        "h": z((batch_size, di, cfg.d_state), torch.float32),
                        "pos": 0}
        if cfg.n_enc_layers > 0:
            c["cross"] = {"k": z((batch_size, max_seq, cfg.n_kv_heads, hd)),
                          "v": z((batch_size, max_seq, cfg.n_kv_heads, hd)),
                          "pos": 0}
        return c

    return {f"layer{j}": [layer_cache(kind) for _ in range(pattern.n_repeat)]
            for j, kind in enumerate(pattern.kinds)}


def pad_caches(caches: Dict, cfg: ModelConfig, max_seq: int) -> Dict:
    """Grow prefill-sized attention caches to a decode budget of max_seq
    slots (SSM states are seq-free and pass through unchanged).  As in the
    reference, every "k"/"v" leaf is padded, the cross-attention caches'
    included."""
    want = min(cfg.window or max_seq, max_seq)

    def fix(sub: Dict) -> Dict:
        out = dict(sub)
        for name in ("k", "v"):
            leaf = sub.get(name)
            if leaf is not None and leaf.shape[1] < want:
                out[name] = F.pad(leaf, (0, 0, 0, 0, 0, want - leaf.shape[1]))
        return out

    return {name: [{kind: fix(sub) for kind, sub in c.items()}
                   for c in reps]
            for name, reps in caches.items()}


def cache_pspec(cfg: ModelConfig, rules: MeshRules, batch_size: int,
                axis_sizes: Dict[str, int]):
    """The reference's spec policy for a cache built by ``init_caches``:
    ``make(caches)`` gives the port's cache tree with a spec per leaf (a
    super-block's leaf: the reference's stacked spec without its leading
    stack entry; ``()`` for ``pos``).

    Policy, as the reference: shard the batch dim over the batch axes when
    divisible; shard attention-cache sequence dims over "model" (decode
    SP), and over *all* axes when the batch does not divide; SSM state
    tensors shard their feature dim over "model".  Serving on a mesh
    holds its caches as its prefill computes them instead: split by K/V
    heads with the projections (``layers.Attention``), the layout the
    reference's jitted prefill hands its decode.
    """
    batch_axes = rules.batch if isinstance(rules.batch, tuple) \
        else (rules.batch,)
    batch_sz = 1
    for a in batch_axes:
        batch_sz *= axis_sizes[a]
    batch_ok = batch_size % batch_sz == 0 and batch_size >= batch_sz
    bspec = (batch_axes if len(batch_axes) > 1 else batch_axes[0]) \
        if batch_ok else None
    seq_axes = "model" if batch_ok else tuple(batch_axes) + ("model",)

    def leaf_spec(name: str, leaf) -> tuple:
        nd = leaf.dim() if isinstance(leaf, torch.Tensor) else 0
        if nd == 0:                      # "pos" counters
            return ()
        if name in ("k", "v"):           # (B, S, K, hd)
            return (bspec, seq_axes, None, None)
        if name == "C":                  # mlstm (B, H, dk, dv)
            return (bspec, None, None, "model")
        if name == "n":
            return (bspec, None, None) if nd == 3 else (bspec, "model")
        if name == "m":                  # (B, H) or (B, D)
            return (bspec, None)
        if name == "conv":               # mamba (B, kw-1, di)
            return (bspec, None, "model")
        if name == "h":                  # mamba (B, di, N) | slstm (B, D)
            return (bspec, "model", None) if nd == 3 else (bspec, "model")
        if name == "c":                  # slstm (B, D)
            return (bspec, "model")
        return (None,) * nd

    def make(caches: Dict) -> Dict:
        return {name: [{kind: {leaf: leaf_spec(leaf, v)
                               for leaf, v in sub.items()}
                        for kind, sub in c.items()} for c in reps]
                for name, reps in caches.items()}

    return make
