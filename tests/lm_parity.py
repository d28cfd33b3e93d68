"""Shared helpers of the LM parity tests (``tests/test_torch_{layers,moe,
ssm,lm,lm_decode,data_ckpt,train,train_step}.py``): the same seeded numpy
inputs through the JAX package and the port, the JAX parameters carried
across by ``repro_torch.models.convert``.

Imports JAX, so the card-only tests (``test_torch_cuda.py``) do not use it.
"""
import dataclasses

import jax
import numpy as np
import torch

from repro.distributed.sharding import MeshRules, ParamBuilder
from repro_torch.models.convert import TreeBuilder

B, S = 2, 32
# Max-scaled tolerances (the acceptance criteria of the LM slice): float32
# logits/outputs 1e-4, the configs' bfloat16 5e-2, float32 caches 1e-5.
F32_TOL = 1e-4
BF16_TOL = 5e-2
CACHE_TOL = 1e-5


def f32(cfg):
    """The config with float32 activations: where parity is tight."""
    return dataclasses.replace(cfg, dtype="float32")


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def jax_init(init_fn, cfg, path: str, seed: int = 0, **kw):
    """A reference module's parameters, as a ``{path: tree}`` numpy tree,
    and the reference's own tree."""
    b = ParamBuilder(jax.random.key(seed), MeshRules())
    p = init_fn(b, path, cfg, **kw)
    return {path: to_numpy(p)}, p


def port_module(init_fn, tree, path: str, cfg, **kw):
    """The port's module (built by its ``init_*``) holding the reference
    tree's values."""
    return init_fn(TreeBuilder(tree), path, cfg, **kw)


def randn(shape, seed: int):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def jx(a, dtype):
    import jax.numpy as jnp
    return jnp.asarray(a, dtype)


def tt(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def scaled_err(got, ref) -> float:
    got, ref = as_np(got), as_np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref))) / (float(np.max(np.abs(ref)))
                                               + 1e-30)


def make_batch(cfg, b: int = B, s: int = S, seed: int = 0):
    """The reference smoke tests' batch (``tests/test_models_smoke.py``),
    as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.modality == "audio":
        batch["modality_embeds"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    elif cfg.modality == "vision":
        n = min(cfg.n_modality_tokens, s)
        batch["modality_embeds"] = rng.standard_normal(
            (b, n, cfg.d_model)).astype(np.float32)
    elif cfg.n_enc_layers > 0:
        batch["src_tokens"] = batch["tokens"]
    return batch


def jax_batch(batch):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.as_tensor(v).long() if v.dtype.kind == "i"
            else torch.as_tensor(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the training slice (tests/test_torch_train.py)
# ---------------------------------------------------------------------------

def train_batch(cfg, b: int = B, s: int = S, seed: int = 0):
    """One ``SyntheticLM`` batch (tokens, labels and the arch's extra
    inputs), as the reference's ``batch_for_step`` draws it."""
    from repro.data.pipeline import SyntheticLM as RefSyntheticLM
    from repro.models.config import ShapeConfig
    return RefSyntheticLM(cfg, ShapeConfig("t", "train", s, b),
                          seed=seed).batch_for_step(0)


def ref_loss_fn(cfg, rules, remat: bool = True):
    """The reference train step's ``loss_fn`` (``launch/steps.py``'s
    ``make_train_step``, a closure there): forward with ``return_hidden``,
    ``chunked_lm_loss``, plus the router aux term."""
    from repro.launch.steps import chunked_lm_loss
    from repro.models import transformer as ref_tfm

    def loss_fn(params, batch):
        (hidden, head_w), _, aux = ref_tfm.forward(
            params, cfg, rules, batch, mode="train", remat=remat,
            return_hidden=True)
        loss = chunked_lm_loss(hidden, head_w, batch["labels"], cfg.vocab)
        return loss + cfg.router_aux_coef * aux, (loss, aux)
    return loss_fn


def flat_tree(tree, prefix: str = "") -> dict:
    """A nested dict as ``{"a/b/c": leaf}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out
