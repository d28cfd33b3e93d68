"""The weights and caches carried across from the JAX package.

The port's modules keep the reference's leaf names, so the conversion is a
table: the reference's tree path ``decoder/layer0/attn/wq`` (a stacked
``(n_repeat, ...)`` leaf) is the port's ``decoder.layer0.<r>.attn.wq`` for
each super-block ``r``.  :func:`params_from_reference` builds the port's
:class:`~.transformer.Model` with a ``TreeBuilder`` that reads each leaf by
that path, so it takes exactly the tree ``init_model`` built on the JAX
side.  Caches convert leaf by leaf: the reference's stacked leaves split
per super-block and its ``pos`` counters become Python ints.

Trees are nested dicts of numpy arrays (``jax.tree.map(np.asarray, ...)``);
bfloat16 leaves arrive as ml_dtypes arrays and keep their dtype in torch.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .config import ModelConfig
from .transformer import Model, init_model


def _to_torch(arr, device) -> torch.Tensor:
    """A reference leaf as an owned tensor of its dtype on ``device``."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":   # ml_dtypes: exact through float32
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


class TreeBuilder:
    """A builder that reads every parameter from a nested dict of arrays
    by path (``"decoder/layer0/attn/wq"``): the port's modules built from
    the reference's tree."""

    def __init__(self, tree: Dict, *, device=torch.device("cpu")):
        self.tree = tree
        self.device = torch.device(device)

    def param(self, path: str, shape: Sequence[int],
              logical: Sequence[Optional[str]], init: str = "normal",
              scale: float = 0.02) -> torch.Tensor:
        node = self.tree
        for key in path.split("/"):
            node = node[key]
        out = _to_torch(node, self.device)
        if tuple(out.shape) != tuple(shape):
            raise ValueError(f"{path}: reference leaf of shape "
                             f"{tuple(out.shape)}, the port declares "
                             f"{tuple(shape)}")
        return out


def params_from_reference(tree: Dict, cfg: ModelConfig,
                          device="cpu") -> Model:
    """The port's model holding the reference parameter tree's values."""
    return init_model(TreeBuilder(tree, device=device), cfg)


def caches_from_reference(tree: Dict, device="cpu") -> Dict:
    """The reference's stacked cache tree -> the port's per-super-block
    cache dicts."""
    out = {}
    for name, layer in tree.items():
        reps = len(np.asarray(next(iter(layer.values()))["pos"]))
        out[name] = [{kind: {leaf: (int(np.asarray(v)[r]) if leaf == "pos"
                                    else _to_torch(np.asarray(v)[r], device))
                             for leaf, v in sub.items()}
                      for kind, sub in layer.items()}
                     for r in range(reps)]
    return out


def caches_to_reference(caches: Dict) -> Dict:
    """The port's caches -> the reference's stacked tree as numpy (bfloat16
    leaves as float32, exactly)."""
    out = {}
    for name, reps in caches.items():
        out[name] = {}
        for kind in reps[0]:
            sub = {}
            for leaf in reps[0][kind]:
                vals = [c[kind][leaf] for c in reps]
                if leaf == "pos":
                    sub[leaf] = np.asarray(vals, dtype=np.int32)
                else:
                    sub[leaf] = torch.stack(vals).detach().float().cpu() \
                        .numpy()
            out[name][kind] = sub
    return out
