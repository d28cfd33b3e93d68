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

The other direction serves training: :func:`param_leaves` keys the
model's parameters by ``(reference path, super-block)`` (the super-block
is None outside a stack), the keys the optimizer state uses, and
:func:`leaves_to_tree` stacks such leaves back into the reference's tree
(:func:`params_to_reference` for the parameters,
:func:`opt_state_to_reference` for AdamW's ``m``, ``v`` and ``count``).
:func:`tree_to_leaves` and :func:`opt_state_from_reference` read a
reference tree (or a checkpoint's) back into leaves, and
:func:`load_params` copies one into a model in place.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..compat import resolve_device
from ..distributed.sharding import MeshRules, place
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
    the reference's tree, each this rank's block on ``mesh`` (recorded in
    ``specs`` as ``ParamBuilder`` does)."""

    def __init__(self, tree: Dict, *, device=torch.device("cpu"),
                 mesh=None):
        self.tree = tree
        self.device = torch.device(device)
        self.rules = MeshRules.for_mesh(mesh)
        self.specs: Dict[str, tuple] = {}

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
        spec = self.specs[path] = self.rules.spec(*logical)
        return place(out, spec, self.rules.mesh)


def params_from_reference(tree: Dict, cfg: ModelConfig, device=None,
                          mesh=None) -> Model:
    """The port's model holding the reference parameter tree's values
    (this rank's blocks on ``mesh``, on its device).  ``device=None`` is
    the card, and raises without one (``compat.resolve_device``): pass
    ``device="cpu"`` for the CPU."""
    device = mesh.device if mesh is not None else resolve_device(device)
    return init_model(TreeBuilder(tree, device=device, mesh=mesh), cfg)


def caches_from_reference(tree: Dict, device=None) -> Dict:
    """The reference's stacked cache tree -> the port's per-super-block
    cache dicts, on ``device`` (the card unless asked, as
    :func:`params_from_reference`)."""
    device = resolve_device(device)
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


# ---------------------------------------------------------------------------
# the port's parameters and optimizer state as the reference's trees
# ---------------------------------------------------------------------------

#: A parameter's key: its reference tree path and its super-block (None
#: for a leaf outside a stack).
LeafKey = Tuple[str, Optional[int]]

_STACKS = ("decoder", "encoder")


def reference_key(name: str) -> LeafKey:
    """``decoder.layer0.3.attn.wq`` -> ``("decoder/layer0/attn/wq", 3)``;
    ``final_norm.scale`` -> ``("final_norm/scale", None)``."""
    parts = name.split(".")
    if parts[0] in _STACKS:
        return "/".join(parts[:2] + parts[3:]), int(parts[2])
    return "/".join(parts), None


def param_leaves(model: nn.Module) -> Dict[LeafKey, nn.Parameter]:
    """The model's parameters by :data:`LeafKey`, in module order."""
    return {reference_key(n): p for n, p in model.named_parameters()}


def _set_path(tree: Dict, path: str, value) -> None:
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _get_path(tree: Dict, path: str):
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


def leaves_to_tree(leaves: Mapping[LeafKey, torch.Tensor], *,
                   as_numpy: bool = False) -> Dict:
    """Leaves -> the reference's nested tree: a stack's leaves stacked
    along a new leading dim in super-block order.  ``as_numpy``: numpy on
    the host (bfloat16 as float32, exactly)."""
    grouped: Dict[str, Dict[Optional[int], torch.Tensor]] = {}
    for (path, r), t in leaves.items():
        grouped.setdefault(path, {})[r] = t.detach()
    tree: Dict = {}
    for path, reps in grouped.items():
        t = reps[None] if None in reps else torch.stack(
            [reps[r] for r in sorted(reps)])
        if as_numpy:
            t = t.float().cpu().numpy() if t.dtype == torch.bfloat16 \
                else t.cpu().numpy()
        _set_path(tree, path, t)
    return tree


def tree_to_leaves(tree: Dict, keys, device=None) -> Dict[LeafKey,
                                                           torch.Tensor]:
    """The reference tree's values for ``keys`` (each a super-block's
    slice of its stacked leaf), as tensors on ``device`` (default: where
    they are; numpy leaves on the CPU)."""
    out = {}
    for path, r in keys:
        leaf = _get_path(tree, path)
        if not isinstance(leaf, torch.Tensor):
            leaf = _to_torch(leaf, device or "cpu")
        t = leaf if r is None else leaf[r]
        out[(path, r)] = t if device is None else t.to(device)
    return out


def params_to_reference(model: nn.Module) -> Dict:
    """The model's parameters as the reference's nested numpy tree (their
    gradients, keyed as ``param_leaves``: ``leaves_to_tree``)."""
    return leaves_to_tree(param_leaves(model), as_numpy=True)


@torch.no_grad()
def load_params(model: nn.Module, tree: Dict) -> nn.Module:
    """Copy a reference-layout tree (numpy or tensors) into the model's
    parameters in place."""
    leaves = param_leaves(model)
    for k, v in tree_to_leaves(tree, leaves).items():
        leaves[k].copy_(v)
    return model


def opt_state_to_reference(state: Dict, *, as_numpy: bool = True) -> Dict:
    """AdamW state (``optim.adamw_init``'s leaves) -> the reference's
    ``{"m": tree, "v": tree, "count": int32}``."""
    count = state["count"]
    return {"m": leaves_to_tree(state["m"], as_numpy=as_numpy),
            "v": leaves_to_tree(state["v"], as_numpy=as_numpy),
            "count": (np.asarray(int(count), np.int32) if as_numpy
                      else count)}


def opt_state_from_reference(tree: Dict, model: nn.Module,
                             device=None) -> Dict:
    """The reference's (or a checkpoint's) AdamW tree -> the port's state
    for ``model``'s parameters, on ``device`` (default: the parameters')."""
    keys = param_leaves(model)
    dev = device or next(iter(keys.values())).device
    count = tree["count"]
    count = count.to(dev) if isinstance(count, torch.Tensor) else \
        torch.as_tensor(np.asarray(count), dtype=torch.int32, device=dev)
    return {"m": tree_to_leaves(tree["m"], keys, dev),
            "v": tree_to_leaves(tree["v"], keys, dev),
            "count": count.to(torch.int32).reshape(())}
