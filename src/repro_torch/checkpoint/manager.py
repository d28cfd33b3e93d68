"""Checkpoints with atomic writes, CRCs, retention and auto-resume (the
port's counterpart of the JAX package's ``checkpoint/manager.py``, in its
on-disk format, so that a float32 checkpoint written by either package
restores in the other).

* **Atomicity** — a step is written into ``step_<n>.tmp/`` and renamed to
  ``step_<n>/`` only after every array and the manifest (with per-array
  CRC32) have been flushed.  A crash mid-write leaves only a ``.tmp`` dir,
  which restore ignores and the next save removes.
* **Format** — one ``.npy`` per array, named by its tree path with ``/``
  as ``__``; ``manifest.json`` holds ``step``, each array's file, dtype,
  shape and CRC32 of its bytes, and the partition specs by name.  A
  bfloat16 tensor is stored as its ``uint16`` bits with ``"bfloat16"`` as
  its manifest dtype (no ``ml_dtypes`` needed to read or write it).
* **Auto-resume** — ``latest_step()`` is the newest *valid* checkpoint
  (manifest present, CRCs match); corrupt ones are skipped.
* **Retention** — keeps the newest ``keep_n`` checkpoints.

State trees are nested dicts whose leaves are tensors, numpy arrays or
Python numbers; array names are the ``/``-joined paths (the reference's
tree paths: ``params/decoder/layer0/attn/wq``, ``opt/m/...``,
``opt/count``).  ``restore`` returns the tree with tensors on a device:
CUDA unless the caller names one (``compat.resolve_device``), or the
mesh's device.

On a mesh (``save(..., mesh=)``) each leaf is this rank's block under its
spec in ``pspecs``: the blocks are gathered whole and only the mesh's root
writes files, so the format is the same whatever the mesh.
``restore(mesh=, pspecs=)`` keeps each rank's block of every array with a
spec (the elastic re-shard: any mesh, whatever mesh saved it).
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

import torch.distributed as dist

from ..compat import gather, local_block, resolve_device

BF16 = "bfloat16"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        keys = path.split("/")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return tree


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(the array as stored, its manifest dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        return t.numpy(), str(t.numpy().dtype)
    host = np.asarray(leaf)
    return host, str(host.dtype)


def _from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == BF16:
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _spec_json(spec):
    return [None if a is None else list(a) if isinstance(a, (tuple, list))
            else a for a in tuple(spec)]


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any],
             pspecs: Optional[Dict[str, Any]] = None, *, mesh=None) -> str:
        """Write ``state`` as step ``step``; with ``mesh`` (every rank of
        it calls this) the leaves are blocks under ``pspecs``."""
        tmp = os.path.join(self.dir, f"step_{step:010d}.tmp")
        final = os.path.join(self.dir, f"step_{step:010d}")
        sharded = mesh is not None and mesh.size > 1
        if sharded:
            writer = dist.get_rank() == mesh.root
            flat_specs = _flatten(pspecs) if pspecs is not None else {}
        else:
            writer = True
        if writer:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        manifest: Dict[str, Any] = {"step": step, "arrays": {}}
        for name, leaf in _flatten(state).items():
            if sharded and name in flat_specs:
                leaf = gather(leaf.contiguous(), flat_specs[name], mesh)
            if not writer:
                continue
            host, dtype = _to_host(leaf)
            fname = name.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), host)
            manifest["arrays"][name] = {
                "file": fname, "dtype": dtype, "shape": list(host.shape),
                "crc32": zlib.crc32(host.tobytes())}
        if not writer:
            dist.barrier(group=mesh.group)   # the root's files are there
            return final
        if pspecs is not None:
            manifest["pspecs"] = {k: _spec_json(v)
                                  for k, v in _flatten(pspecs).items()}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):   # idempotent re-save of the same step
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        if sharded:
            dist.barrier(group=mesh.group)
        return final

    # -- restore ------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if self._valid(os.path.join(self.dir, d)):
                    steps.append(int(d[5:]))
        return max(steps) if steps else None

    def _valid(self, path: str) -> bool:
        mf = os.path.join(path, "manifest.json")
        if not os.path.exists(mf):
            return False
        try:
            with open(mf) as f:
                manifest = json.load(f)
            for meta in manifest["arrays"].values():
                arr = np.load(os.path.join(path, meta["file"]))
                if zlib.crc32(arr.tobytes()) != meta["crc32"]:
                    return False
            return True
        except Exception:
            return False

    def restore(self, step: Optional[int] = None, *, device=None,
                mesh=None, pspecs: Optional[Dict[str, Any]] = None,
                ) -> Tuple[int, Dict[str, Any]]:
        """Load a checkpoint (the newest valid one by default) as a tree of
        tensors on ``device`` (CUDA unless asked), or on ``mesh``'s device:
        there each array named in ``pspecs`` is this rank's block under
        its spec (an elastic re-shard), the others whole."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no valid checkpoint in {self.dir}")
        dev = mesh.device if mesh is not None else resolve_device(device)
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        flat_specs = _flatten(pspecs) if pspecs is not None else {}
        flat = {}
        for name, meta in manifest["arrays"].items():
            host = _from_host(np.load(os.path.join(path, meta["file"])),
                              meta["dtype"], "cpu")
            if mesh is not None and mesh.size > 1 and name in flat_specs:
                host = local_block(host, flat_specs[name], mesh)
            flat[name] = host.to(dev)
        return step, _unflatten(flat)

    def _gc(self) -> None:
        entries = sorted(
            d for d in os.listdir(self.dir)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for d in entries[:-self.keep_n]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)
        for d in os.listdir(self.dir):
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)
