"""Deterministic synthetic LM data (the port's counterpart of the JAX
package's ``data/pipeline.py``).

Step-addressable: ``batch_for_step(step)`` is a pure function of (seed,
step), drawn with ``np.random.default_rng((seed, step))`` exactly as the
reference, so the tokens are the reference's bit for bit and a restarted
run replays the same stream — the property the checkpoint layer relies on
(no data-loader state to snapshot beyond the step counter).

Batches follow each architecture's inputs: tokens and labels, plus
``src_tokens`` (text encoder) or ``modality_embeds`` (audio / vision
stubs).  ``device_batch`` places one batch on a device;
``sharded_batch`` gives a rank of a mesh its rows of it (the reference's
``sharded_batch``: the same step-addressed batch, split by
``batch_specs``, so the tokens match bit for bit);
``prefetch`` overlaps host synthesis with device steps on a bounded
producer thread, and copies each batch to the device on the consumer's
stream.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..compat import local_block, resolve_device
from ..distributed.sharding import MeshRules
from ..models.config import ModelConfig, ShapeConfig


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                rules: MeshRules) -> Dict[str, tuple]:
    """Partition specs (the port's plain tuples) of one global batch."""
    b = rules.batch if isinstance(rules.batch, tuple) else (rules.batch,)
    bspec = b if len(b) > 1 else b[0]
    specs = {"tokens": (bspec, None), "labels": (bspec, None)}
    if cfg.n_enc_layers > 0 and cfg.modality is None:
        specs["src_tokens"] = (bspec, None)
    if cfg.modality is not None:
        specs["modality_embeds"] = (bspec, None, None)
    return specs


class SyntheticLM:
    """Zipfian token stream with shift-by-one labels."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 batch_override: Optional[int] = None,
                 seq_override: Optional[int] = None):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.batch = batch_override or shape.global_batch
        self.seq = seq_override or shape.seq_len
        # zipf-ish unigram distribution over the real (unpadded) vocab
        v = cfg.vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)

    def batch_for_step(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        toks = rng.choice(self.cfg.vocab, size=(self.batch, self.seq + 1),
                          p=self._probs).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.n_enc_layers > 0 and self.cfg.modality is None:
            batch["src_tokens"] = rng.choice(
                self.cfg.vocab, size=(self.batch, self.seq)).astype(np.int32)
        if self.cfg.modality is not None:
            n = (self.seq if self.cfg.modality == "audio"
                 else min(self.cfg.n_modality_tokens, self.seq))
            batch["modality_embeds"] = rng.standard_normal(
                (self.batch, n, self.cfg.d_model)).astype(np.float32)
        return batch

    @staticmethod
    def to_device(host: Dict[str, np.ndarray],
                  device) -> Dict[str, torch.Tensor]:
        """A host batch as tensors on ``device``: token ids as int64 (what
        ``F.embedding`` and ``gather`` index with), embeddings float32."""
        out = {}
        for k, v in host.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = (t.long() if v.dtype.kind == "i" else t).to(device)
        return out

    def device_batch(self, step: int, device=None) -> Dict[str, torch.Tensor]:
        """Step ``step``'s batch on ``device`` (CUDA unless asked)."""
        return self.to_device(self.batch_for_step(step),
                              resolve_device(device))

    def sharded_batch(self, step: int, mesh, rules: MeshRules
                      ) -> Dict[str, torch.Tensor]:
        """This rank's block of step ``step``'s batch on the mesh's device
        (the whole batch without a mesh), under ``launch.steps.
        batch_pspecs`` (a batch of one is replicated)."""
        from ..launch.steps import batch_pspecs
        host = self.batch_for_step(step)
        if mesh is None:
            return self.to_device(host, resolve_device(None))
        shape = dataclasses.replace(self.shape, global_batch=self.batch)
        specs = batch_pspecs(self.cfg, shape, rules)
        whole = self.to_device(host, torch.device("cpu"))
        return {k: local_block(v, specs[k], mesh).to(mesh.device)
                for k, v in whole.items()}

    def prefetch(self, start_step: int, device=None,
                 depth: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
        """Batches from ``start_step`` on: a producer thread synthesizes up
        to ``depth`` host batches ahead; each is copied to ``device`` on
        the consumer's current stream when it is taken."""
        dev = resolve_device(device)
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set():
                item = self.batch_for_step(step)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                yield self.to_device(q.get(), dev)
        finally:
            stop.set()
            th.join(timeout=5.0)
