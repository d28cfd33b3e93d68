"""Batched LM serving driver: prefill + greedy decode over a request queue
(the port's counterpart of the JAX package's ``launch/serve.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --smoke --requests 8 --max-new 32          # a smoke config
  PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke   # full width
  ... --device cpu                               # on the CPU

Structure mirrors a production server: a request queue feeds fixed-size
batches; prefill fills a KV cache padded to the decode budget; the decode
loop runs until every sequence has max-new tokens.  The watchdog flags slow
steps (straggler mitigation hook); as in the reference, a step's time is
its host time (the card runs asynchronously).

``serve`` runs on CUDA unless ``device="cpu"`` is passed, and raises when
no card is present and none was asked for.  On a mesh of several ranks
(``make_host_mesh()`` under a process group, or ``mesh=``) every rank
calls it: the model is tensor-parallel over "model" with its fsdp dims
over "data" (``launch.steps.build_params(mesh=)``), every rank draws the
same prompts from the one seeded generator and serves its rows of each
batch over "data" (all of them when the batch does not split), and the
generated tokens are gathered so that every rank returns them all.

  ... --device cpu --mesh 1x4                    # 4 gloo ranks, (1, 4)
  ... --mesh 2x2                                 # 4 cards over NCCL
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List

import numpy as np
import torch
import torch.distributed as dist

from ..compat import gather, local_block, resolve_device
from ..configs import get_config, smoke_config
from ..distributed.fault import StepWatchdog
from ..distributed.sharding import MeshRules
from ..models.transformer import pad_caches
from .mesh import make_host_mesh, make_lm_mesh, parse_mesh, spawn
from .steps import build_params, make_decode_step, make_prefill_step


def serve(arch: str, *, smoke: bool = True, requests: int = 8,
          batch: int = 4, prompt_len: int = 32, max_new: int = 16,
          mesh=None, seed: int = 0, device=None,
          timer: Callable[[], float] = time.perf_counter
          ) -> List[List[int]]:
    """Serve ``requests`` random prompts; returns each request's
    ``max_new`` generated tokens.  ``timer`` is the clock of the printed
    throughput and of the watchdog."""
    cfg = smoke_config(arch) if smoke else get_config(arch)
    mesh = mesh or make_host_mesh(device)
    dev = mesh.device if mesh is not None else resolve_device(device)
    rules = MeshRules.for_mesh(mesh)
    rng = np.random.default_rng(seed)
    rows = (rules.batch_size if batch % rules.batch_size == 0 else 1)
    row_spec = (rules.resolve("batch") if rows > 1 else None, None)

    params = build_params(cfg, seed=seed, device=dev, mesh=mesh)
    prefill = make_prefill_step(cfg, rules, device=dev)
    decode = make_decode_step(cfg, rules, device=dev)
    wd = StepWatchdog(tolerance=4.0, timer=timer)

    done = 0
    step = 0   # monotonic global watchdog step id across batches
    results: List[List[int]] = []
    while done < requests:
        n = min(batch, requests - done)
        prompts = torch.as_tensor(rng.integers(0, cfg.vocab,
                                               (batch, prompt_len)))
        if rows > 1:   # this rank's rows of the batch
            prompts = local_block(prompts, row_spec, mesh)
        toks = prompts.to(device=dev, dtype=torch.int64)
        t0 = timer()
        logits, caches = prefill(params, {"tokens": toks})
        caches = pad_caches(caches, cfg, max_seq=prompt_len + max_new)
        cur = torch.argmax(logits, dim=-1)[:, None]
        outs = [cur]
        for i in range(max_new - 1):
            wd.start(step)
            step += 1
            nxt, _, caches = decode(params, caches, cur, prompt_len + i)
            cur = nxt[:, None]
            outs.append(cur)
            wd.stop()
        gen = torch.cat(outs, dim=1)
        if rows > 1:
            gen = gather(gen, row_spec, mesh)
        gen = gen[:n].cpu()   # waits for the card
        dt = timer() - t0
        results.extend(gen.tolist())
        done += n
        print(f"[serve] batch of {n}: {max_new} toks in {dt*1e3:.0f}ms "
              f"({n * max_new / dt:.0f} tok/s)", flush=True)
    if wd.flagged:
        print(f"[serve] straggler decode steps: {wd.flagged[:5]}",
              flush=True)
    return results


def _serve_rank(shape, kwargs: dict) -> None:
    out = serve(mesh=make_lm_mesh(shape, kwargs.get("device")), **kwargs)
    if dist.get_rank() == 0:
        print(f"[serve] completed {len(out)} requests")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="qwen3-8b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True, help="a reduced config (--no-smoke: the "
                    "published widths)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", type=str, default=None,
                    help="default: the current CUDA device")
    ap.add_argument("--mesh", type=parse_mesh, default=None,
                    help="DATAxMODEL: spawn that many ranks (NCCL, or gloo "
                    "with --device cpu) on that mesh")
    args = ap.parse_args()
    kwargs = dict(arch=args.arch, smoke=args.smoke, requests=args.requests,
                  batch=args.batch, prompt_len=args.prompt_len,
                  max_new=args.max_new, device=args.device)
    if args.mesh is not None:
        spawn(_serve_rank, args.mesh[0] * args.mesh[1], args.device,
              args.mesh, kwargs)
        return
    out = serve(**kwargs)
    print(f"[serve] completed {len(out)} requests")


if __name__ == "__main__":
    main()
