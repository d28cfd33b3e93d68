"""End-to-end training driver with fault tolerance (the port's counterpart
of the JAX package's ``launch/train.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
      --smoke --steps 200 --ckpt-dir /tmp/ckpt        # on the card
  ... --device cpu                                    # on the CPU

As the reference:
  * auto-resume from the newest valid checkpoint (restart-safe),
  * deterministic step-addressed data (replays exactly after restart),
  * a step watchdog (straggler flagging) and periodic checkpoints, plus a
    final save,
  * the same return dict: ``losses``, ``final_loss``, ``straggler_flags``.

Checkpoints hold ``{"params": ..., "opt": ...}`` in the reference's tree
layout (``models/convert.py``), so either package's float32 checkpoints
restore in the other.  ``train`` runs on CUDA unless ``device="cpu"`` is
passed.  A step's time is its host time up to the loss read, which waits
for the card.

On a mesh of several ranks (``make_host_mesh()`` under a process group,
``mesh=``, or ``--mesh DxM``, which spawns the ranks: gloo with ``--device
cpu``, else NCCL) every rank calls ``train``: parameters and AdamW state
are this rank's blocks under the reference's specs (tensor-parallel over
"model", fsdp over "data"), each step takes this rank's rows of the
step's batch, checkpoints hold the whole arrays with the specs in the
manifest (the mesh's root writes them), and a restore keeps this rank's
blocks whatever mesh saved them.

  ... --device cpu --smoke --mesh 2x2 --steps 20      # 4 gloo ranks
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

from ..checkpoint import CheckpointManager
from ..compat import resolve_device
from ..configs import get_config, smoke_config
from ..data.pipeline import SyntheticLM
from ..distributed.fault import StepWatchdog
from ..distributed.sharding import MeshRules, pspec_tree
from ..models.config import ShapeConfig
from ..models.convert import (leaves_to_tree, load_params,
                              opt_state_from_reference,
                              opt_state_to_reference, param_leaves)
from ..optim.adamw import AdamWConfig, adamw_init
from .mesh import make_host_mesh, make_lm_mesh, parse_mesh, spawn
from .steps import build_params, make_train_step, opt_pspecs


def train_state(model, opt_state) -> dict:
    """The checkpointed tree: parameters and AdamW state in the
    reference's layout (tensors, stacked per super-block; this rank's
    blocks on a mesh)."""
    return {"params": leaves_to_tree(param_leaves(model)),
            "opt": opt_state_to_reference(opt_state, as_numpy=False)}


def state_pspecs(model) -> dict:
    """The spec tree of :func:`train_state`, as the reference's
    ``{"params": pspecs, "opt": opt_pspecs(pspecs)}``."""
    specs = pspec_tree(model)
    return {"params": specs, "opt": opt_pspecs(specs)}


def train(arch: str, *, steps: int = 100, seq_len: int = 64,
          global_batch: int = 4, smoke: bool = True,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          log_every: int = 10, seed: int = 0, lr: float = 3e-4,
          mesh=None, stop_after: Optional[int] = None, device=None,
          timer: Callable[[], float] = time.perf_counter):
    """Train ``arch`` for ``steps`` steps (resuming from ``ckpt_dir``'s
    newest valid checkpoint); ``stop_after`` stops after that many steps
    of this run (a simulated preemption).  ``timer`` is the watchdog's
    clock."""
    cfg = smoke_config(arch) if smoke else get_config(arch)
    mesh = mesh or make_host_mesh(device)
    dev = mesh.device if mesh is not None else resolve_device(device)
    rules = MeshRules.for_mesh(mesh)
    shape = ShapeConfig("custom", "train", seq_len, global_batch)
    opt_cfg = AdamWConfig(lr_peak=lr, warmup_steps=max(2, steps // 20),
                          total_steps=steps)

    model = build_params(cfg, seed=seed, device=dev, mesh=mesh)
    opt_state = adamw_init(param_leaves(model), opt_cfg)
    pspecs = state_pspecs(model)
    data = SyntheticLM(cfg, shape, seed=seed)
    step_fn = make_train_step(cfg, rules, opt_cfg, device=dev)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if mgr is not None and mgr.latest_step() is not None:
        start_step, state = mgr.restore(device=dev, mesh=mesh,
                                        pspecs=pspecs)
        load_params(model, state["params"])
        opt_state = opt_state_from_reference(state["opt"], model, dev)
        del state
        print(f"[train] resumed from step {start_step}", flush=True)

    wd = StepWatchdog(tolerance=3.0, timer=timer)
    losses = []
    step = start_step
    for step in range(start_step, steps):
        wd.start(step)
        batch = data.sharded_batch(step, mesh, rules) \
            if mesh is not None else data.device_batch(step, dev)
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        loss = float(metrics["loss"])
        dt = wd.stop()
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step={step} loss={loss:.4f} dt={dt:.3f}s",
                  flush=True)
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, train_state(model, opt_state), pspecs,
                     mesh=mesh)
        if stop_after is not None and step + 1 - start_step >= stop_after:
            print(f"[train] stopping early at step {step + 1} "
                  "(simulated preemption)", flush=True)
            break
    if wd.flagged:
        print(f"[train] straggler steps flagged: {wd.flagged}", flush=True)
    if mgr is not None:
        mgr.save(min(step + 1, steps), train_state(model, opt_state),
                 pspecs, mesh=mesh)
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "straggler_flags": list(wd.flagged)}


def _train_rank(shape, kwargs: dict) -> None:
    import torch.distributed as dist
    out = train(mesh=make_lm_mesh(shape, kwargs.get("device")), **kwargs)
    if dist.get_rank() == 0:
        print(f"[train] done: final_loss={out['final_loss']:.4f}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="qwen3-8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", type=str, default=None,
                    help="default: the current CUDA device")
    ap.add_argument("--mesh", type=parse_mesh, default=None,
                    help="DATAxMODEL: spawn that many ranks (NCCL, or gloo "
                    "with --device cpu) on that mesh")
    args = ap.parse_args()
    kwargs = dict(arch=args.arch, steps=args.steps, seq_len=args.seq_len,
                  global_batch=args.global_batch, smoke=args.smoke,
                  ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                  lr=args.lr, device=args.device)
    if args.mesh is not None:
        spawn(_train_rank, args.mesh[0] * args.mesh[1], args.device,
              args.mesh, kwargs)
        return
    out = train(**kwargs)
    print(f"[train] done: final_loss={out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
