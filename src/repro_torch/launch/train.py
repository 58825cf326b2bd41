"""Training launcher of the port (the twin of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
      --steps 4 --batch 8 --seq 512 --grad-accum 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
      --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir CKPT --device cpu

Grad-accum AdamW train step (``runtime.train.make_train_step``) with a
warm-up cosine schedule, the deterministic sharded data pipeline, async
atomic checkpoints with restart (``--resume``), and the gradient
compression option.  Every family trains: ``TransformerLM`` archs
(dense or MoE FFN, the loss with its load-balancing term; a frontend
arch trains on ``frontends.synth_embeddings`` drawn at seed ``step``, as
the JAX launcher feeds it), ``RWKV6LM`` (rwkv6-3b: the wkv scan through
its forward kernel's states variant and its backward kernel) and
``Zamba2LM`` (zamba2-1.2b: the shared block's attention through the
flash-attention kernels, the SSD scan by autograd); attention runs
through the flash-attention kernels and their backward.  Each layer is
recomputed in the backward pass (``remat="full"``) unless ``--reduced``,
as in the reference; ``build(args, cfg=...)`` takes a depth cut at full
width.  Runs on ``cuda`` unless ``--device cpu`` is given; without a
card it raises rather than run on the CPU.  Weights are random, drawn
from a seeded ``torch.Generator`` on the device.
"""
from __future__ import annotations

import argparse
import time
from types import SimpleNamespace

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import get_arch
from repro_torch.data import ShardedLoader
from repro_torch.device import resolve_device
from repro_torch.models.api import get_model
from repro_torch.models.frontends import synth_embeddings
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.optim import compression as comp
from repro_torch.runtime.train import make_train_step

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def to_device(batch, device):
    """A loader batch (numpy int32) as int64 tensors on ``device``."""
    return {k: torch.from_numpy(v).long().to(device)
            for k, v in batch.items()}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args: argparse.Namespace, cfg=None) -> SimpleNamespace:
    """What :func:`main` trains with: the model, seeded random params and
    AdamW state (restored from ``--ckpt-dir`` with ``--resume``), the
    warm-up cosine schedule, the train step and the compression
    residuals.  ``cfg`` stands in for ``--arch``'s config where the flags
    cannot express it (a depth cut at full width).  Returns a namespace
    of cfg, device, model, params, opt_state, step (the train step),
    residuals, step0 and mgr."""
    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_arch(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    model = get_model(cfg, compute_dtype=DTYPES[args.dtype],
                      remat="none" if args.reduced else "full")
    sched = warmup_cosine(args.lr, max(args.steps // 10, 1), args.steps)
    init_fn, upd_fn = adamw(lr=sched)

    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    opt_state = init_fn(params)
    step0 = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        if args.resume and mgr.latest_step() is not None:
            state = mgr.restore({"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            step0 = mgr.latest_step()
            print(f"resumed from step {step0}")

    tstep = make_train_step(model, upd_fn, grad_accum=args.grad_accum,
                            compression=args.compression)
    residuals = (comp.init_residuals(params)
                 if args.compression != "none" else None)
    return SimpleNamespace(cfg=cfg, device=device, model=model,
                           params=params, opt_state=opt_state, step=tstep,
                           residuals=residuals, step0=step0, mgr=mgr)


def main(argv=None):
    args = parse_args(argv)
    run = build(args)
    params, opt_state, residuals = run.params, run.opt_state, run.residuals
    mgr = run.mgr
    loader = ShardedLoader(global_batch=args.batch, seq_len=args.seq,
                           vocab=run.cfg.vocab_size, n_shards=1, shard=0)
    losses = []
    t0 = time.time()
    try:
        for step in range(run.step0, args.steps):
            batch = to_device(next(loader), run.device)
            if run.model.uses_embeds():
                batch = {"embeds": synth_embeddings(
                    run.cfg, args.batch, args.seq,
                    torch.Generator(device=run.device).manual_seed(step),
                    device=run.device), "labels": batch["labels"]}
            if args.compression != "none":
                params, opt_state, residuals, metrics = run.step(
                    params, opt_state, residuals, batch)
            else:
                params, opt_state, metrics = run.step(params, opt_state,
                                                      batch)
            losses.append(float(metrics["loss"]))
            if step % args.log_every == 0 or step == args.steps - 1:
                dt = time.time() - t0
                print(f"step {step:5d} loss {losses[-1]:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({dt / max(len(losses), 1):.2f}s/step)", flush=True)
            if mgr and (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, {"params": params, "opt": opt_state},
                         blocking=False)
        if mgr:
            mgr.save(args.steps, {"params": params, "opt": opt_state})
            mgr.wait()
    finally:
        loader.close()
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
