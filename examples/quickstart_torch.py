"""Quickstart of the PyTorch/CUDA port: train a ~10M-param dense LM for a
few hundred steps (the twin of ``examples/quickstart.py``).

  python examples/quickstart_torch.py [--steps 300] [--device cpu]

Uses the port's training stack: ArchConfig, AdamW + cosine schedule,
grad accumulation, the deterministic sharded data pipeline (learnable
synthetic stream, so the loss visibly falls), async atomic checkpoints.
Runs on ``cuda`` unless ``--device cpu`` is given; attention runs through
the flash-attention kernels and their backward on the card.
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.data import ShardedLoader  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.train import to_device  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.optim import adamw, warmup_cosine  # noqa: E402
from repro_torch.runtime.train import make_train_step  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=str(ROOT / "build" / "quickstart_torch"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    # a granite-family config at reduced width and depth
    cfg = dataclasses.replace(
        get_arch("granite-3-2b"),
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024,
        vocab_size=8192)
    model = get_model(cfg, compute_dtype=torch.float32, remat="none")

    sched = warmup_cosine(1e-3, 20, args.steps)
    init_fn, upd_fn = adamw(lr=sched)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    n_params = model.param_count(params)
    print(f"model: granite-family {n_params/1e6:.1f}M params "
          f"({cfg.n_layers}L d={cfg.d_model}) on {device}")
    opt = init_fn(params)
    tstep = make_train_step(model, upd_fn, grad_accum=2)

    loader = ShardedLoader(global_batch=16, seq_len=128,
                           vocab=cfg.vocab_size, n_shards=1, shard=0,
                           kind="learnable")
    mgr = CheckpointManager(args.ckpt, keep=2)
    t0 = time.time()
    first = loss = None
    try:
        for step in range(args.steps):
            batch = to_device(next(loader), device)
            params, opt, metrics = tstep(params, opt, batch)
            loss = float(metrics["loss"])
            first = first if first is not None else loss
            if step % 20 == 0 or step == args.steps - 1:
                print(f"step {step:4d}  loss {loss:.4f}  "
                      f"({(time.time()-t0)/(step+1):.2f}s/step)", flush=True)
            if (step + 1) % 100 == 0:
                mgr.save(step + 1, {"params": params, "opt": opt},
                         blocking=False)
        mgr.save(args.steps, {"params": params, "opt": opt})
        mgr.wait()
    finally:
        loader.close()
    print(f"\nloss {first:.3f} -> {loss:.3f}; checkpoints at {args.ckpt} "
          f"(steps {mgr.steps()})")
    if not loss < first:
        raise SystemExit("training did not learn")
    return first, loss


if __name__ == "__main__":
    main()
