"""Where a decode step's time goes when pool ranks share one card.

    python scripts/pool_rank_profile.py [--ranks 1 4] [--steps 4]

At the smoke's ``serve_ranks`` size (full-width granite-3-2b, seed 0;
8 prompts of 512 tokens, prefill chunks of 256, pages of 16, the 320-page
store split over the nodes), for each rank count: ranks spawned on the
one card over gloo (``launch.mesh.run_ranks``), every prompt admitted,
two decode steps to warm up, then ``--steps`` per-token decode steps
timed on each rank, split three ways:

  enqueue     host time outside the two below: the step's Python and
              kernel launches
  own_device  ``torch.cuda.synchronize()`` just before each
              ``all_reduce``: the device work this rank queued and had
              not finished (it waits behind the other ranks' kernels,
              since they share the card)
  collective  the ``all_reduce`` calls themselves: gloo's copies
              through the host, the exchange, and waiting for the
              slowest peer

and one more step under ``torch.profiler``: the device time of this
rank's kernels (all, GEMM, paged attention), the card's share of the
step.  The synchronize before each collective adds itself to the step,
so ``step_ms`` here is not the smoke's ``ms_a_token``.  Prints one JSON
line a rank count, then the card's name and power limit.  Card only.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

PROMPTS, PROMPT_LEN, PAGE, STORE_PAGES, CHUNK = 8, 512, 16, 320, 256


def _profile_rank(n: int, steps: int) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from pool_sessions import session_weights
    from repro_torch.configs.base import get_arch
    from repro_torch.runtime.pool import PoolServer
    from repro_torch.runtime.sharding import pool_mesh

    device = torch.device("cuda", torch.cuda.current_device())
    cfg = get_arch("granite-3-2b")
    model, params = session_weights(
        {"cfg": dataclasses.asdict(cfg), "seed": 0}, device)
    srv = PoolServer(model, params, mesh=pool_mesh(n, device_type="cuda"),
                     page_size=PAGE, hbm_pages_per_node=STORE_PAGES // n,
                     device=device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (PROMPTS, PROMPT_LEN), dtype=np.int32)
    for i, p in enumerate(prompts):
        srv.add_request(i, p, chunk=CHUNK)
    srv.decode(2)

    spent = {"own_device": 0.0, "collective": 0.0, "calls": 0}
    inner = dist.all_reduce

    def timed(t, *a, **kw):
        t0 = time.perf_counter()
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        out = inner(t, *a, **kw)
        t2 = time.perf_counter()
        spent["own_device"] += t1 - t0
        spent["collective"] += t2 - t1
        spent["calls"] += 1
        return out

    dist.all_reduce = timed
    try:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        srv.decode(steps)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    finally:
        dist.all_reduce = inner
    dev = {"all": 0.0, "gemm": 0.0, "paged": 0.0}
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            srv.decode(1)
            torch.cuda.synchronize(device)
            prof_wall = time.perf_counter() - t1
        events = prof.key_averages()
    except Exception as exc:       # the timed split stands without it
        events, prof_wall, dev["error"] = [], float("nan"), repr(exc)
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0))
        dev["all"] += us
        name = e.key.lower()
        if "gemm" in name or "xmma" in name or "cutlass" in name:
            dev["gemm"] += us
        if "paged" in name:
            dev["paged"] += us
    step = 1e3 * wall / steps
    own = 1e3 * spent["own_device"] / steps
    coll = 1e3 * spent["collective"] / steps
    return {"node": srv.node, "step_ms": step, "enqueue_ms": step - own - coll,
            "own_device_ms": own, "collective_ms": coll,
            "all_reduce_a_step": spent["calls"] / steps,
            "profiled_step_ms": 1e3 * prof_wall,
            "device_ms": {k: v / 1e3 if isinstance(v, float) else v
                          for k, v in dev.items()}}


def main(argv=None) -> int:
    import torch

    from repro_torch.launch.mesh import pick_backend, run_ranks

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pool_rank_profile: needs a card", file=sys.stderr)
        return 1
    for n in args.ranks:
        t0 = time.monotonic()
        got = run_ranks(_profile_rank, n, (n, args.steps),
                        device_type="cuda", timeout_s=600)
        print(json.dumps({"ranks": n, "backend": pick_backend("cuda", n),
                          "steps": args.steps, "per_rank": got,
                          "seconds": time.monotonic() - t0,
                          "note": "ranks share one card; gloo stages each "
                                  "collective through the host"}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
