"""Serving launcher of the port: the dense and the paged path on one
device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
      --requests 4 --prompt-len 16 --gen 32 [--reduced --device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
      --paged --requests 4 --prompt-len 16 --gen 32 [--horizon 8] \
      [--prefill-chunk 256] [--page-dtype int8|fp8] [--reduced --device cpu]

Without ``--paged`` (the default path): one prefill of all prompts, the
KV cache of a transformer padded to ``prompt_len + gen``, then ``gen``
greedy decode steps (``make_serving_fns``); transformer and RWKV6 archs.
``--paged`` serves a transformer from the paged KV store.  Runs on
``cuda`` unless ``--device cpu`` is given; without a card it raises
rather than run on the CPU.  Weights are random, drawn from a seeded
``torch.Generator`` on the device; prompts come from a seeded numpy
generator.  The pool path, speculation and sampling are not ported yet
and exit with a message.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import get_arch
from repro_torch.device import resolve_device
from repro_torch.models.api import get_model
from repro_torch.runtime.serve import PagedServer, make_serving_fns


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--pool", action="store_true")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--hbm-pages", type=int, default=32,
                    help="pages in the device window")
    ap.add_argument("--page-dtype", choices=["fp32", "int8", "fp8"],
                    default="fp32",
                    help="KV page format: int8/fp8 store codes + per-slot "
                         "f32 scales and decode through the fused-dequant "
                         "kernel")
    ap.add_argument("--horizon", type=int, default=1,
                    help="tokens generated per host interaction "
                         "(1 = per-token scheduling)")
    ap.add_argument("--speculative", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prompt tokens per prefill chunk (0 = one chunk)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.pool:
        raise SystemExit("--pool: not yet ported")
    if args.speculative:
        raise SystemExit("--speculative: not yet ported")
    if args.temperature > 0:
        raise SystemExit("--temperature > 0: not yet ported")

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen, device=device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.requests, args.prompt_len), dtype=np.int32)

    t0 = time.monotonic()
    if not args.paged:
        out = _serve_dense(model, params, prompts, args.gen, device)
        toks = args.requests * args.gen
        dt = time.monotonic() - t0
        print(f"served {args.requests} requests, {toks} tokens on {device} "
              f"in {dt:.2f}s ({toks / dt:.1f} tok/s)")
        return out
    if cfg.block_type != "transformer":
        raise SystemExit("--paged serves transformer archs")
    server = PagedServer(model, params, page_size=args.page_size,
                         hbm_pages=args.hbm_pages,
                         page_dtype=args.page_dtype, device=device)
    for i in range(args.requests):
        server.add_request(i, prompts[i], chunk=args.prefill_chunk or None)
    out = server.decode(args.gen,
                        horizon=args.horizon if args.horizon > 1 else None)
    toks = sum(len(v) for v in out.values())
    dt = time.monotonic() - t0
    print("tier stats:", server.tier_stats())
    print(f"prefix hit rate: {server.prefix_hit_rate():.2f}")
    print(f"served {args.requests} requests, {toks} tokens on {device} "
          f"in {dt:.2f}s ({toks / dt:.1f} tok/s)")
    return out


def _serve_dense(model, params, prompts, gen, device):
    """Prefill, grow a transformer's KV cache to ``prompt_len + gen``,
    then ``gen`` greedy decode steps.  Returns {request: gen tokens}."""
    prefill, decode = make_serving_fns(model)
    logits, cache = prefill(
        params, {"tokens": torch.from_numpy(prompts).long().to(device)})
    if "k" in cache:
        pad = prompts.shape[1] + gen - cache["k"].shape[-2]
        cache["k"] = F.pad(cache["k"], (0, 0, 0, pad))
        cache["v"] = F.pad(cache["v"], (0, 0, 0, pad))
    cur = logits.argmax(-1)
    picks = []
    for _ in range(gen):
        picks.append(cur)
        logits, cache = decode(params, cache, cur)
        cur = logits.argmax(-1)
    tokens = torch.stack(picks, dim=1).tolist()
    return dict(enumerate(tokens))


if __name__ == "__main__":
    main()
