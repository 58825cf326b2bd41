"""Serving launcher of the port: the dense, the paged and the pool path
on one device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
      --requests 4 --prompt-len 16 --gen 32 [--reduced --device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
      --paged --requests 4 --prompt-len 16 --gen 32 [--horizon 8] \
      [--speculative] [--temperature 0.8 --top-p 0.9] \
      [--prefill-chunk 256] [--page-dtype int8|fp8] [--reduced --device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
      --pool --nodes 4 --requests 8 --prompt-len 16 --gen 32 [--horizon 8] \
      [--speculative] [--temperature 0.8 --top-p 0.9] [--prefill-chunk 256]

Without ``--paged`` (the default path): one prefill of all prompts, the
KV cache of a transformer or of Zamba2's shared block padded to
``prompt_len + gen``, then ``gen`` decode steps (``make_serving_fns``);
transformer (dense or MoE FFN, never dropping a token, as the JAX
launcher builds it), RWKV6 and Zamba2 archs.
Tokens are greedy, or with ``--temperature > 0`` drawn from the
temperature/top-p distribution with the Gumbel noise of
``fold_in(key(0), step)`` over the whole [batch, vocab] row block, as
the JAX launcher draws them.  ``--paged`` serves a transformer from the
paged KV store (transformer archs only, as in the JAX launcher);
``--speculative`` (needs ``--horizon >= 2``) runs
draft-verify passes and prints the speculation telemetry.  ``--pool``
serves a transformer from a ``PoolServer`` of ``--nodes`` DockerSSD
nodes emulated on the one card (``--hbm-pages`` window pages each;
``--nodes 0``, the default, is one node per visible card), fronted by a
``StoragePool`` whose admission, placement and free messages ride
Ether-oN frames and a ``PoolRouter`` (least-loaded placement, per-node
admission, failover requeue); it prints the per-node and aggregate tier
stats and the control plane's cost terms.  Runs on ``cuda`` unless
``--device cpu`` is given; without a card it raises rather than run on
the CPU.  Weights are random, drawn from a seeded ``torch.Generator``
on the device; prompts come from a seeded numpy generator.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import get_arch
from repro_torch.core import analytical as A
from repro_torch.core.storage_pool import StoragePool
from repro_torch.device import resolve_device
from repro_torch.models.api import get_model
from repro_torch.runtime.pool import PoolServer
from repro_torch.runtime.prng import fold_in, gumbel, prng_key
from repro_torch.runtime.scheduler import PoolRouter, Request
from repro_torch.runtime.serve import (PagedServer, SamplingConfig,
                                       make_serving_fns, sampling_log_probs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--pool", action="store_true",
                    help="pool serving: a PoolServer of --nodes DockerSSD "
                         "nodes emulated on the card, behind a "
                         "StoragePool frontend and a PoolRouter")
    ap.add_argument("--nodes", type=int, default=0,
                    help="pool size (--pool); 0 = one node per visible "
                         "card")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--hbm-pages", type=int, default=32,
                    help="pages in the device window (per node with "
                         "--pool)")
    ap.add_argument("--page-dtype", choices=["fp32", "int8", "fp8"],
                    default="fp32",
                    help="KV page format: int8/fp8 store codes + per-slot "
                         "f32 scales and decode through the fused-dequant "
                         "kernel")
    ap.add_argument("--horizon", type=int, default=1,
                    help="tokens generated per host interaction "
                         "(1 = per-token scheduling)")
    ap.add_argument("--speculative", action="store_true",
                    help="draft-verify decoding (--paged, --horizon >= 2): "
                         "an n-gram drafter proposes up to horizon-1 "
                         "tokens, one pass verifies them; tokens equal the "
                         "plain path's")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax); the "
                         "draws are seeded and made on the device")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (with --temperature > 0)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prompt tokens per prefill chunk (0 = one chunk)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.speculative and not (args.paged or args.pool):
        raise SystemExit("--speculative needs --paged or --pool")
    if args.speculative and args.horizon < 2:
        raise SystemExit("--speculative needs --horizon >= 2 (the draft "
                         "rides the fused-horizon step)")
    sampling = (SamplingConfig(temperature=args.temperature,
                               top_p=args.top_p)
                if args.temperature > 0 else None)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = get_model(cfg, moe_no_drop=True)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen, device=device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.requests, args.prompt_len), dtype=np.int32)

    t0 = time.monotonic()
    if args.pool:
        return _serve_pool(args, model, params, prompts, device, sampling,
                           t0)
    if not args.paged:
        out = _serve_dense(model, params, prompts, args.gen, device,
                           sampling)
        toks = args.requests * args.gen
        dt = time.monotonic() - t0
        print(f"served {args.requests} requests, {toks} tokens on {device} "
              f"in {dt:.2f}s ({toks / dt:.1f} tok/s)")
        return out
    if cfg.block_type != "transformer":
        raise SystemExit("--paged demo path supports transformer archs")
    server = PagedServer(model, params, page_size=args.page_size,
                         hbm_pages=args.hbm_pages,
                         page_dtype=args.page_dtype, device=device)
    for i in range(args.requests):
        server.add_request(i, prompts[i], chunk=args.prefill_chunk or None)
    out = server.decode(args.gen,
                        horizon=args.horizon if args.horizon > 1 else None,
                        sampling=sampling, speculative=args.speculative)
    toks = sum(len(v) for v in out.values())
    dt = time.monotonic() - t0
    if args.speculative:
        st = server.speculation_stats()
        print(f"speculation: alpha={st['alpha']:.2f} "
              f"passes={st['passes']} (fallback {st['fallback_passes']}) "
              f"accepted-length hist {st['accepted_len_hist']}")
    print("tier stats:", server.tier_stats())
    print(f"prefix hit rate: {server.prefix_hit_rate():.2f}")
    print(f"served {args.requests} requests, {toks} tokens on {device} "
          f"in {dt:.2f}s ({toks / dt:.1f} tok/s)")
    return out


def _serve_pool(args, model, params, prompts, device, sampling, t0):
    """The pool path: PoolServer + StoragePool frontend + PoolRouter.
    Returns {request: generated tokens}."""
    if model.cfg.block_type != "transformer":
        raise SystemExit("--pool demo path supports transformer archs")
    server = PoolServer(model, params, n_nodes=args.nodes or None,
                        page_size=args.page_size,
                        hbm_pages_per_node=args.hbm_pages,
                        page_dtype=args.page_dtype, device=device)
    n = server.n_nodes
    pool = StoragePool(n, extent_cfg={"device": device})
    pool.attach_server(server)
    router = PoolRouter(server, pool, max_active=args.requests,
                        horizon=args.horizon, speculative=args.speculative,
                        sampling=sampling,
                        prefill_chunk=args.prefill_chunk or None)
    for i in range(args.requests):
        router.submit(Request(rid=i, prompt=prompts[i], max_tokens=args.gen))
    stats = router.run_to_completion()
    out = {r.rid: r.output for r in router.finished}
    toks = sum(len(v) for v in out.values())
    dt = time.monotonic() - t0
    print(f"pool of {n} nodes on {device} | per-node tier stats: "
          f"{server.node_tier_stats()}")
    print("aggregate tier stats:", stats["tier"])
    print("control plane:", A.control_plane_terms(pool.driver.stats, toks))
    print(f"served {len(out)} requests, {toks} tokens on {device} "
          f"in {dt:.2f}s ({toks / dt:.1f} tok/s)")
    return out


def dense_pick(logits, sampling, key, step: int):
    """The dense path's token selection for decode step ``step`` (0: the
    token after prefill): argmax, or with ``sampling`` of temperature > 0
    argmax of ``sampling_log_probs + gumbel(fold_in(key, step))`` over
    the whole [B, V] block.  logits [B, V]; returns [B] int64."""
    if sampling is None or sampling.greedy:
        return logits.argmax(-1)
    lp = sampling_log_probs(logits, sampling.temperature, sampling.top_p)
    return (lp + gumbel(fold_in(key, step), lp.shape)).argmax(-1)


def _serve_dense(model, params, prompts, gen, device, sampling=None):
    """Prefill, grow a KV cache (a transformer's, Zamba2's shared
    block's) to ``prompt_len + gen``,
    then ``gen`` decode steps, tokens picked by :func:`dense_pick`.
    Returns {request: gen tokens}."""
    prefill, decode = make_serving_fns(model)
    logits, cache = prefill(
        params, {"tokens": torch.from_numpy(prompts).long().to(device)})
    if "k" in cache:
        pad = prompts.shape[1] + gen - cache["k"].shape[-2]
        cache["k"] = F.pad(cache["k"], (0, 0, 0, pad))
        cache["v"] = F.pad(cache["v"], (0, 0, 0, pad))
    key = None if sampling is None else prng_key(sampling.seed, device)
    cur = dense_pick(logits, sampling, key, 0)
    picks = []
    for step in range(gen):
        picks.append(cur)
        logits, cache = decode(params, cache, cur)
        cur = dense_pick(logits, sampling, key, step + 1)
    tokens = torch.stack(picks, dim=1).tolist()
    return dict(enumerate(tokens))


if __name__ == "__main__":
    main()
