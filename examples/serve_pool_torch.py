"""Distributed LLM inference on the computing-enabled storage pool, on the
PyTorch/CUDA port (the twin of ``examples/serve_pool.py``): the paper's
case study (Fig 8b) at demo scale, on the pool path.

Requests flow through the whole stack: the ``StoragePool`` frontend
admits each one (an Ether-oN control frame carries the placement to the
chosen DockerSSD), the ``PoolRouter`` places least-loaded and runs
per-node admission control, and every generated token is one device step
spanning all nodes: each node's window is a slice of one page store, and
the pool form of the paged-attention kernels merges the nodes' partials
in one launch.  The scenarios:

  0. a 1-node pool against ``PagedServer``: the same logits and tokens;
  1. a node killed mid-decode: the router re-prefills its sequences on
     the survivors, and the outputs are those of the single-node path
     (``--fault-plan`` puts a seeded fault injector on the fabric too);
  2. one system prompt shared across the pool: prefix-aware placement
     routes the sharers to the node holding the template's pages, and
     the outputs equal a cold run's (``prefix_cache=False``);
  3. speculative decoding on repetitive prompts: token-identical to the
     plain fused horizon;
  then the full-scale verdict of the analytical model (Fig 12b).

  python examples/serve_pool_torch.py [--device cpu] [--fault-plan lossy]

Runs on ``cuda`` unless ``--device cpu`` is given.
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.core import analytical as A  # noqa: E402
from repro_torch.core.storage_pool import StoragePool  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.runtime.pool import PoolServer  # noqa: E402
from repro_torch.runtime.scheduler import PoolRouter, Request  # noqa: E402
from repro_torch.runtime.serve import PagedServer  # noqa: E402

N_NODES = 4


def _greedy(server, prompts, gen, **decode_kw):
    """Each prompt admitted (its first token the prefill's argmax), then
    ``gen`` more greedy tokens."""
    out = {i: [int(server.add_request(i, p).argmax())]
           for i, p in enumerate(prompts)}
    for i, toks in server.decode(gen, **decode_kw).items():
        out[i] += toks
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=N_NODES)
    ap.add_argument("--fault-plan", default="none",
                    help="seeded fabric fault plan for scenario 1: a "
                         "preset name (none/lossy/storm), inline JSON, "
                         "or a path to a plan file "
                         "(repro_torch.core.faults.load_plan)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n_nodes = args.nodes
    cfg = dataclasses.replace(
        get_arch("granite-3-2b"),
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=4, d_ff=256,
        vocab_size=512)
    model = get_model(cfg, compute_dtype=torch.float32)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    rng = np.random.default_rng(0)
    n_req, prompt_len, gen = 6, 24, 12
    prompts = [rng.integers(0, cfg.vocab_size, prompt_len, dtype=np.int32)
               for _ in range(n_req)]
    result = {}

    # --- scenario 0: one node of the pool is PagedServer ----------------
    ref = PagedServer(model, params, page_size=8, hbm_pages=64,
                      dtype=torch.float32, device=device)
    one = PoolServer(model, params, n_nodes=1, page_size=8,
                     hbm_pages_per_node=64, dtype=torch.float32,
                     device=device)
    first_equal = all(torch.equal(ref.add_request(i, p),
                                  one.add_request(i, p))
                      for i, p in enumerate(prompts))
    ref_out = {i: [t] for i, t in ref.pending_tokens().items()}
    for i, toks in ref.decode(gen - 1).items():
        ref_out[i] += toks
    one_out = {i: [t] for i, t in one.pending_tokens().items()}
    for i, toks in one.decode(gen - 1).items():
        one_out[i] += toks
    assert first_equal and one_out == ref_out, \
        "1-node pool diverged from PagedServer"
    print(f"1-node pool: prefill logits and {n_req} x {gen} tokens "
          f"identical to PagedServer")
    result["one_node_equal"] = True

    # --- scenario 1: the pool, a node killed mid-decode ------------------
    server = PoolServer(model, params, n_nodes=n_nodes, page_size=8,
                        hbm_pages_per_node=16, dtype=torch.float32,
                        device=device)
    pool = StoragePool(n_nodes, heartbeat_timeout=0.0,
                       extent_cfg={"device": device})
    pool.attach_server(server)
    if args.fault_plan != "none":
        from repro_torch.core.faults import load_plan
        pool.attach_faults(load_plan(args.fault_plan))
        print(f"fault injector armed: plan '{args.fault_plan}'")
    # horizon=4: four tokens per host interaction; the router admits,
    # evicts and polls heartbeats at horizon boundaries
    router = PoolRouter(server, pool, max_active=n_req, horizon=4)
    t0 = time.monotonic()
    for i, p in enumerate(prompts):
        router.submit(Request(rid=i, prompt=p, max_tokens=gen))
    router.step()
    router.step()
    victim = server.node_of(0)
    dead_ip = pool.serving_ips()[victim]
    pool.nodes[dead_ip].fail()
    print(f"killed node {victim} ({dead_ip}) mid-decode")
    router.run_to_completion()
    dt = time.monotonic() - t0
    by_id = {r.rid: r.output for r in router.finished}
    assert all(by_id[i][:len(ref_out[i])] == ref_out[i]
               for i in range(n_req)), "pool outputs diverged from 1-node"
    toks = sum(len(o) for o in by_id.values())
    print(f"served {n_req} requests x ({prompt_len} prompt + {gen} gen) "
          f"over {n_nodes} nodes in {dt:.1f}s: outputs identical to the "
          f"single-node path, {router.requeues} requeued after the failure")
    agg = server.tier_stats()
    print(f"aggregate tiered-KV telemetry: page_ins={agg['page_ins']} "
          f"page_outs={agg['page_outs']} hits={agg['hits']} "
          f"residency={agg['residency']:.2f}")
    for s, ns in enumerate(server.node_tier_stats()):
        mark = " (died)" if s not in server.alive_nodes() else ""
        print(f"  node {s}{mark}: hits={ns['hits']} "
              f"page_ins={ns['page_ins']} page_outs={ns['page_outs']}")
    ct = A.control_plane_terms(pool.driver.stats, toks)
    print(f"Ether-oN control plane: {ct['control_frames']:.0f} frames "
          f"({ct['frames_per_1k_tokens']:.1f}/1K tokens), "
          f"{ct['us_per_token']:.2f} us/token, off the decode hot path")
    if pool.fault_injector is not None:
        fs = pool.fault_injector.stats
        ds = pool.driver.stats
        print(f"chaos absorbed: {fs.dropped} dropped / {fs.corrupted} "
              f"corrupted / {fs.duplicated} duplicated / {fs.delayed} "
              f"delayed -> {ds.retransmits} retransmits, {ds.nacks} "
              f"NACKs, {ds.dup_frames} dups discarded; outputs still "
              f"identical")
    result.update(failover_equal=True, requeues=router.requeues,
                  victim=victim, control_plane=ct)

    # --- scenario 2: one system prompt shared across the pool ----------
    template = rng.integers(0, cfg.vocab_size, 18, dtype=np.int32)
    sp_prompts = [np.concatenate([template, rng.integers(
        0, cfg.vocab_size, 6, dtype=np.int32)]) for _ in range(n_req)]
    cold = PagedServer(model, params, page_size=8, hbm_pages=64,
                       dtype=torch.float32, prefix_cache=False,
                       device=device)
    cold_out = _greedy(cold, sp_prompts, gen)
    assert cold.prefill_tokens_computed == sum(map(len, sp_prompts))
    # one window holds the template and every sharer's private extent:
    # prefix-aware placement sends them all to the owning node
    warm_srv = PoolServer(model, params, n_nodes=n_nodes, page_size=8,
                          hbm_pages_per_node=32, dtype=torch.float32,
                          device=device)
    warm_pool = StoragePool(n_nodes, extent_cfg={"device": device})
    warm_pool.attach_server(warm_srv)
    warm_out = {}
    for i, p in enumerate(sp_prompts):
        node = warm_pool.place_sequence(i, len(p) + gen, prompt=p)
        warm_out[i] = [int(warm_srv.add_request(i, p, node=node,
                                                chunk=8).argmax())]
    for i, toks in warm_srv.decode(gen).items():
        warm_out[i] += toks
    assert warm_out == cold_out, \
        "shared-prefix pool outputs diverged from the cold run"
    owner = warm_srv.node_of(0)
    assert all(warm_srv.node_of(i) == owner for i in range(n_req)), \
        "prefix-aware placement scattered the template's sharers"
    hits = [ns["prefix_hits"] for ns in warm_srv.node_tier_stats()]
    assert hits[owner] > 0 and sum(hits) == hits[owner], \
        f"prefix hits off the owning node: {hits}"
    print(f"\nshared system prompt: {n_req} requests, one template, all "
          f"routed to owning node {owner} ({hits[owner]} page hits, "
          f"hit rate {warm_srv.prefix_hit_rate():.2f}; "
          f"{warm_srv.prefill_tokens_computed} prompt tokens computed "
          f"against the cold run's {cold.prefill_tokens_computed}), "
          f"outputs identical to the cold run")
    result.update(warm_equals_cold=True,
                  warm_tokens=warm_srv.prefill_tokens_computed,
                  cold_tokens=cold.prefill_tokens_computed)

    # --- scenario 3: speculative decoding on a repetitive stream -------
    spec_prompts = [np.asarray([c] * 24 + [t] * 16, np.int32)
                    for c, t in ((41, 49), (500, 259))]
    spec_srv = PoolServer(model, params, n_nodes=n_nodes, page_size=8,
                          hbm_pages_per_node=32, dtype=torch.float32,
                          device=device)
    spec_pool = StoragePool(n_nodes, extent_cfg={"device": device})
    spec_pool.attach_server(spec_srv)
    spec_gen = 24

    def spec_run(speculative):
        for s in list(spec_srv.sequence_ids()):
            spec_srv.free_sequence(s)
        out = {}
        for i, p in enumerate(spec_prompts):
            node = spec_pool.place_sequence(i, len(p) + spec_gen, prompt=p)
            out[i] = [int(spec_srv.add_request(i, p, node=node).argmax())]
        for i, toks in spec_srv.decode(spec_gen, horizon=8,
                                       speculative=speculative).items():
            out[i] += toks
        return out

    plain_out = spec_run(False)
    spec_srv.reset_speculation_stats()
    spec_out = spec_run(True)
    assert spec_out == plain_out, \
        "speculative pool outputs diverged from the plain horizon"
    st = spec_srv.speculation_stats()
    assert st["passes"] > 0 and st["drafted"] > 0, \
        "repetitive prompts produced no speculative passes"
    print(f"\nspeculative decode: alpha={st['alpha']:.2f} over "
          f"{st['passes']} draft-verify passes "
          f"(accepted-length hist {st['accepted_len_hist']}), outputs "
          f"identical to the plain fused horizon")
    result.update(spec_equal=True, spec_alpha=st["alpha"],
                  spec_passes=st["passes"])

    # what this buys at full scale (paper Fig 12b, the analytical model)
    r = A.headline_ratios(A.evaluate_pool())
    print(f"\nfull-scale verdict (analytical, 8 LLMs, seq 32K): "
          f"D-Cache beats H-Cache {r['d_cache_vs_h_cache']:.1f}x "
          f"(paper: 7.9x), H-NoCache {r['d_cache_vs_h_nocache']:.0f}x "
          f"(paper: 3.2Kx)")
    result["verdict"] = r
    return result


if __name__ == "__main__":
    main()
