"""Where an admission's time goes in ``examples/serve_rag_torch.py``.

    python scripts/rag_admission_probe.py [--rounds 12] [--example-runs 0]
        [--min-rows N]

The example's own setup (granite-3-2b cut to 2 layers of width 128,
vocab 512, seed 0; 16 documents, top-3, a 24-token template, 8-token
question tails, 4 requests a wave, pages of 8) on a prefix-cached server
and a cache-ablated one.  After two waves of each to warm up, ``--rounds``
rounds of one wave on each, the order alternating (cold first on even
rounds): every admission is timed in two parts, the retrieval
(``build_prompts``: the in-storage top-k and the gather) and the
admission (``add_request``: prefix match and prefill), each ended by a
``torch.cuda.synchronize``.  Then one wave of each under
``torch.profiler``: the device time of its admissions' kernels (the
retrievals included) and their launches; and one wave of each under
``cProfile``: the host functions with the most time of their own.
``--example-runs N`` then runs the example's own ``main`` N times and
counts the runs whose median warm wave beat the median cold one.
``--min-rows N`` sets ``PREFILL_MIN_ROWS_CUDA`` (the least rows of a
prefill chunk on a card) for the whole run.
Prints one JSON line (medians and every round's wave), then the card's
name and power limit.  Card only.
"""
from __future__ import annotations

import argparse
import cProfile
import dataclasses
import json
import pstats
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def example_runs(n: int) -> dict:
    """The example's ``main`` ``n`` times on the card: each run's
    (t_warm, t_cold) in ms (medians of its alternating waves), and in
    how many t_warm < t_cold."""
    import contextlib
    import importlib.util
    import io

    spec = importlib.util.spec_from_file_location(
        "serve_rag_torch", ROOT / "examples" / "serve_rag_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    runs = []
    for _ in range(n):
        try:
            with contextlib.redirect_stdout(io.StringIO()) as text:
                out = mod.main(["--device", "cuda"])
            runs.append([1e3 * out["t_warm"], 1e3 * out["t_cold"]])
        except AssertionError as exc:
            if "faster" not in str(exc):
                raise
            # the gate's own line: "admission wave ...: cold X ms ... |
            # warm Y ms ..."
            line = [x for x in text.getvalue().splitlines()
                    if x.startswith("admission wave")][-1]
            cold = float(line.split("cold ")[1].split(" ms")[0])
            warm = float(line.split("| warm ")[1].split(" ms")[0])
            runs.append([warm, cold])
    return {"example_runs": n,
            "warm_under_cold": sum(w < c for w, c in runs), "runs": runs}


def main(argv=None) -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_arch
    from repro_torch.core import StoragePool, analytics_blob
    from repro_torch.device import resolve_device
    from repro_torch.models.api import get_model
    from repro_torch.runtime.retrieval import RetrievalFrontend
    from repro_torch.runtime.serve import PagedServer

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--example-runs", type=int, default=0)
    ap.add_argument("--min-rows", type=int, default=None)
    args = ap.parse_args(argv)
    if args.min_rows is not None:
        import repro_torch.runtime.serve as serve_mod
        serve_mod.PREFILL_MIN_ROWS_CUDA = args.min_rows
    if not torch.cuda.is_available():
        print("rag_admission_probe: needs a card", file=sys.stderr)
        return 1
    device = resolve_device("cuda")
    cfg = dataclasses.replace(
        get_arch("granite-3-2b"), n_layers=2, d_model=128, n_heads=8,
        n_kv_heads=4, d_ff=256, vocab_size=512)
    model = get_model(cfg, compute_dtype=torch.float32)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    rng = np.random.default_rng(0)
    n_docs, d_emb, chunk_tok, k, n_req, tail, gen = 16, 32, 16, 3, 4, 8, 8
    template = rng.integers(0, cfg.vocab_size, 24, dtype=np.int32)
    corpus = rng.integers(0, cfg.vocab_size, (n_docs, chunk_tok),
                          dtype=np.int32)
    emb = rng.normal(size=(n_docs, d_emb)).astype(np.float32)
    pool = StoragePool(1, extent_cfg={"n_pages": n_docs // 4 + 2,
                                      "page_rows": 4, "n_cols": d_emb,
                                      "device": device})
    pool.broadcast_pull("isp-analytics", analytics_blob())
    fes = {}
    for name, cache in (("warm", True), ("cold", False)):
        server = PagedServer(model, params, page_size=8, hbm_pages=64,
                             dtype=torch.float32, prefix_cache=cache,
                             device=device)
        fes[name] = RetrievalFrontend(pool, server, corpus_tokens=corpus,
                                      template=template, k=k)
    fes["warm"].ingest(emb)
    query = rng.normal(size=(d_emb,)).astype(np.float32)

    def wave(fe):
        tails = [rng.integers(0, cfg.vocab_size, tail, dtype=np.int32)
                 for _ in range(n_req)]
        computed = fe.server.prefill_tokens_computed
        retrieve = admit = 0.0
        for i, qt in enumerate(tails):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            prompts, _ = fe.build_prompts([query], [qt], force="device")
            torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            fe.server.add_request(i, prompts[0])
            torch.cuda.synchronize(device)
            t2 = time.perf_counter()
            retrieve += t1 - t0
            admit += t2 - t1
        return {"retrieve_ms": 1e3 * retrieve, "admit_ms": 1e3 * admit,
                "wave_ms": 1e3 * (retrieve + admit),
                "tokens": fe.server.prefill_tokens_computed - computed}

    def finish(fe):
        fe.server.decode(gen)
        for i in range(n_req):
            fe.server.free_sequence(i)

    for name in ("cold", "warm", "warm", "cold"):          # warm-up
        wave(fes[name])
        finish(fes[name])
    rounds = []
    for r in range(args.rounds):
        order = ("cold", "warm") if r % 2 == 0 else ("warm", "cold")
        got = {}
        for name in order:
            got[name] = wave(fes[name])
            finish(fes[name])
        rounds.append(got)
    medians = {name: {key: statistics.median(x[name][key] for x in rounds)
                      for key in ("retrieve_ms", "admit_ms", "wave_ms")}
               for name in ("warm", "cold")}
    profiled = {}
    for name in ("warm", "cold"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wave(fes[name])
        finish(fes[name])
        rows = []
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            rows.append(((getattr(e, "self_device_time_total", None)
                          or getattr(e, "self_cuda_time_total", 0)),
                         e.count, e.key[:90]))
        rows.sort(reverse=True)
        profiled[name] = {
            "device_ms_admissions": sum(r[0] for r in rows) / 1e3,
            "device_ops": sum(r[1] for r in rows),
            "kernels": [{"kernel": k, "calls": n, "us": us}
                        for us, n, k in rows]}
    hosts = {}
    for name in ("warm", "cold"):           # where the host time goes
        prof = cProfile.Profile()
        prof.enable()
        wave(fes[name])
        prof.disable()
        finish(fes[name])
        stats = pstats.Stats(prof).stats
        top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:15]
        hosts[name] = [{"function": f"{Path(f).name}:{line}:{fn}",
                        "calls": v[1], "own_ms": 1e3 * v[2],
                        "with_callees_ms": 1e3 * v[3]}
                       for (f, line, fn), v in top]
    warm_faster = sum(x["warm"]["wave_ms"] < x["cold"]["wave_ms"]
                      for x in rounds)
    print(json.dumps({"rounds": args.rounds, "min_rows": args.min_rows,
                      "medians": medians,
                      "warm_faster_rounds": warm_faster,
                      "profiled": profiled, "host_top": hosts,
                      "every_round": rounds}),
          flush=True)
    if args.example_runs:
        print(json.dumps(example_runs(args.example_runs)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
