"""In-storage analytics and retrieval launcher of the port.

  PYTHONPATH=src python -m repro_torch.launch.isp [--rows 500 --cols 32
      --page-rows 64 --page-dtype fp32|int8|fp8] [--corpus-rows 256
      --emb-dim 32 --k 4] [--arch granite-3-2b --reduced] [--device cpu]

The CLI twin of ``examples/isp_containers.py`` steps 1-5 on the port,
plus a RAG step:

  1. ``docker pull`` of the generic analytics image onto every node of a
     4-node ``StoragePool`` over Ether-oN;
  2. the host drops a table into a node's sharable namespace and the
     node ingests it into ``ExtentStore`` pages through λFS;
  3. an ``AnalyticsJob`` through the docker-cli front door
     (``handle_http``), checked bit for bit against the host fold;
  4. the ``OffloadPlanner`` prices, batches and runs a job per table on
     the device (JOB frames) and on the host (fetch + fold), and the two
     blocks must be bit-identical;
  5. the DLRM ``dlrm-embed`` container (``embed_agg``) on the same pool;
  6. RAG: a corpus embedding extent on a 1-node pool, in-storage top-k
     per query, one ``embed_gather`` of the retrieved token blocks, and
     the prompts admitted to a ``PagedServer`` (random weights from a
     seeded generator), two waves so the second rides the prefix cache.

Runs on ``cuda`` unless ``--device cpu`` is given; without a card it
raises rather than run on the CPU.  Data comes from a seeded numpy
generator.  Prints the aggregates, the planner's verdicts and the
Ether-oN counters, and returns them as a dict.
"""
from __future__ import annotations

import argparse
import json
import time
import urllib.parse

import numpy as np
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.container import (ImageManifest, from_jsonable,
                                        make_blob, register_app)
from repro_torch.core.extent_store import AnalyticsJob, analytics_blob
from repro_torch.core.lambda_fs import SHARABLE_NS
from repro_torch.core.storage_pool import StoragePool
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.api import get_model
from repro_torch.runtime.offload import OffloadPlanner
from repro_torch.runtime.retrieval import RetrievalFrontend
from repro_torch.runtime.serve import PagedServer

EMBED_DIM, EMBED_LOOKUPS = 64, 16


@register_app("dlrm-embed")
def dlrm_embed(ctx, table_path="/data/table.npy", idx_path="/data/idx.npy"):
    """The paper's 'embed' workload: sparse-feature lookup + sum-pool,
    executed near the data (kernel: ``kernels.embed_agg``) on the
    device of the node's extent store."""
    ctx.log("binding inputs from the sharable namespace")
    ctx.bind(table_path)
    ctx.bind(idx_path)
    table = np.frombuffer(ctx.fs.read(table_path, SHARABLE_NS),
                          np.float32).reshape(-1, EMBED_DIM)
    idx = np.frombuffer(ctx.fs.read(idx_path, SHARABLE_NS),
                        np.int32).reshape(-1, EMBED_LOOKUPS)
    ctx.syscall("openat", table_path, "sharable")
    ctx.alloc(table.nbytes + idx.nbytes)
    dev = ctx.extents.device
    pooled = ops.embed_agg(torch.from_numpy(table.copy()).to(dev),
                           torch.from_numpy(idx.copy()).to(dev))
    ctx.release(table_path)
    ctx.release(idx_path)
    ctx.log(f"pooled {idx.shape[0]} bags of {idx.shape[1]} lookups")
    return pooled.cpu().numpy()


def _host_fold(data, threshold, *, page_rows, n_cols, **kw):
    """The host fold at store width (narrow extents are zero-padded)."""
    data = np.pad(data, ((0, 0), (0, n_cols - data.shape[1])))
    return ops.scan_filter_reduce_host(torch.from_numpy(data), threshold,
                                       page_rows=page_rows, **kw).numpy()


def analytics(args, device, rng):
    """Steps 1-5 on a 4-node pool; returns what they printed."""
    cfg = {"n_pages": 2 * -(-args.rows // args.page_rows) + 2,
           "page_rows": args.page_rows, "n_cols": args.cols,
           "page_dtype": args.page_dtype, "device": device}
    pool = StoragePool(4, extent_cfg=cfg)
    pool.broadcast_pull("isp-analytics", analytics_blob())
    print(f"pool: {len(pool.nodes)} DockerSSDs, 'isp-analytics' pulled; "
          f"extent pages {args.page_dtype} on {device}")

    tables = {}
    for i, ip in enumerate(pool.alive_nodes()[:2]):
        node = pool.nodes[ip]
        data = rng.normal(size=(args.rows, args.cols)).astype(np.float32)
        node.fs.write("/data/tbl.bin", data.tobytes(), SHARABLE_NS,
                      actor="host")
        shape = node.ingest_extent(f"tbl{i}", "/data/tbl.bin", args.cols)
        tables[f"tbl{i}"] = (ip, data)
        print(f"  {ip}: ingested extent tbl{i} {shape}")

    # the front door: create + start?job=... over the docker-cli dialect
    ip, data = tables["tbl0"]
    node = pool.nodes[ip]
    job = AnalyticsJob(extent="tbl0", filter_col=3, filter_op="ge",
                       threshold=0.0, reduce="count")
    cid = json.loads(node.docker.handle_http(
        "POST /containers/create?image=isp-analytics"))["Id"]
    q = urllib.parse.quote(json.dumps([job.to_dict()]))
    resp = from_jsonable(json.loads(node.docker.handle_http(
        f"POST /containers/{cid}/start?job={q}")))
    block = resp["result"][0]
    want = _host_fold(node.extents.get("tbl0"), 0.0,
                      page_rows=args.page_rows, n_cols=args.cols,
                      filter_col=3, filter_op="ge")
    if not np.array_equal(block, want):
        raise RuntimeError("front door block != host fold")
    print(f"front door: count(col3 >= 0) = {block[0, 0]:.0f} of "
          f"{args.rows} rows (bit-identical to the host fold)")

    planner = OffloadPlanner(pool)
    jobs = [AnalyticsJob(extent=name, filter_col=1, filter_op="lt",
                         threshold=0.5, reduce="sum", reduce_col=2,
                         job_id=i) for i, name in enumerate(tables)]
    recs = planner.execute(jobs)
    dev_recs = planner.execute(jobs, force="device")
    host_recs = planner.execute(jobs, force="host")
    verdicts = []
    for rec, d, h in zip(recs, dev_recs, host_recs):
        if not np.array_equal(d["block"], h["block"]):
            raise RuntimeError(f"job {rec['job'].job_id}: device block != "
                               f"host block")
        est = rec["est"]
        verdicts.append({"job": rec["job"].job_id, "node": est.node_ip,
                         "where": rec["where"], "host_ms": est.host_s * 1e3,
                         "dvirtfw_ms": est.dvirtfw_s * 1e3,
                         "result": rec["result"]})
        print(f"  job {rec['job'].job_id} on {est.node_ip}: -> "
              f"{rec['where']} (modeled host {est.host_s * 1e3:.3f} ms vs "
              f"d-virtfw {est.dvirtfw_s * 1e3:.3f} ms), "
              f"sum[col2|col1<0.5] = {rec['result']:.4f}; device == host")

    blob = make_blob(ImageManifest("dlrm-embed", "dlrm-embed",
                                   ["rootfs-layer0"]),
                     {"rootfs-layer0": b"binaries+runtime"})
    pool.broadcast_pull("dlrm-embed", blob)
    ip = pool.alive_nodes()[2]
    node = pool.nodes[ip]
    table = rng.normal(size=(512, EMBED_DIM)).astype(np.float32)
    idx = rng.integers(0, 512, (32, EMBED_LOOKUPS), dtype=np.int32)
    node.fs.write("/data/table.npy", table.tobytes(), SHARABLE_NS,
                  actor="host")
    node.fs.write("/data/idx.npy", idx.tobytes(), SHARABLE_NS, actor="host")
    _, pooled = node.docker.cmd_run("dlrm-embed")
    print(f"dlrm-embed on {ip}: pooled shape {pooled.shape}")
    stats = dict(vars(pool.driver.stats))
    print(f"Ether-oN: {stats['tx_commands']} tx cmds, "
          f"{stats['rx_completions']} upcalls, {stats['job_frames']} job "
          f"frames, {stats['extent_reads']} extent reads, "
          f"{stats['bytes_tx'] + stats['bytes_rx']} wire bytes")
    return {"front_door_count": float(block[0, 0]), "planner": verdicts,
            "dlrm_shape": list(pooled.shape), "etheron": stats}


def rag(args, device, rng):
    """Step 6: retrieval feeding a PagedServer; returns what it printed."""
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = get_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    chunk_tok, n_q, tail = 16, 4, 8
    corpus = rng.integers(0, cfg.vocab_size, (args.corpus_rows, chunk_tok),
                          dtype=np.int32)
    emb = rng.normal(size=(args.corpus_rows, args.emb_dim)).astype(
        np.float32)
    template = rng.integers(0, cfg.vocab_size, 32, dtype=np.int32)
    pool = StoragePool(1, extent_cfg={
        "n_pages": -(-args.corpus_rows // args.page_rows) + 1,
        "page_rows": args.page_rows, "n_cols": args.emb_dim,
        "device": device})
    pool.broadcast_pull("isp-analytics", analytics_blob())
    server = PagedServer(model, params, page_size=16, hbm_pages=64,
                         device=device)
    fe = RetrievalFrontend(pool, server, corpus_tokens=corpus,
                           template=template, k=args.k)
    fe.ingest(emb)
    query = rng.normal(size=(args.emb_dim,)).astype(np.float32)
    waves = []
    for w in range(2):
        tails = [rng.integers(0, cfg.vocab_size, tail, dtype=np.int32)
                 for _ in range(n_q)]
        t0 = time.monotonic()
        prompts, hits = fe.build_prompts([query] * n_q, tails,
                                         force="device")
        for i, p in enumerate(prompts):
            server.add_request(100 * w + i, p)
        waves.append({"admit_s": time.monotonic() - t0,
                      "prefix_hits": server.tier_stats()["prefix_hits"]})
    out = server.decode(4)
    print(f"RAG: top-{args.k} in storage {hits[0]['ids']}, "
          f"{len(prompts)} prompts of {len(prompts[0])} tokens a wave; "
          f"prefix hits after each wave {[w['prefix_hits'] for w in waves]};"
          f" retrieval placement {fe.stats}")
    return {"ids": hits[0]["ids"], "prompt_len": len(prompts[0]),
            "waves": waves, "where": fe.stats, "tokens": out}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=500)
    ap.add_argument("--cols", type=int, default=32)
    ap.add_argument("--page-rows", type=int, default=64)
    ap.add_argument("--page-dtype", choices=["fp32", "int8", "fp8"],
                    default="fp32")
    ap.add_argument("--corpus-rows", type=int, default=256)
    ap.add_argument("--emb-dim", type=int, default=32)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    out = analytics(args, device, rng)
    out["rag"] = rag(args, device, rng)
    return out


if __name__ == "__main__":
    main()
