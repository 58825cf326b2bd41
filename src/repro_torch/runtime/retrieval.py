"""RetrievalFrontend — in-storage vector retrieval feeding serving.

The RAG loop the paper's disaggregation pitch implies, run end to end
on the node fabric:

  1. corpus embeddings live as an :class:`~repro_torch.core.extent_store.
     ExtentStore` extent on a DockerSSD ("flash");
  2. each query becomes an :class:`~repro_torch.core.extent_store.
     AnalyticsJob` with ``reduce="topk"`` — the scored scan runs *in
     storage* and only k (id, score) pairs ride the RESULTS frame back
     (the 980x wire-reduction story applied to retrieval).  The
     :class:`~repro_torch.runtime.offload.OffloadPlanner` prices it next to
     decode: a serving node with no window headroom routes scoring to
     the host fallback instead of stalling in-flight horizons;
  3. top-k ids map to context token blocks through ONE batched
     ``embed_gather`` launch (no host-side per-request loop);
  4. the assembled prompt — template ++ retrieved chunks (rank order)
     ++ query tokens — goes to ``begin_request``/``add_request``, where
     the shared-prefix cache absorbs the repeated template and repeated
     retrieved chunks across requests (warm TTFT);
  5. on a pool, placement prefers the node that owns BOTH the embedding
     extent and the prompt's cached prefix pages: the first admission
     seeds the prefix on the extent-owning shard, and every later
     prefix hit routes back there.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.extent_store import AnalyticsJob
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.runtime.offload import OffloadPlanner


class RetrievalFrontend:
    """Query -> in-storage top-k -> assembled prompt -> admission.

    ``pool`` is the :class:`~repro_torch.core.storage_pool.StoragePool`
    holding the embedding extent; ``server`` is a ``PagedServer`` or
    ``PoolServer`` (pass None for retrieve-only use).
    ``corpus_tokens`` is the [n_docs, chunk_tokens] int32 table mapping
    a document id to its context token block, kept on ``device`` (the
    server's device when a server is given, else ``cuda``); ``template`` is the
    shared instruction prefix prepended to every prompt.  For
    ``metric="cosine"`` pre-normalize queries (ranking is invariant to
    query scale; the fold normalizes rows only).
    """

    def __init__(self, pool, server=None, *, corpus_tokens,
                 extent: str = "corpus-embed", k: int = 4,
                 metric: str = "dot", template=None, planner=None,
                 router=None, device=None):
        self.pool = pool
        self.server = server
        if device is None:
            device = server.device if server is not None else "cuda"
        self.device = resolve_device(device)
        self.corpus_tokens = torch.from_numpy(
            np.array(corpus_tokens, np.int32)).to(self.device)
        if self.corpus_tokens.ndim != 2:
            raise ValueError("corpus_tokens must be [n_docs, chunk_tokens]")
        self.extent = extent
        self.k = k
        self.metric = metric
        self.template = (np.asarray(template, np.int32)
                         if template is not None
                         else np.zeros((0,), np.int32))
        self.planner = planner or OffloadPlanner(pool, router=router)
        #: where scoring actually ran, by planner verdict (degraded
        #: modes — suspect reroute, unreachable-node retry, host
        #: fallback — get their own buckets)
        self.stats: Dict[str, int] = {"device": 0, "host": 0,
                                      "host-admission": 0,
                                      "host-suspect": 0,
                                      "device-retry": 0,
                                      "host-fallback": 0}

    # -- corpus ---------------------------------------------------------------

    def ingest(self, embeddings, node_ip: Optional[str] = None,
               replicas: int = 1) -> List[str]:
        """Place the corpus embedding matrix ([n_docs, d] — one row per
        ``corpus_tokens`` block) as a node-resident extent on
        ``replicas`` distinct alive nodes (``replicas > 1`` is what
        keeps retrieval bit-identical through a node loss: the planner
        retries on the surviving copy).  Returns the chosen ips."""
        embeddings = np.asarray(embeddings, np.float32)
        if embeddings.shape[0] != self.corpus_tokens.shape[0]:
            raise ValueError(
                f"{embeddings.shape[0]} embedding rows but "
                f"{self.corpus_tokens.shape[0]} corpus token blocks")
        alive = self.pool.alive_nodes()
        if replicas > len(alive):
            raise ValueError(f"asked for {replicas} replicas; only "
                             f"{len(alive)} nodes alive")
        first = node_ip or alive[0]
        ips = [first] + [ip for ip in alive if ip != first][:replicas - 1]
        for ip in ips:
            self.pool.nodes[ip].extents.put(self.extent, embeddings)
        return ips

    # -- retrieval ------------------------------------------------------------

    def retrieve(self, queries, force: Optional[str] = None) -> List[dict]:
        """Score every query against the extent (in storage when the
        planner and serving admission allow) and return per-query hit
        dicts ``{"ids", "scores", "where"}``, best-first."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        jobs = [AnalyticsJob(extent=self.extent, reduce="topk",
                             query=[float(x) for x in q], k=self.k,
                             metric=self.metric, job_id=i)
                for i, q in enumerate(queries)]
        out = []
        for rec in self.planner.execute(jobs, force=force):
            where = rec["where"]
            self.stats[where] = self.stats.get(where, 0) + 1
            pairs = rec["result"]
            out.append({"ids": [int(i) for i, _ in pairs],
                        "scores": [float(s) for _, s in pairs],
                        "where": where})
        return out

    def build_prompts(self, queries, query_tokens,
                      force: Optional[str] = None):
        """Retrieve for every query and assemble the serving prompts:
        template ++ retrieved chunks (rank order) ++ query tokens.
        The id->tokens mapping is one batched ``embed_gather`` over the
        whole query batch.  Returns (prompts, hits)."""
        if len(np.atleast_2d(np.asarray(queries))) != len(query_tokens):
            raise ValueError("one query_tokens sequence per query")
        hits = self.retrieve(queries, force=force)
        idx = np.zeros((len(hits), self.k), np.int32)
        for i, h in enumerate(hits):
            idx[i, :len(h["ids"])] = h["ids"]
        blocks = ops.embed_gather(
            self.corpus_tokens,
            torch.from_numpy(idx).to(self.device)).cpu().numpy()
        prompts = []
        for i, (h, qt) in enumerate(zip(hits, query_tokens)):
            chunks = blocks[i, :len(h["ids"])].reshape(-1)
            prompts.append(np.concatenate(
                [self.template, chunks.astype(np.int32),
                 np.asarray(qt, np.int32)]))
        return prompts, hits

    # -- placement ------------------------------------------------------------

    def preferred_node(self, prompt,
                       n_tokens: Optional[int] = None) -> Optional[int]:
        """Pool placement for an assembled prompt: the prefix-owning
        node when one exists (capacity-guarded, via the server's own
        policy); otherwise seed on the shard whose DockerSSD holds the
        embedding extent — so prefix pages and extent co-reside and
        every later prefix hit routes back to the same node.  None ->
        caller falls back to least-loaded."""
        srv = self.server
        if srv is None or not hasattr(srv, "pick_prefix_node"):
            return None                      # single-node PagedServer
        node = srv.pick_prefix_node(prompt, n_tokens)
        if node is not None:
            return node
        if self.pool._server is None:
            return None
        serve_ips = self.pool.serving_ips()
        ip = self.pool.locate_extent(self.extent)
        if ip not in serve_ips:
            return None
        shard = serve_ips.index(ip)
        need = srv.pages_needed(n_tokens if n_tokens is not None
                                else len(prompt))
        if (shard in srv.alive_nodes()
                and srv.table.shard_free_pages(shard) >= need):
            return shard
        return None

    # -- end to end -----------------------------------------------------------

    def submit(self, seq_id: int, query, query_tokens, *,
               force: Optional[str] = None, gen_tokens: int = 0):
        """One RAG admission: retrieve, assemble, admit (blocking).
        Returns (logits, prompt, hit)."""
        prompts, hits = self.build_prompts([query], [query_tokens],
                                           force=force)
        prompt = prompts[0]
        if self.server is None:
            raise RuntimeError("RetrievalFrontend has no server attached")
        if hasattr(self.server, "n_nodes"):
            node = self.preferred_node(prompt, len(prompt) + gen_tokens)
            logits = self.server.add_request(seq_id, prompt, node=node)
        else:
            logits = self.server.add_request(seq_id, prompt)
        return logits, prompt, hits[0]
