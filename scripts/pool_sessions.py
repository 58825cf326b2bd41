"""Pool-serving sessions that run the same host program one node a rank
and in one process, so the two can be held to each other: the harness
of ``tests/test_torch_pool_ranks.py``, ``tests/test_torch_card.py``'s
rank cases and ``chip_smoke.py``'s ``serve_ranks`` phase.

``pool_session(spec)`` drives a ``PoolServer`` through admission, one
step and a decode (or a drain, or a failover behind a ``PoolRouter``)
and returns its tokens, logits, times and collectives;
``pool_sessions(specs)`` runs several pools in one spawn of ranks.
Spawned ranks import this module by name, so put ``scripts/`` on
``sys.path`` before handing these functions to
``repro_torch.launch.mesh.run_ranks``::

    sys.path.insert(0, "scripts"); sys.path.insert(0, "src")
    from pool_sessions import pool_session
    run_ranks(pool_session, 4, (dict(spec, ranks=True),), ...)

The launcher's own pool route is ``python -m repro_torch.launch.serve
--pool`` (under ``torchrun`` for one node a rank).
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.core.storage_pool import StoragePool
from repro_torch.kernels import ops
from repro_torch.models.api import get_model
from repro_torch.runtime.pool import PoolServer
from repro_torch.runtime.scheduler import PoolRouter, Request
from repro_torch.runtime.sharding import pool_mesh


def session_weights(spec: dict, device):
    """(model, params) of a :func:`pool_session` spec: ``cfg`` (ArchConfig
    fields), and ``params`` (a ``torch.save`` file of CPU tensors) or
    ``seed`` (random weights drawn on ``device``)."""
    model = get_model(ArchConfig(**spec["cfg"]), moe_no_drop=True)
    if spec.get("params"):
        params = _tree_to(torch.load(spec["params"], weights_only=False),
                          device)
    else:
        params = model.init(torch.Generator(device=device).manual_seed(
            spec.get("seed", 0)), device=device)
    return model, params


def _session_device(spec: dict):
    device = torch.device(spec.get("device", "cpu"))
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def pool_session(spec: dict, model=None, params=None, mesh=None) -> dict:
    """One pool-serving session, for :func:`launch.mesh.run_ranks` (one
    node a rank, ``spec["ranks"]`` true; this process already joined the
    ranks) or one process (``spec["nodes"]`` nodes on one card).  The
    same host program either way, so the two can be held to each other.

    ``spec``: the weights (:func:`session_weights`; or ``model`` and
    ``params`` given), ``device``, ``server`` (PoolServer keywords;
    ``dtype`` by name), ``prompts``, ``gens``, ``chunk`` (prefill chunk),
    ``gaps`` (keep each step's gap between its two largest scores), and
    ``kind``:

      * ``"decode"``: every prompt admitted (prefill logits kept), one
        step of every sequence (its logits kept; its argmax is the next
        token), then ``decode(max(gens) - 2)`` at ``horizon`` (None:
        per token) / ``speculative``;
      * ``"drain"``: the same with ``drain_node(drain)`` after
        ``drain_after`` decode tokens;
      * ``"failover"``: a ``PoolRouter`` over a ``StoragePool`` frontend,
        node ``fail`` killed after ``fail_after`` router steps.

    On ranks the mesh is ``mesh``, else the pool mesh over every rank.
    Returns the tokens and logits (CPU tensors), the node, wall times
    (the session's, and the prefill's and the decode's),
    tokens/s, peak card memory, the collectives of the decode and of the
    session with their bytes, and the session's kernel launches."""
    device = _session_device(spec)
    if model is None:
        model, params = session_weights(spec, device)
    kw = dict(spec.get("server", {}))
    if "dtype" in kw:
        kw["dtype"] = getattr(torch, kw["dtype"])
    if spec.get("ranks"):
        if mesh is None:
            mesh = pool_mesh(dist.get_world_size(), device_type=device.type)
    else:
        mesh = None
        kw["n_nodes"] = spec["nodes"]
    srv = PoolServer(model, params, mesh=mesh, device=device, **kw)
    prompts = [np.asarray(p, np.int32) for p in spec["prompts"]]
    gens = list(spec["gens"])
    kind = spec.get("kind", "decode")
    res = {"node": srv.node}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    gaps = []
    if spec.get("gaps"):
        inner = srv.token_scores

        def scores(logits, *args):
            out = inner(logits, *args)
            top = out.topk(2, dim=-1).values
            gaps.append(top[..., 0] - top[..., 1])
            return out
        srv.token_scores = scores
    launches0 = ops.launch_counts()
    t0 = time.perf_counter()
    if kind == "failover":
        pool = StoragePool(srv.n_nodes, heartbeat_timeout=0.0,
                           extent_cfg={"device": device})
        pool.attach_server(srv)
        router = PoolRouter(srv, pool, max_active=len(prompts),
                            horizon=spec.get("horizon") or 1)
        for i, (p, g) in enumerate(zip(prompts, gens)):
            router.submit(Request(rid=i, prompt=p, max_tokens=g))
        for _ in range(spec.get("fail_after", 2)):
            router.step()
        victim = spec["fail"]
        pool.nodes[pool.serving_ips()[victim]].fail()
        router.run_to_completion()
        srv.sync_check()
        res.update(tokens={r.rid: list(r.output) for r in router.finished},
                   requeues=router.requeues, alive=srv.alive_nodes())
    else:
        res["prefill"] = [srv.add_request(i, p,
                                          chunk=spec.get("chunk")).cpu()
                          for i, p in enumerate(prompts)]
        first = {i: int(lg.argmax()) for i, lg in enumerate(res["prefill"])}
        sync()
        t1 = time.perf_counter()
        step = srv.step(first)
        res["step"] = {s: lg.cpu() for s, lg in step.items()}
        for s, lg in step.items():
            srv.set_pending(s, int(lg.argmax()))
        rest = max(gens) - 2
        stats0 = dict(srv.collective_stats)
        hz, spec_on = spec.get("horizon"), spec.get("speculative", False)
        if kind == "drain":
            k = spec.get("drain_after", 2)
            a = srv.decode(k, horizon=hz, speculative=spec_on)
            res["drain"] = srv.drain_node(spec["drain"])
            b = srv.decode(rest - k, horizon=hz, speculative=spec_on)
            out = {s: a[s] + b.get(s, []) for s in a}
        else:
            out = srv.decode(rest, horizon=hz, speculative=spec_on)
        sync()
        t2 = time.perf_counter()
        res["tokens"] = {s: [first[s], int(step[s].argmax())] + out[s]
                         for s in out}
        n_tok = sum(len(v) - 1 for v in res["tokens"].values())
        res.update(prefill_s=t1 - t0, decode_s=t2 - t1,
                   tok_s=n_tok / max(t2 - t1, 1e-9),
                   step_ms=1e3 * (t2 - t1) / max(rest + 1, 1),
                   collectives={k: v - stats0[k] for k, v in
                                srv.collective_stats.items()})
    sync()
    res["session_s"] = time.perf_counter() - t0
    if gaps:
        # each decode step's gap between its two largest scores, [steps,
        # B], and the prefill logits' (the near-tie rule's record)
        res["gaps"] = torch.stack(gaps).cpu()
        top = [lg.topk(2).values for lg in res.get("prefill", [])]
        res["first_gaps"] = {i: float(t[0] - t[1]) for i, t in enumerate(top)}
    res["launches"] = {k: v - launches0.get(k, 0) for k, v in
                       ops.launch_counts().items() if v - launches0.get(k, 0)}
    res["collectives_total"] = dict(srv.collective_stats)
    res["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else 0)
    return res


def pool_sessions(specs: list) -> list:
    """:func:`pool_session` for each of ``specs`` in turn on this rank,
    the weights built once (from the first spec).  Spec ``i`` runs on
    a pool mesh over the first ``specs[i]["ranks"]`` ranks (every rank
    builds it; the others wait at a barrier and give None), so one
    spawn of N ranks serves pools of 1, 2, ..., N nodes."""
    device = _session_device(specs[0])
    model, params = session_weights(specs[0], device)
    out = []
    for spec in specs:
        n = int(spec["ranks"])
        mesh = pool_mesh(n, device_type=device.type)
        out.append(pool_session(spec, model, params, mesh)
                   if dist.get_rank() < n else None)
        dist.barrier()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)
