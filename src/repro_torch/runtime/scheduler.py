"""Continuous-batching request scheduler over the port's PagedServer.

The port of ``repro.runtime.scheduler``'s ``Request`` and
``ContinuousBatcher``: requests arrive and finish at different times,
and the loop

  * admits a request when the device window can pin its projected
    working set beside the active batch (otherwise it waits), whole or
    one prefill chunk an iteration (chunked admission);
  * decodes the active set once an iteration: one token, one fused
    horizon, or one speculative draft-verify pass, greedy or sampled on
    the device (``PagedServer.decode``); finished sequences (EOS or
    ``max_tokens``) free their pages at once through ``free_sequence``
    and a waiting request takes the slot;
  * sheds load explicitly (a request that can never fit, a full queue,
    an expired deadline) with a recorded reason;
  * reports per-request latency, time to first token and time per
    output token, and the tier counters.

It talks only to the server's public surface.

:class:`PoolRouter`, the port of the JAX package's, generalizes the same
loop to the storage pool (``runtime.pool.PoolServer``): least-loaded
placement across DockerSSD nodes (optionally routed through the
``StoragePool`` frontend so the decision rides Ether-oN control frames),
per-node admission control, and heartbeat-driven failover requeue.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.runtime.serve import sampled_token


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_tokens: int
    eos_id: Optional[int] = None
    # telemetry — all stamps are time.monotonic(): latency/TTFT deltas
    # must survive wall-clock adjustment (NTP slew would make
    # time.time()-based tails negative)
    t_arrive: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    output: List[int] = dataclasses.field(default_factory=list)
    # failover bookkeeping: how many times this request lost its node
    # and re-entered the queue (bounded — see PoolRouter.max_requeues)
    requeues: int = 0
    reject_reason: Optional[str] = None
    # per-request deadline budget, seconds from arrival.  A request
    # still waiting for admission past its deadline is shed at the next
    # scheduler boundary with a recorded reason (the answer would
    # arrive too late to be useful); None = no deadline.  Requests
    # already decoding run to completion — their TTFT was met.
    deadline_s: Optional[float] = None

    @property
    def done(self) -> bool:
        return (len(self.output) >= self.max_tokens or
                (self.eos_id is not None and self.output and
                 self.output[-1] == self.eos_id))


class ContinuousBatcher:
    """Iteration-level scheduler for a PagedServer.

    ``horizon=1`` (default) schedules per token: admit, one decode
    step, retire.  ``horizon=H`` schedules on *horizon
    boundaries*: each iteration runs one fused H-token device loop
    (``PagedServer.decode(horizon=H)``) and joins/evicts between
    horizons.  Per-request EOS and ``max_tokens`` are enforced on
    device via budgets (plus host-side truncation when active requests
    disagree on ``eos_id``), so greedy outputs are token-for-token
    identical to the per-token schedule.

    ``speculative=True`` runs each horizon iteration as a draft-verify
    pass (``decode(speculative=True)``): an iteration now yields a
    *variable* number of tokens per request — whatever the acceptance
    mask kept — and budgets re-derive from actual output lengths, so
    the loop needs no other change.  ``sampling`` threads an on-device
    :class:`~repro_torch.runtime.serve.SamplingConfig` through every decode
    call (greedy when None).
    """

    def __init__(self, server, *, max_active: int = 8, horizon: int = 1,
                 prefill_chunk: Optional[int] = None,
                 speculative: bool = False, sampling=None,
                 max_waiting: Optional[int] = None):
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        if speculative and horizon < 2:
            raise ValueError(
                f"speculative scheduling needs horizon >= 2, got {horizon}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.server = server
        self.max_active = max_active
        self.horizon = horizon
        self.speculative = speculative
        self.sampling = sampling
        # chunked admission: an admitted request prefills at most
        # ``prefill_chunk`` tokens per scheduler iteration (one chunk),
        # interleaved with the active set's decode horizons, so
        # admission never stalls decode longer than one chunk.  None =
        # legacy blocking admission (the whole suffix in one chunk).
        self.prefill_chunk = prefill_chunk
        # explicit backpressure: submissions beyond this queue depth are
        # rejected up front instead of waiting unboundedly (None = no cap)
        self.max_waiting = max_waiting
        self.waiting: Deque[Request] = deque()
        self.prefilling: Dict[int, Request] = {}
        self.active: Dict[int, Request] = {}
        self.finished: List[Request] = []
        self.rejected: List[Request] = []

    # -- admission -----------------------------------------------------------

    def _capacity_impossible(self, req: Request) -> Optional[str]:
        """Reason this request could NEVER be admitted, or None."""
        if self._pages_needed(req) > self.server.hbm_pages:
            return (f"needs {self._pages_needed(req)} pages; window has "
                    f"{self.server.hbm_pages}")
        return None

    def _reject(self, req: Request, reason: str):
        req.reject_reason = reason
        self.rejected.append(req)

    def submit(self, req: Request) -> bool:
        """Queue a request.  Returns False (and records the request on
        ``rejected`` with a reason) when it can never fit or the queue
        is at its backpressure cap — load is shed explicitly at the
        door, never dropped silently inside the loop."""
        req.t_arrive = time.monotonic()
        why = self._capacity_impossible(req)
        if why is not None:
            self._reject(req, why)
            return False
        if self.max_waiting is not None and \
                len(self.waiting) >= self.max_waiting:
            self._reject(req, f"queue full ({self.max_waiting} waiting)")
            return False
        self.waiting.append(req)
        return True

    def _pages_needed(self, req: Request) -> int:
        return self.server.pages_needed(len(req.prompt) + req.max_tokens)

    def _window_has_room(self, req: Request) -> bool:
        pinned_now = sum(self._pages_needed(r) for r in self.active.values())
        pinned_now += sum(self._pages_needed(r)
                          for r in self.prefilling.values())
        return pinned_now + self._pages_needed(req) <= self.server.hbm_pages

    def _prompt_of(self, req: Request) -> np.ndarray:
        """The tokens a (re-)prefill must write: the prompt plus any
        output already generated.  Fresh requests have no output, so
        this is the plain prompt; a failover-requeued request resumes by
        teacher-forcing its own history (greedy *and* sampled decode
        continue identically to the uninterrupted run — draws are keyed
        per (sequence id, absolute position), not per pass)."""
        if not req.output:
            return req.prompt
        return np.concatenate([np.asarray(req.prompt, np.int32),
                               np.asarray(req.output, np.int32)])

    def _prefill(self, req: Request):
        """Blocking-admission hook — PoolRouter overrides to route the
        placement through the pool frontend."""
        return self.server.add_request(req.rid, self._prompt_of(req))

    def _begin_prefill(self, req: Request):
        """Chunked-admission hook: open the admission (prefix-cache
        match, no compute) — PoolRouter overrides to route the
        placement through the pool frontend."""
        self.server.begin_request(req.rid, self._prompt_of(req))

    def _release(self, rid: int):
        """Retirement hook — PoolRouter overrides to notify the owning
        node over Ether-oN before the pages come back."""
        self.server.free_sequence(rid)

    def _activate(self, req: Request, last):
        """Admission finished: seed the next output token from the
        prompt's last logits ``last`` — greedy argmax, or (temperature >
        0) the draw the device sampler makes at this (sequence,
        position), on ``last``'s device, so a failover-requeued request
        continues exactly like the uninterrupted sampled run."""
        if not req.output:          # requeues keep their first-token stamp
            req.t_first = time.monotonic()
        tok = sampled_token(last, self.sampling, req.rid,
                            len(req.prompt) + len(req.output))
        req.output.append(tok)
        self.server.set_pending(req.rid, tok)
        self.active[req.rid] = req

    def _admit(self):
        if self.prefill_chunk is None:
            while (self.waiting and len(self.active) < self.max_active and
                   self._window_has_room(self.waiting[0])):
                req = self.waiting.popleft()
                self._activate(req, self._prefill(req))
            return
        # chunked admission: open admissions eagerly (prefix match only
        # — zero compute), then run at most ONE prefill chunk per
        # scheduler iteration, so the decode horizon between iterations
        # is never stalled by more than one chunk of admission work
        while (self.waiting and
               len(self.active) + len(self.prefilling) < self.max_active
               and self._window_has_room(self.waiting[0])):
            req = self.waiting.popleft()
            self._begin_prefill(req)
            self.prefilling[req.rid] = req
        if self.prefilling:
            rid, req = next(iter(self.prefilling.items()))
            last = self.server.prefill_chunk(rid, self.prefill_chunk)
            if last is not None:
                del self.prefilling[rid]
                self._activate(req, last)

    def _failover(self):
        """Failure-sync hook — PoolRouter overrides to requeue
        sequences lost to node deaths.  No-op on a single server."""

    def _shed_expired(self):
        """Deadline enforcement at the scheduler boundary: a request
        whose deadline budget expired while it waited is shed with a
        recorded reason before any pages are spent on it (extends the
        explicit load-shedding surface — capacity-impossible, queue
        cap, requeue storm)."""
        if not any(r.deadline_s is not None for r in self.waiting):
            return
        now = time.monotonic()
        keep: Deque[Request] = deque()
        for req in self.waiting:
            waited = now - req.t_arrive
            if req.deadline_s is not None and waited > req.deadline_s:
                self._reject(req, f"deadline {req.deadline_s:.3f}s "
                             f"exceeded after {waited:.3f}s in queue")
            else:
                keep.append(req)
        self.waiting = keep

    # -- the serving loop -----------------------------------------------------

    def step(self) -> int:
        """One scheduler iteration: admit, decode the active set once
        (one token, or one fused horizon), retire finished sequences.
        Returns tokens produced."""
        self._shed_expired()
        self._admit()
        # retire anything already done from its prefill token
        self._retire()
        # a node can die DURING admission/retirement (its control
        # frames tick a fault injector's crash schedule): re-sync the
        # active set before decoding, or the step would feed sequences
        # the server just dropped
        self._failover()
        if not self.active:
            return 0
        if self.horizon <= 1:
            out = self.server.decode(1, seqs=list(self.active),
                                     sampling=self.sampling)
            n = 0
            for rid, toks in out.items():
                self.active[rid].output.extend(toks)
                n += len(toks)
        else:
            n = self._horizon_step()
        self._retire()
        return n

    def _horizon_step(self) -> int:
        """Decode one fused horizon across the active set.  The device
        stops each sequence at its own budget (remaining max_tokens,
        capped by the horizon) and — when every active request agrees
        on one ``eos_id`` — at EOS; with mixed eos ids the surplus
        tokens are truncated host-side, so outputs match the per-token
        schedule either way.

        Speculative iterations return variable accepted lengths per
        request; budgets re-derive from output lengths each iteration,
        so variable progress needs no special accounting."""
        budgets = {rid: req.max_tokens - len(req.output)
                   for rid, req in self.active.items()}
        h = min(self.horizon, max(budgets.values()))
        eos_ids = {req.eos_id for req in self.active.values()}
        eos = eos_ids.pop() if len(eos_ids) == 1 else None
        out = self.server.decode(h, seqs=list(self.active), horizon=h,
                                 eos_id=eos, budgets=budgets,
                                 sampling=self.sampling,
                                 # a 1-token tail horizon has no room
                                 # for candidates: run it plain
                                 speculative=self.speculative and h >= 2)
        n = 0
        for rid, toks in out.items():
            req = self.active[rid]
            for t in toks:
                if req.done:          # mixed-eos truncation
                    break
                req.output.append(t)
                n += 1
        return n

    def _retire(self):
        for rid in [r for r, q in self.active.items() if q.done]:
            req = self.active.pop(rid)
            req.t_done = time.monotonic()
            self.finished.append(req)
            # every tier's pages come back in one call; the physical
            # slots are reusable by the next waiting request immediately
            self._release(rid)

    def run_to_completion(self, max_iters: int = 10_000) -> dict:
        it = 0
        while (self.waiting or self.prefilling or self.active) and \
                it < max_iters:
            self.step()
            it += 1
        lat = [r.t_done - r.t_arrive for r in self.finished]
        ttft = [r.t_first - r.t_arrive for r in self.finished]
        # time per output token after the first (the streaming rate a
        # user sees once tokens start arriving)
        tpot = [(r.t_done - r.t_first) / max(len(r.output) - 1, 1)
                for r in self.finished]

        def pct(xs, q):
            return float(np.percentile(xs, q)) if xs else 0.0

        return {
            "requests": len(self.finished),
            "rejected": len(self.rejected),
            "iters": it,
            "mean_latency_s": float(np.mean(lat)) if lat else 0.0,
            "p99_latency_s": pct(lat, 99),
            "mean_ttft_s": float(np.mean(ttft)) if ttft else 0.0,
            "p50_ttft_s": pct(ttft, 50),
            "p99_ttft_s": pct(ttft, 99),
            "mean_tpot_s": float(np.mean(tpot)) if tpot else 0.0,
            "p50_tpot_s": pct(tpot, 50),
            "p99_tpot_s": pct(tpot, 99),
            "tier": self.server.tier_stats(),
        }


class PoolRouter(ContinuousBatcher):
    """Pool-aware continuous batcher for a ``runtime.pool.PoolServer``.

    The same iteration loop as :class:`ContinuousBatcher`, generalized
    to a pool of DockerSSD nodes:

      * **placement** — an admitted request goes to the least-loaded
        node with room for its projected working set; when a
        :class:`~repro_torch.core.storage_pool.StoragePool` frontend is bound,
        the placement is routed through it (the decision rides an
        Ether-oN control frame to the chosen node before the shard
        admits the pages);
      * **per-node admission control** — a request is admitted only
        when one node's window (placed policy) or every node's share of
        the striped extent fits alongside that node's active load;
      * **failover requeue** (placed policy) — each step polls the
        pool's heartbeats; sequences homed on a node that died are
        dropped by the server and re-enter the queue at the front,
        where the next admission re-prefills prompt+history on a
        surviving node (greedy and sampled decode both complete the
        output identically to an uninterrupted run — sampling draws are
        keyed per sequence/position).  A *striped* extent spans
        every node, so a node failure is unrecoverable within the job:
        the router raises immediately instead of requeueing work that
        could never re-admit (restart the pool job — DESIGN.md §Pool
        serving).
    """

    def __init__(self, server, pool=None, *, max_active: int = 8,
                 horizon: int = 1, prefill_chunk: Optional[int] = None,
                 speculative: bool = False, sampling=None,
                 max_waiting: Optional[int] = None,
                 max_requeues: int = 3):
        super().__init__(server, max_active=max_active, horizon=horizon,
                         prefill_chunk=prefill_chunk,
                         speculative=speculative, sampling=sampling,
                         max_waiting=max_waiting)
        self.pool = pool
        self.requeues = 0
        # per-request failover cap: when nodes die faster than
        # re-prefill recovers, the storm sheds the unlucky requests
        # explicitly instead of cycling them through the queue forever
        self.max_requeues = max_requeues
        self._target_node: Optional[int] = None

    def _suspect_shards(self) -> set:
        return self.pool.suspect_shards() if self.pool is not None \
            else set()

    # -- per-node admission ---------------------------------------------------

    def _capacity_impossible(self, req: Request) -> Optional[str]:
        srv = self.server
        need = self._pages_needed(req)
        cap = srv.pages_per_node
        if srv.policy == "placed":
            if need > cap:
                return (f"needs {need} pages; a node's window has {cap}")
            return None
        share = max(self._striped_share(need, s, srv.n_nodes)
                    for s in range(srv.n_nodes))
        if share > cap:
            return (f"striped share is {share} pages/node; a node's "
                    f"window has {cap}")
        return None

    @staticmethod
    def _striped_share(n_pages: int, node: int, n_nodes: int) -> int:
        """Pages of an ``n_pages`` striped extent that land on ``node``."""
        return len(range(node, n_pages, n_nodes))

    def _node_load(self) -> Dict[int, int]:
        """Projected pinned pages per alive node from the active set
        (in-flight chunked admissions hold pages too)."""
        srv = self.server
        load = {s: 0 for s in srv.alive_nodes()}
        for r in list(self.active.values()) + list(
                self.prefilling.values()):
            need = self._pages_needed(r)
            if srv.policy == "placed":
                s = srv.node_of(r.rid)
                if s in load:
                    load[s] += need
            else:
                for s in load:
                    load[s] += self._striped_share(need, s, srv.n_nodes)
        return load

    def node_headroom(self) -> Dict[int, int]:
        """Free window pages per alive node given the active set — the
        admission surface shared with the analytics
        :class:`~repro_torch.runtime.offload.OffloadPlanner` (serving and
        in-storage analytics run on the same DockerSSDs; one accounting
        decides who gets a node)."""
        cap = self.server.pages_per_node
        return {s: cap - n for s, n in self._node_load().items()}

    def _window_has_room(self, req: Request) -> bool:
        srv = self.server
        cap = srv.pages_per_node
        need = self._pages_needed(req)
        load = self._node_load()
        if not load:
            return False
        if srv.policy == "placed":
            fits = [s for s in load if load[s] + need <= cap]
            # prefer the fitting node that already holds the request's
            # prefix (zero prefill compute there); else least-loaded
            self._target_node = None
            if fits:
                # suspect shards are last resort: a warm prefix on a
                # straggler is slower than a cold prefill elsewhere
                good = [s for s in fits
                        if s not in self._suspect_shards()] or fits
                pn, hit = srv.best_prefix_node(self._prompt_of(req))
                self._target_node = pn if (hit and pn in good) else \
                    min(good, key=lambda s: (load[s], s))
            return bool(fits)
        self._check_striped_alive()
        return all(load[s] + self._striped_share(need, s, srv.n_nodes) <= cap
                   for s in load)

    def _check_striped_alive(self):
        if self.server._dead:
            raise RuntimeError(
                f"striped pool lost node(s) {sorted(self.server._dead)}: "
                "a striped extent spans every node, so the job cannot "
                "continue degraded — restart the pool (DESIGN.md §Pool "
                "serving)")

    def _route(self, req: Request, prompt) -> Optional[int]:
        """Placement for one admission (placed policy): the node the
        admission check chose — prefix-owning when possible — routed
        through the pool frontend's Ether-oN control frame when a
        StoragePool is bound."""
        node = self._target_node
        if self.pool is not None:
            node = self.pool.place_sequence(
                req.rid, len(req.prompt) + req.max_tokens, node=node,
                prompt=prompt)
        return node

    def _prefill(self, req: Request):
        srv = self.server
        prompt = self._prompt_of(req)
        if srv.policy != "placed":
            return srv.add_request(req.rid, prompt)
        return srv.add_request(req.rid, prompt,
                               node=self._route(req, prompt))

    def _begin_prefill(self, req: Request):
        srv = self.server
        prompt = self._prompt_of(req)
        if srv.policy != "placed":
            srv.begin_request(req.rid, prompt)
            return
        srv.begin_request(req.rid, prompt, node=self._route(req, prompt))

    def _release(self, rid: int):
        if self.pool is not None:
            self.pool.retire_sequence(rid)
        else:
            self.server.free_sequence(rid)

    # -- failover -------------------------------------------------------------

    def _failover(self):
        if self.pool is None:
            return
        self.pool.check_heartbeats()
        victims = self.pool.take_requeued()
        if victims and self.server.policy != "placed":
            self._check_striped_alive()         # unrecoverable: fail fast
        for rid in reversed(victims):           # keep original order at front
            req = self.active.pop(rid, None)
            if req is None:                     # admission was in flight
                req = self.prefilling.pop(rid, None)
            if req is not None:
                req.requeues += 1
                if req.requeues > self.max_requeues:
                    # requeue storm: shed this request explicitly
                    self._reject(req, f"lost its node "
                                 f"{req.requeues} times")
                    continue
                self.requeues += 1
                self.waiting.appendleft(req)

    def step(self) -> int:
        self._failover()
        return super().step()
