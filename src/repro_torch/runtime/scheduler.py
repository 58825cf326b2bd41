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

It talks only to the server's public surface.  The pool router of the
JAX package (``PoolRouter``) needs ``PoolServer`` and is not ported.
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

    def _activate(self, req: Request, last):
        """Admission finished: seed the first output token from the
        prompt's last logits ``last`` — greedy argmax, or (temperature >
        0) the draw the device sampler makes at this (sequence,
        position), on ``last``'s device."""
        req.t_first = time.monotonic()
        tok = sampled_token(last, self.sampling, req.rid, len(req.prompt))
        req.output.append(tok)
        self.server.set_pending(req.rid, tok)
        self.active[req.rid] = req

    def _admit(self):
        if self.prefill_chunk is None:
            while (self.waiting and len(self.active) < self.max_active and
                   self._window_has_room(self.waiting[0])):
                req = self.waiting.popleft()
                last = self.server.add_request(req.rid, req.prompt)
                self._activate(req, last)
            return
        # chunked admission: open admissions eagerly (prefix match only
        # — zero compute), then run at most ONE prefill chunk per
        # scheduler iteration, so the decode horizon between iterations
        # is never stalled by more than one chunk of admission work
        while (self.waiting and
               len(self.active) + len(self.prefilling) < self.max_active
               and self._window_has_room(self.waiting[0])):
            req = self.waiting.popleft()
            self.server.begin_request(req.rid, req.prompt)
            self.prefilling[req.rid] = req
        if self.prefilling:
            rid, req = next(iter(self.prefilling.items()))
            last = self.server.prefill_chunk(rid, self.prefill_chunk)
            if last is not None:
                del self.prefilling[rid]
                self._activate(req, last)

    def _shed_expired(self):
        """Deadline enforcement at the scheduler boundary: a request
        whose deadline budget expired while it waited is shed with a
        recorded reason before any pages are spent on it (extends the
        explicit load-shedding surface — capacity-impossible, queue
        cap)."""
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
            self.server.free_sequence(rid)

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
