"""SLO-driven elastic pool autoscaling.

The control loop that makes pool node count a runtime variable: an
:class:`Autoscaler` ticks once per scheduler iteration (between decode
horizons — never inside one), watches queue depth and rolling p50/p99
TTFT/TPOT against a declared :class:`ServingSLO`, and moves the serving
set one node at a time:

  * **scale-up** on an SLO breach (latency tail over target, or queue
    depth over the backlog cap): ``StoragePool.grow_serving`` activates
    a parked shard / wires a fabric node to an unbacked one.  The
    node's window already exists in the pool's store, sized for the
    pow2 capacity bucket (DESIGN.md §Elastic pool).
  * **scale-down** on sustained headroom (mostly-empty windows, empty
    queue, for ``sustain`` consecutive ticks):
    ``StoragePool.drain_serving_node`` runs the two-path zero-drop
    drain — warm device-to-device page migration, cold failover
    re-prefill — so scale-down never sheds a request.

Both directions respect a cooldown so one burst doesn't saw-tooth the
pool, and every decision is recorded (``decisions``) along with the
SLO-recovery latency (``recoveries``): the time from first breach until
the rolling tail is back under target — the headline number of the
autoscale benchmark cell.

The class is duck-typed against the router (``waiting`` / ``active`` /
``prefilling`` / ``finished``) and the pool frontend
(``grow_serving`` / ``drain_serving_node``), so decision logic is unit
testable without a device in sight.

The port's copy of ``repro.runtime.autoscaler``, line for line.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class ServingSLO:
    """Declared service-level objectives.  ``inf`` disables a term;
    breach = ANY enabled term over target."""
    ttft_p50_s: float = float("inf")
    ttft_p99_s: float = float("inf")
    tpot_p50_s: float = float("inf")
    tpot_p99_s: float = float("inf")
    # backlog cap: more requests waiting than this is a breach even
    # before their latency shows up in the finished-request tail (the
    # early-warning signal — queue depth leads TTFT by construction)
    queue_depth: int = 1_000_000


@dataclasses.dataclass
class ScaleDecision:
    t: float                 # monotonic stamp
    tick: int
    kind: str                # "up" | "down"
    nodes: int               # serving set size AFTER the decision
    reason: str


class Autoscaler:
    """One-node-at-a-time elastic controller for a PoolRouter +
    StoragePool pair.

    ``window`` — freshness horizon in controller ticks: the percentile
    metrics cover requests that finished within the last ``window``
    ticks.  A tick horizon (not a last-N-finished tail) matters for the
    close of a breach: once a burst passes and traffic thins, its slow
    requests age out and the pool reads healthy — a count window would
    hold the burst in the percentiles indefinitely and pin the pool
    scaled up.  The age of the oldest *waiting* request also enters the
    TTFT samples: it is a lower bound on that request's eventual TTFT,
    so a wedged queue breaches before anything finishes.

    ``headroom_frac`` — scale-down arms when the pooled free-page
    fraction across the serving set exceeds this AND the queue is idle;
    it fires after ``sustain`` consecutive armed ticks.  A drain is
    attempted only when some surviving node's window can absorb the
    candidate's resident pages (the warm path stays warm); otherwise
    the controller waits — scale-down is an optimization, never worth a
    cold re-prefill storm.

    ``cooldown`` — minimum ticks between decisions in either direction.
    """

    def __init__(self, router, pool, *, slo: ServingSLO,
                 min_nodes: int = 1, max_nodes: Optional[int] = None,
                 window: int = 16, cooldown: int = 4,
                 headroom_frac: float = 0.6, sustain: int = 6):
        self.router = router
        self.pool = pool
        self.slo = slo
        self.min_nodes = min_nodes
        self.max_nodes = (max_nodes if max_nodes is not None
                          else router.server.n_nodes)
        self.window = window
        self.cooldown = cooldown
        self.headroom_frac = headroom_frac
        self.sustain = sustain
        self.tick_count = 0
        self.decisions: List[ScaleDecision] = []
        self.recoveries: List[Dict[str, float]] = []
        self._last_action_tick = -(10 ** 9)
        self._idle_ticks = 0
        self._breach_since: Optional[float] = None
        self._samples: List[tuple] = []      # (tick, ttft_s, tpot_s)
        self._seen = 0                       # finished already sampled

    # -- observation ---------------------------------------------------------

    def metrics(self) -> Dict[str, float]:
        """Tail metrics over the requests that finished within the last
        ``window`` ticks, plus the live queue."""
        now = time.monotonic()
        fin = self.router.finished
        for r in fin[self._seen:]:
            self._samples.append(
                (self.tick_count, r.t_first - r.t_arrive,
                 (r.t_done - r.t_first) / max(len(r.output) - 1, 1)))
        self._seen = len(fin)
        cut = self.tick_count - self.window
        self._samples = [s for s in self._samples if s[0] > cut]
        ttft = [s[1] for s in self._samples]
        tpot = [s[2] for s in self._samples]
        # the oldest waiting request's age is a floor on its eventual
        # TTFT — count it so saturation breaches without waiting for
        # the backlog to finish
        if self.router.waiting:
            ttft.append(max(now - r.t_arrive for r in self.router.waiting))

        def pct(xs, q):
            return float(np.percentile(xs, q)) if xs else 0.0

        return {"queue_depth": len(self.router.waiting),
                "p50_ttft_s": pct(ttft, 50), "p99_ttft_s": pct(ttft, 99),
                "p50_tpot_s": pct(tpot, 50), "p99_tpot_s": pct(tpot, 99)}

    def _breached(self, m: Dict[str, float]) -> Optional[str]:
        s = self.slo
        if m["queue_depth"] > s.queue_depth:
            return f"queue depth {m['queue_depth']} > {s.queue_depth}"
        for key, target in (("p50_ttft_s", s.ttft_p50_s),
                            ("p99_ttft_s", s.ttft_p99_s),
                            ("p50_tpot_s", s.tpot_p50_s),
                            ("p99_tpot_s", s.tpot_p99_s)):
            if m[key] > target:
                return f"{key} {m[key]:.4f} > {target:.4f}"
        return None

    # -- headroom / drain candidacy ------------------------------------------

    def _pool_headroom(self) -> float:
        srv = self.router.server
        alive = srv.alive_nodes()
        free = sum(srv.table.shard_free_pages(s) for s in alive)
        return free / max(len(alive) * srv.pages_per_node, 1)

    def _drain_candidate(self) -> Optional[int]:
        """The emptiest serving node, provided some other node's window
        can absorb its occupied pages (warm path guaranteed while
        nothing changes under us; the cold fallback still catches
        races)."""
        srv = self.router.server
        alive = srv.alive_nodes()
        if len(alive) <= self.min_nodes:
            return None
        cand = max(alive, key=lambda s: (srv.table.shard_free_pages(s), -s))
        occupied = srv.pages_per_node - srv.table.shard_free_pages(cand)
        best_other = max(srv.table.shard_free_pages(s)
                         for s in alive if s != cand)
        return cand if best_other >= occupied else None

    # -- the control loop ----------------------------------------------------

    def tick(self) -> Optional[ScaleDecision]:
        """One controller iteration; call between scheduler steps.
        Returns the decision taken, if any."""
        self.tick_count += 1
        now = time.monotonic()
        m = self.metrics()
        why = self._breached(m)
        srv = self.router.server
        active = len(srv.alive_nodes())

        if why is not None:
            self._idle_ticks = 0
            if self._breach_since is None:
                self._breach_since = now
            if (active < self.max_nodes and
                    self.tick_count - self._last_action_tick >=
                    self.cooldown):
                self.pool.grow_serving(active + 1)
                self._last_action_tick = self.tick_count
                d = ScaleDecision(now, self.tick_count, "up", active + 1,
                                  why)
                self.decisions.append(d)
                return d
            return None

        # SLO healthy again: close an open breach episode and record
        # how long the pool took to pull the tail back under target
        if self._breach_since is not None:
            self.recoveries.append(
                {"t": now, "recovery_s": now - self._breach_since,
                 "nodes": active})
            self._breach_since = None

        idle = (not self.router.waiting and not self.router.prefilling
                and self._pool_headroom() >= self.headroom_frac)
        self._idle_ticks = self._idle_ticks + 1 if idle else 0
        if (self._idle_ticks >= self.sustain and
                active > self.min_nodes and
                self.tick_count - self._last_action_tick >= self.cooldown):
            cand = self._drain_candidate()
            if cand is not None:
                rep = self.pool.drain_serving_node(cand)
                self._last_action_tick = self.tick_count
                self._idle_ticks = 0
                d = ScaleDecision(
                    now, self.tick_count, "down", active - 1,
                    f"sustained headroom ({self._pool_headroom():.2f} "
                    f"free, {len(rep['moved'])} seqs migrated warm, "
                    f"{len(rep['cold'])} cold)")
                self.decisions.append(d)
                return d
        return None
