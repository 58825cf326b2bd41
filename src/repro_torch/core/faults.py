"""Deterministic fault injection at the Ether-oN fabric boundary.

A disaggregated pool lives on a lossy fabric: frames drop, payloads
corrupt in flight, switches duplicate and reorder, nodes straggle and
nodes die.  The chaos layer models all of it *deterministically*: a
:class:`FaultPlan` is a declarative, JSON-round-trippable schedule, and
a :class:`FaultInjector` seeded from it makes every chaos run
replayable bit for bit — the property the chaos invariant tests lean
on (same plan => same faults => same retransmit counters => identical
outputs).

The injector sits on the one seam every frame crosses
(:meth:`~repro_torch.core.ether_on.EtherONDriver.transmit` down,
:meth:`~repro_torch.core.ether_on.DockerSSDEndpoint.send_to_host` up): the
driver hands it each sealed frame and delivers whatever comes back —
possibly nothing (drop), the frame plus a stale copy (duplicate), a
bit-flipped *copy* (corruption — the original stays intact for the
retransmit path), frames held back and released later (delay /
reorder).  Node crashes and straggler latency are *scheduled* against
the injector's fabric-op clock and surfaced through callbacks, so the
pool's heartbeat/suspect machinery reacts to them exactly as it would
to a real failure.

The port's copy of ``repro.core.faults``: the same plans, the same PCG64
draws in the same fabric-op order, so a plan injects the same faults on
either package.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

#: frame travel directions at the fabric boundary
DOWN = "down"          # host -> SSD (0xE0 transmit)
UP = "up"              # SSD -> host (0xE1 upcall)


@dataclasses.dataclass
class FaultPlan:
    """Declarative, replayable chaos schedule.

    Probabilities are per fabric frame (evaluated in deterministic
    fabric-op order from ``seed``); ``crashes`` and ``stragglers``
    are scheduled against the injector's op clock — the count of
    frames that have crossed the boundary — so a plan replays
    identically regardless of wall-clock.

    * ``p_drop`` — frame vanishes (sender retransmits on timeout).
    * ``p_corrupt`` — one payload byte flips on a *copy* of the frame
      (CRC catches it; receiver NACKs; sender retransmits the intact
      original).
    * ``p_dup`` — the frame arrives twice (receiver dedups by seq).
    * ``p_delay`` — the frame is held back and released after the next
      ``delay_ops`` same-flow frames (``delay_ops=1`` is an adjacent
      reorder).
    * ``crashes`` — ``{ip: op_clock}``: node ``ip`` dies once the op
      clock reaches that tick.
    * ``stragglers`` — ``{ip: latency_multiplier}``: every frame
      touching ``ip`` pays ``x`` the normal fabric latency (surfaced
      via ``on_latency`` so the pool's EMA/suspect detection sees it).
      The wildcard key ``"*"`` applies to every node — it lets a plan
      written before the pool's ips exist (a preset, a CLI flag, the
      chaos-during-drain suite) slow the whole fabric down.
    """
    seed: int = 0
    p_drop: float = 0.0
    p_corrupt: float = 0.0
    p_dup: float = 0.0
    p_delay: float = 0.0
    delay_ops: int = 1
    crashes: Dict[str, int] = dataclasses.field(default_factory=dict)
    stragglers: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        for name in ("p_drop", "p_corrupt", "p_dup", "p_delay"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if self.delay_ops < 1:
            raise ValueError(f"delay_ops must be >= 1, got "
                             f"{self.delay_ops}")

    # -- JSON round trip (the --fault-plan file format) ----------------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls(**json.loads(text))

    @property
    def lossy(self) -> bool:
        return (self.p_drop > 0 or self.p_corrupt > 0 or
                self.p_dup > 0 or self.p_delay > 0)


class FaultInjectorStats:
    """What the injector actually did (the ground truth the delivery
    counters in ``EtherONStats`` are checked against)."""

    def __init__(self):
        self.frames_seen = 0
        self.dropped = 0
        self.corrupted = 0
        self.duplicated = 0
        self.delayed = 0
        self.crashed_nodes: List[str] = []

    def as_dict(self) -> Dict[str, object]:
        return dict(vars(self))


class FaultInjector:
    """Seeded fault source wrapping the Ether-oN fabric boundary.

    The driver calls :meth:`transit` for every frame crossing the
    boundary and delivers exactly the frames it returns, in order.
    Randomness comes from one PCG64 generator consumed in fabric-op
    order, so a run is a pure function of (plan, traffic) — replaying
    the same workload under the same plan injects the same faults at
    the same frames.

    ``on_crash(ip)`` fires (once per ip) when the op clock crosses a
    scheduled crash tick; ``on_latency(ip, mult)`` fires for every
    frame touching a straggler node.  Both are wired up by
    ``StoragePool.attach_faults``.
    """

    def __init__(self, plan: FaultPlan,
                 on_crash: Optional[Callable[[str], None]] = None,
                 on_latency: Optional[Callable[[str, float],
                                              None]] = None):
        self.plan = plan
        self.on_crash = on_crash
        self.on_latency = on_latency
        self.stats = FaultInjectorStats()
        self._rng = np.random.Generator(np.random.PCG64(plan.seed))
        self._ops = 0
        self._crashed: set = set()
        # held-back frames per (direction, ip) flow: (release_op, frame)
        self._held: Dict[Tuple[str, str], List[Tuple[int, object]]] = {}

    # -- op clock / scheduled events -----------------------------------------

    @property
    def op_clock(self) -> int:
        return self._ops

    def _tick(self, ip: str):
        self._ops += 1
        for cip, when in self.plan.crashes.items():
            if self._ops >= int(when) and cip not in self._crashed:
                self._crashed.add(cip)
                self.stats.crashed_nodes.append(cip)
                if self.on_crash is not None:
                    self.on_crash(cip)
        mult = self.plan.stragglers.get(ip, self.plan.stragglers.get("*"))
        if mult is not None and self.on_latency is not None:
            self.on_latency(ip, float(mult))

    def latency_mult(self, ip: str) -> float:
        """Straggler multiplier for fabric ops touching ``ip`` (the
        ``"*"`` wildcard slows every node)."""
        return float(self.plan.stragglers.get(
            ip, self.plan.stragglers.get("*", 1.0)))

    def node_crashed(self, ip: str) -> bool:
        return ip in self._crashed

    # -- the boundary hook ---------------------------------------------------

    def _corrupt_copy(self, frame):
        """Bit-flip one payload byte on a COPY — the sender's original
        must stay intact or the retransmit would resend the damage."""
        payload = bytearray(frame.payload)
        if payload:
            i = int(self._rng.integers(len(payload)))
            payload[i] ^= 0xFF
        bad = dataclasses.replace(frame, payload=bytes(payload))
        # keep the ORIGINAL checksum: the whole point is a payload that
        # no longer matches its CRC
        bad.checksum = frame.checksum
        return bad

    def transit(self, frame, direction: str, ip: str) -> List:
        """One frame crossing the boundary.  Returns the frames to
        deliver (possibly none, possibly with copies or released
        held-back frames), in delivery order."""
        self._tick(ip)
        self.stats.frames_seen += 1
        key = (direction, ip)
        out: List = []
        # release any held frames whose tick has come (same flow only —
        # a delayed frame must rejoin its own reassembly stream)
        held = self._held.get(key, [])
        due = [f for when, f in held if when <= self._ops]
        self._held[key] = [(w, f) for w, f in held if w > self._ops]

        p = self.plan
        r = self._rng.random(4)
        if r[0] < p.p_drop:
            self.stats.dropped += 1
            return out + due
        if r[1] < p.p_corrupt:
            self.stats.corrupted += 1
            out.append(self._corrupt_copy(frame))
            return out + due
        if r[3] < p.p_delay:
            self.stats.delayed += 1
            self._held.setdefault(key, []).append(
                (self._ops + int(p.delay_ops), frame))
            return out + due
        out.append(frame)
        if r[2] < p.p_dup:
            self.stats.duplicated += 1
            out.append(frame)         # same object: receiver dedups it
        return out + due


#: canned plans for the chaos suite / --fault-plan presets
PRESET_PLANS: Dict[str, FaultPlan] = {
    "none": FaultPlan(),
    "lossy": FaultPlan(seed=7, p_drop=0.08, p_corrupt=0.05, p_dup=0.06,
                       p_delay=0.06, delay_ops=2),
    "storm": FaultPlan(seed=13, p_drop=0.2, p_corrupt=0.12, p_dup=0.1,
                       p_delay=0.1, delay_ops=3),
}


def load_plan(spec: str) -> FaultPlan:
    """Resolve a ``--fault-plan`` argument: a preset name, a path to a
    JSON plan file, or inline JSON."""
    if spec in PRESET_PLANS:
        return PRESET_PLANS[spec]
    if spec.lstrip().startswith("{"):
        return FaultPlan.from_json(spec)
    with open(spec) as f:
        return FaultPlan.from_json(f.read())
