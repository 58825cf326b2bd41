"""Computing-enabled storage pool — DockerSSD disaggregation.

Each DockerSSD (Ether-oN IP + Virtual-FW + mini-docker + λFS) is an
independent node; nodes form an *array* behind a PCIe switch, arrays
form a *cluster* behind a switch tray (Fig 8a).  The pool orchestrates
containers across nodes (docker-compose/Kubernetes-style), supports
the two offloading modes from the paper (independent apps per node vs
one distributed job spanning nodes), and provides the fleet features a
1000+-node deployment needs: heartbeats, failure detection and
container rescheduling, straggler re-replication, elastic membership.

The port of ``repro.core.storage_pool``, frame for frame: the Ether-oN
data plane (JOB/READ/docker frames), membership and container
scheduling, the seeded fault injector's wiring, and the pool-serving
frontend over a ``runtime.pool.PoolServer``, whose nodes are windows of
one page store on one card (node ``s`` backs the server's shard ``s``).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.container import MiniDocker, to_jsonable
from repro_torch.core.ether_on import (DockerSSDEndpoint, EtherONDriver,
                                       EtherONError)
from repro_torch.core.extent_store import ANALYTICS_IMAGE, ExtentStore
from repro_torch.core.faults import FaultInjector, FaultPlan
from repro_torch.core.lambda_fs import SHARABLE_NS, LambdaFS
from repro_torch.core.virtual_fw import VirtualFW


@dataclasses.dataclass
class NodeSpec:
    ghz: float = 2.2
    cores: int = 6
    dram_gb: float = 2.0
    flash_gb: float = 400.0
    channels: int = 12


class DockerSSDNode:
    """One disaggregated computational SSD."""

    def __init__(self, ip: str, spec: Optional[NodeSpec] = None,
                 extent_cfg: Optional[Dict[str, int]] = None):
        self.ip = ip
        # default must be constructed per node: a shared NodeSpec instance
        # would alias every node's spec, so mutating one (e.g. a degraded
        # channel count) would silently change the whole pool
        spec = spec if spec is not None else NodeSpec()
        self.spec = spec
        self.fs = LambdaFS(capacity_bytes=int(spec.flash_gb * 1e9))
        self.endpoint = DockerSSDEndpoint(ip)
        self.fw = VirtualFW(self.fs, self.endpoint)
        # flash-resident analytics pages, addressed by the scan kernel
        self.extents = ExtentStore(**(extent_cfg or {}))
        self.docker = MiniDocker(self.fw, self.fs, extents=self.extents)
        # λFS lock syncs ride the pool's Ether-oN driver
        self.alive = True
        # straggler != dead: a suspect node keeps its sequences and
        # extents but receives no NEW placements until it clears
        self.suspect = False
        self.last_heartbeat = 0.0
        self.latency_ema_ms = 1.0
        self.serving_log: List[Tuple[str, int]] = []
        self.endpoint.set_handler(self._on_frame)

    def _on_frame(self, frame):
        """HTTP-over-Ether-oN: docker-cli requests land here; serving
        control messages (``SERVE <verb> <seq>``) are logged by the
        node's serving agent and acknowledged over the upcall path;
        ``JOB``/``READ`` frames are the analytics data plane."""
        # requests with a body (e.g. an image blob for pull) carry it
        # after a blank line, HTTP-style
        head, _, body = frame.payload.partition(b"\n\n")
        req = head.decode(errors="replace")
        if req.startswith("SERVE "):
            parts = req.split()
            verb, seq_id = parts[1], int(parts[2])
            self.serving_log.append((verb, seq_id))
            return f"ACK {verb} {seq_id}".encode()
        if req.startswith("JOB "):
            return self._run_jobs(frame.payload[4:])
        if req.startswith("READ "):
            return self._read_extent(req[5:].strip())
        if req.startswith(("GET ", "POST ", "DELETE ")):
            return self.docker.handle_http(req, body)
        return None

    # -- analytics data plane (device side) -------------------------------------

    def _run_jobs(self, raw: bytes) -> bytes:
        """One batched JOB frame -> one container run -> one RESULTS
        response carrying only the reduced aggregates.

        The D-VirtFW execution path end to end: call args staged in the
        MPU-checked ISP memory pool, job params packaged into the
        container's λFS rootfs via function-call syscalls (no
        Kernel-ctx), then the scan or top-k kernel over the node's
        extent pages."""
        job_pages = None
        try:
            # args into the ISP pool (page-granular, user-mode — Fig 6)
            job_pages = self.fw.stage_job(raw)
            cid = self.docker.cmd_create(ANALYTICS_IMAGE)
            # rootfs-packaged params through the I/O handler's syscalls
            fd = self.fw.syscall("openat",
                                 f"/containers/{cid}/rootfs/job.json")
            self.fw.syscall("write", fd, raw)
            self.fw.syscall("close", fd)
            results = self.docker.cmd_start(cid, job_pages=job_pages)
            body = json.dumps(to_jsonable(results)).encode()
            # batch retired: reclaim the container (a failed one stays
            # around dead/exited for `docker logs` debugging)
            self.docker.cmd_rm(cid)
        except Exception as e:
            body = json.dumps({"error": f"{type(e).__name__}: {e}"}).encode()
        finally:
            if job_pages is not None:
                self.fw.free_job(job_pages)     # ISP pool is finite
        return b"RESULTS %d\n" % len(body) + body

    def _read_extent(self, name: str) -> bytes:
        """Host-reads-everything: ship the whole extent back (the
        baseline traffic the in-storage reduce eliminates).  A
        quantized pool ships its stored codes plus the per-row f32
        scales — never an inflated f32 copy — so the wire pays the
        quantized byte count and the host dequantizes at the far end."""
        if name not in self.extents.extents:
            hdr = json.dumps({"error": f"no extent {name!r}"}).encode()
            body = hdr + b"\n"
        elif self.extents.quantized:
            codes, scales = self.extents.raw_extent(name)
            # fp8 codes travel as their bytes, named as the JAX package
            # names them
            hdr = json.dumps({"rows": codes.shape[0],
                              "cols": codes.shape[1],
                              "dtype": self.extents.code_name,
                              "qscale": True}).encode()
            body = (hdr + b"\n" + np.ascontiguousarray(codes).tobytes() +
                    np.ascontiguousarray(scales).tobytes())
        else:
            arr = self.extents.get(name)
            hdr = json.dumps({"rows": arr.shape[0], "cols": arr.shape[1],
                              "dtype": str(arr.dtype)}).encode()
            body = hdr + b"\n" + np.ascontiguousarray(arr).tobytes()
        return b"EXTENT %d\n" % len(body) + body

    def ingest_extent(self, name: str, path: str, n_cols: int,
                      dtype=np.float32) -> Tuple[int, int]:
        """Move a sharable-NS file the host placed into flash extent
        pages, through the I/O handler (counted, costed syscalls)."""
        fd = self.fw.syscall("openat", path, SHARABLE_NS)
        raw = self.fw.syscall("read", fd)
        self.fw.syscall("close", fd)
        arr = np.frombuffer(raw, dtype).reshape(-1, n_cols)
        self.extents.put(name, arr)
        return arr.shape

    def heartbeat(self, now: float) -> bool:
        if self.alive:
            self.last_heartbeat = now
        return self.alive

    def fail(self):
        self.alive = False
        # the fabric endpoint dies with the node: in-flight deliveries
        # time out and the driver's bounded retransmit gives up
        self.endpoint.alive = False

    def recover(self):
        self.alive = True
        self.endpoint.alive = True
        self.suspect = False


@dataclasses.dataclass
class Placement:
    """A distributed job's shard assignment (the pool-level DP/TP/PP of
    the paper's Fig 8b)."""
    job: str
    node_ips: List[str]
    dp: int = 1
    tp: int = 1
    pp: int = 1
    stage_of: Dict[str, int] = dataclasses.field(default_factory=dict)


class StoragePool:
    """Array/cluster of DockerSSDs with a docker-compose-like scheduler."""

    def __init__(self, n_nodes: int, host_ip: str = "10.0.0.1",
                 spec: Optional[NodeSpec] = None, array_size: int = 16,
                 heartbeat_timeout: float = 3.0,
                 straggler_factor: float = 3.0,
                 extent_cfg: Optional[Dict[str, int]] = None):
        self.driver = EtherONDriver(host_ip)
        self.nodes: Dict[str, DockerSSDNode] = {}
        self.arrays: List[List[str]] = []
        self.array_size = array_size
        self.heartbeat_timeout = heartbeat_timeout
        self.straggler_factor = straggler_factor
        self.extent_cfg = extent_cfg
        self.placements: Dict[str, Placement] = {}
        self.events: List[Tuple[str, str]] = []
        self.fault_injector = None
        # pool-serving frontend state (attach_server)
        self._server = None
        self._serve_job: Optional[str] = None
        self._requeue: List[int] = []
        for i in range(n_nodes):
            self._add_node(i, spec)

    # -- chaos wiring ---------------------------------------------------------

    def attach_faults(self, plan_or_injector) -> "FaultInjector":
        """Put a seeded fault injector on the pool's fabric boundary.

        Scheduled crashes fail the node and run serving/container
        failover immediately (deterministic — no dependence on
        heartbeat wall-clock); straggler latency feeds each node's
        latency EMA so the heartbeat sweep flips it to *suspect*."""
        if isinstance(plan_or_injector, FaultPlan):
            inj = FaultInjector(plan_or_injector)
        else:
            inj = plan_or_injector

        def _crash(ip: str):
            node = self.nodes.get(ip)
            if node is None or not node.alive:
                return
            node.fail()
            self.events.append(("fault-crash", ip))
            self._serve_failover(ip)
            self._reschedule_off(ip)

        def _lat(ip: str, mult: float):
            node = self.nodes.get(ip)
            if node is not None:
                # nominal fabric latency is ~1 ms; a straggler pays
                # mult x, so the EMA converges toward mult
                node.latency_ema_ms = (0.8 * node.latency_ema_ms +
                                       0.2 * float(mult))

        inj.on_crash = _crash
        inj.on_latency = _lat
        self.fault_injector = inj
        self.driver.attach_faults(inj)
        return inj

    # -- membership -----------------------------------------------------------

    def alive_nodes(self) -> List[str]:
        return [ip for ip, n in self.nodes.items() if n.alive]

    def check_heartbeats(self, now: Optional[float] = None) -> List[str]:
        """Returns newly-dead node ips and reschedules their containers."""
        now = time.monotonic() if now is None else now
        dead = []
        for ip, node in self.nodes.items():
            if not node.heartbeat(now) and \
                    now - node.last_heartbeat > self.heartbeat_timeout:
                dead.append(ip)
        for ip in dead:
            # serving failover first: the shard index must be read from
            # the serving placement before _reschedule_off rewires it
            self._serve_failover(ip)
            self._reschedule_off(ip)
        # suspect sweep: stragglers are *degraded*, not dead — existing
        # work stays, new placements steer away until the EMA clears
        slow = set(self.stragglers())
        for ip, node in self.nodes.items():
            was = node.suspect
            node.suspect = node.alive and ip in slow
            if node.suspect and not was:
                self.events.append(("suspect", ip))
            elif was and not node.suspect:
                self.events.append(("suspect-cleared", ip))
        return dead

    def suspect_nodes(self) -> List[str]:
        return [ip for ip, n in self.nodes.items() if n.suspect]

    def mark_unreachable(self, ip: str):
        """Delivery to ``ip`` exhausted the fabric's retransmit budget:
        treat the node as dead *now* — run serving/container failover —
        instead of waiting for the heartbeat sweep to notice."""
        node = self.nodes.get(ip)
        if node is not None and node.alive:
            node.fail()
            self.events.append(("unreachable", ip))
        self._serve_failover(ip)
        self._reschedule_off(ip)

    def stragglers(self) -> List[str]:
        alive = [self.nodes[ip] for ip in self.alive_nodes()]
        if not alive:
            return []
        med = sorted(n.latency_ema_ms for n in alive)[len(alive) // 2]
        return [n.ip for n in alive
                if n.latency_ema_ms > self.straggler_factor * max(med, 1e-6)]

    # -- image distribution / scheduling ----------------------------------------

    def broadcast_pull(self, name: str, blob: bytes, ips=None):
        for ip in (ips or self.alive_nodes()):
            self.nodes[ip].docker.cmd_pull(name, blob)

    def locate_extent(self, name: str) -> Optional[str]:
        """IP of the alive node whose flash holds extent ``name`` (data
        placement is the scheduling input of the offload planner).
        Prefers a non-suspect replica when one exists."""
        hits = self.locate_replicas(name)
        good = [ip for ip in hits if not self.nodes[ip].suspect]
        return (good or hits)[0] if hits else None

    def locate_replicas(self, name: str) -> List[str]:
        """Every alive node holding extent ``name`` — the retry set for
        a job whose first delivery attempt lost its node."""
        return [ip for ip in self.alive_nodes()
                if name in self.nodes[ip].extents.extents]

    def place_distributed(self, job: str, image: str, *, dp: int = 1,
                          tp: int = 1, pp: int = 1) -> Placement:
        """Group nodes into one distributed system (the paper's preferred
        mode).  Needs dp*tp*pp healthy nodes; stage id = pipeline stage."""
        need = dp * tp * pp
        avail = [ip for ip in self.alive_nodes()
                 if ip not in self._occupied()]
        if len(avail) < need:
            raise RuntimeError(f"pool has {len(avail)} free nodes; "
                               f"need {need}")
        chosen = avail[:need]
        pl = Placement(job=job, node_ips=chosen, dp=dp, tp=tp, pp=pp)
        for i, ip in enumerate(chosen):
            pl.stage_of[ip] = (i // (dp * tp)) % pp
        self.placements[job] = pl
        self.events.append(("place", job))
        return pl

    def place_independent(self, job: str, image: str, n: int) -> Placement:
        """Mode 1: independent app instances across nodes."""
        avail = [ip for ip in self.alive_nodes()
                 if ip not in self._occupied()][:n]
        pl = Placement(job=job, node_ips=avail)
        self.placements[job] = pl
        return pl

    def run_on(self, job: str, fn: Callable[[DockerSSDNode, int], Any]):
        """Execute fn(node, rank) over a placement's nodes; EMA latency."""
        pl = self.placements[job]
        out = []
        for rank, ip in enumerate(pl.node_ips):
            node = self.nodes[ip]
            if not node.alive:
                raise RuntimeError(f"node {ip} died mid-job")
            t0 = time.monotonic()
            out.append(fn(node, rank))
            dt = (time.monotonic() - t0) * 1e3
            node.latency_ema_ms = 0.8 * node.latency_ema_ms + 0.2 * dt
        return out

    # -- pool-serving frontend -------------------------------------------------
    #
    # One request flows: frontend (here) -> Ether-oN control frame to the
    # chosen DockerSSD -> PoolServer admission on that node's shard ->
    # the pool decode step.  Only control messages ride frames; token-rate
    # tensor traffic stays on the device, where the nodes' attention
    # partials are merged (DESIGN.md §Pool serving).

    def attach_server(self, server, job: str = "llm-serve") -> Placement:
        """Bind a ``runtime.pool.PoolServer`` to this pool: each fabric
        node in the serving placement backs one server shard.  Needs one
        free healthy node per *active* shard (an elastic server's
        parked shards may start unbacked — ``scale_to`` /
        ``grow_serving`` wire nodes to them later).  Spare free nodes
        back parked shards eagerly, so a later join is pure
        activation."""
        active = server.alive_nodes()
        free = [ip for ip in self.alive_nodes()
                if ip not in self._occupied()]
        k = max(len(active), min(server.n_nodes, len(free)))
        pl = self.place_distributed(job, "llm-serve", tp=k)
        self._server = server
        self._serve_job = job
        # stable shard-indexed ip map: container rescheduling may rewire
        # the *placement* after a failure, but server shard i keeps its
        # identity (a lost window is not revived by a restarted
        # container).  Active shards are backed first; None marks a
        # parked shard still waiting for a fabric node.
        self._serve_ips = [None] * server.n_nodes
        for ip, s in zip(pl.node_ips, list(active) + server.parked_nodes()):
            self._serve_ips[s] = ip
        return pl

    def serving_ips(self) -> List[str]:
        return list(self._serve_ips)

    def suspect_shards(self) -> set:
        """Server shard indices currently backed by a suspect node."""
        if self._server is None:
            return set()
        return {i for i, ip in enumerate(self._serve_ips)
                if ip in self.nodes and self.nodes[ip].suspect}

    def _pick_serving_node(self, n_tokens: int) -> int:
        """Least-loaded healthy shard, steering around suspects unless
        every alive shard is suspect (advisory state must never
        deadlock admission)."""
        srv = self._server
        alive = srv.alive_nodes()
        if not alive:
            raise EtherONError("no serving nodes alive")
        sus = self.suspect_shards()
        cand = [s for s in alive if s not in sus] or alive
        return max(cand, key=lambda s: (srv.table.shard_free_pages(s), -s))

    def place_sequence(self, seq_id: int, n_tokens: int,
                       node: Optional[int] = None,
                       prompt=None) -> int:
        """Admit a sequence: choose a node (the node already holding
        ``prompt``'s prefix when one exists, else least-loaded by free
        window pages, unless the router already picked one), announce
        the placement to that node over Ether-oN, and return the shard
        index for ``PoolServer.add_request``/``begin_request``.

        A placement announcement that exhausts the fabric's retransmit
        budget means the chosen node is unreachable — it is failed over
        on the spot and the sequence re-placed on a surviving shard."""
        srv = self._server
        if node is None and prompt is not None:
            node = srv.pick_prefix_node(prompt, n_tokens)
            if node is not None and node in self.suspect_shards() and \
                    set(srv.alive_nodes()) - self.suspect_shards():
                node = None     # warm prefix isn't worth a straggler
        while True:
            if node is None:
                node = self._pick_serving_node(n_tokens)
            try:
                self.driver.send_control(
                    self._serve_ips[node], "place", seq_id,
                    extra=str(srv.pages_needed(n_tokens)))
                self._drain_acks()
                return node
            except EtherONError:
                ip = self._serve_ips[node]
                self.events.append(("place-retry", f"{seq_id}:{ip}"))
                self.mark_unreachable(ip)
                node = None
                if not srv.alive_nodes():
                    raise

    def retire_sequence(self, seq_id: int) -> int:
        """Free a finished sequence: notify the owning node (every node,
        for a striped extent) over Ether-oN, then release its pages in
        both tiers through the server's public API."""
        srv = self._server
        owner = srv.node_of(seq_id)
        shards = [owner] if owner is not None else srv.alive_nodes()
        for s in shards:
            if s in srv.alive_nodes():      # no frames to dead nodes
                try:
                    self.driver.send_control(self._serve_ips[s], "free",
                                             seq_id)
                except EtherONError:
                    # the owner died with the free in flight: its pages
                    # died with it — fail it over and fall through to
                    # the (idempotent) server-side release
                    self.mark_unreachable(self._serve_ips[s])
        self._drain_acks()
        return srv.free_sequence(seq_id)

    def serving_tier_stats(self) -> Dict[str, object]:
        """Aggregate serving telemetry: the pool totals plus the
        per-node breakdown (the aggregate is the field-wise sum of the
        nodes — each DockerSSD owns its window and flash tier)."""
        return {"pool": self._server.tier_stats(),
                "nodes": self._server.node_tier_stats()}

    def take_requeued(self) -> List[int]:
        """Sequence ids dropped by node failures since the last call —
        the router re-prefills them on the surviving nodes."""
        out, self._requeue = self._requeue, []
        return out

    def _serve_failover(self, dead_ip: str):
        """Heartbeat-driven serving failover: when a serving node dies,
        its shard's window and tier are lost — drop the sequences homed
        there and queue them for router re-admission."""
        if self._server is None or dead_ip not in self._serve_ips:
            return
        shard = self._serve_ips.index(dead_ip)
        if shard in self._server._dead:
            return                      # already handled (idempotent)
        victims = self._server.fail_node(shard)
        self._requeue.extend(victims)
        self.events.append(("serve-requeue",
                            f"{dead_ip}:{','.join(map(str, victims))}"))

    def _drain_acks(self):
        """Pull control-frame ACKs off the upcall inbox (their cost is
        already accounted by the driver)."""
        while self.driver.poll() is not None:
            pass

    def _occupied(self):
        occ = set()
        for pl in self.placements.values():
            occ.update(pl.node_ips)
        return occ

    def _reschedule_off(self, dead_ip: str):
        """Failure handling: replace a dead node in every placement with a
        free healthy one (container restart on the new node)."""
        for pl in self.placements.values():
            if dead_ip in pl.node_ips:
                free = [ip for ip in self.alive_nodes()
                        if ip not in self._occupied()]
                if not free:
                    self.events.append(("degraded", pl.job))
                    pl.node_ips.remove(dead_ip)
                    continue
                new_ip = free[0]
                idx = pl.node_ips.index(dead_ip)
                pl.node_ips[idx] = new_ip
                pl.stage_of[new_ip] = pl.stage_of.pop(dead_ip, 0)
                self.events.append(("reschedule", f"{pl.job}:{dead_ip}->{new_ip}"))

    # -- elastic membership --------------------------------------------------------

    def _add_node(self, i: int, spec: Optional[NodeSpec]):
        """Provision node ``i``: wired into the Ether-oN fabric, λFS lock
        syncs attached, and slotted into its array (array topology follows
        the pool's configured ``array_size``).  Each node gets its own
        NodeSpec copy — per-node state never aliases across the pool."""
        ip = f"10.0.{1 + i // self.array_size}.{2 + i % self.array_size}"
        node = DockerSSDNode(
            ip, dataclasses.replace(spec) if spec is not None else None,
            extent_cfg=self.extent_cfg)
        node.fs.attach_ether(self.driver)
        self.nodes[ip] = node
        self.driver.attach(node.endpoint)
        if i % self.array_size == 0:
            self.arrays.append([])
        self.arrays[-1].append(ip)
        return node

    def scale_to(self, n: int, spec: Optional[NodeSpec] = None):
        """Grow the fabric to ``n`` nodes.  With a pool server
        attached, every new node must be wired into the shard map (an
        unbacked parked shard, which it backs and activates) — a node
        that could never serve pages is rejected up front rather than
        silently joining the fabric.  Without a server the nodes join
        the fabric plain (analytics pools).  Shrinking is not this
        knob: drain serving nodes with ``drain_serving_node``."""
        cur = len(self.nodes)
        if n < cur:
            raise ValueError(
                f"scale_to grows the fabric (have {cur}, asked {n}); "
                "remove serving nodes with drain_serving_node instead")
        if self._server is not None:
            slots = self._serve_ips.count(None)
            if n - cur > slots:
                raise RuntimeError(
                    f"serving pool has {slots} unbacked shard(s) left "
                    f"(capacity {self._server.n_nodes}, the pow2 bucket "
                    f"sized at startup); scale_to({n}) would attach "
                    f"{n - cur - slots} node(s) that could never serve "
                    "pages — provision a PoolServer with a larger "
                    "n_nodes bucket instead")
        for i in range(cur, n):
            node = self._add_node(i, spec)
            if self._server is not None:
                self._wire_serving_node(node.ip)
        self.events.append(("scale", str(n)))

    def _wire_serving_node(self, ip: str) -> int:
        """Back one unbacked server shard with fabric node ``ip`` and
        activate it (join announced over Ether-oN).  The shard's window
        has existed in the page store since startup."""
        srv = self._server
        shard = self._serve_ips.index(None)
        self._serve_ips[shard] = ip
        pl = self.placements[self._serve_job]
        pl.node_ips.append(ip)
        pl.stage_of[ip] = 0
        self.driver.send_control(ip, "join", shard)
        self._drain_acks()
        srv.activate_node(shard)
        self.events.append(("serve-join", f"{ip}:{shard}"))
        return shard

    def grow_serving(self, n_active: int):
        """Raise the serving set to ``n_active`` nodes: re-activate
        parked shards that kept their backing node, wire free fabric
        nodes to unbacked shards, and only then grow the fabric itself
        (``scale_to``).  Each step is one node — the autoscaler's unit
        of change."""
        srv = self._server
        if srv is None:
            raise RuntimeError("no server attached")
        if n_active > srv.n_nodes:
            raise RuntimeError(
                f"asked for {n_active} serving nodes but the pow2 "
                f"bucket sized at startup holds {srv.n_nodes}; "
                "provision a PoolServer with a larger n_nodes bucket")
        while len(srv.alive_nodes()) < n_active:
            backed = [s for s in srv.parked_nodes()
                      if s not in srv._dead
                      and self._serve_ips[s] is not None
                      and self.nodes[self._serve_ips[s]].alive]
            if backed:
                s = backed[0]
                self.driver.send_control(self._serve_ips[s], "join", s)
                self._drain_acks()
                srv.activate_node(s)
                self.events.append(
                    ("serve-join", f"{self._serve_ips[s]}:{s}"))
                continue
            free = [ip for ip in self.alive_nodes()
                    if ip not in self._occupied()]
            if free:
                self._wire_serving_node(free[0])
            else:
                self.scale_to(len(self.nodes) + 1)

    def drain_serving_node(self, node: int) -> Dict:
        """Zero-drop drain of serving node ``node`` (planned removal —
        the autoscaler's scale-down step).  Announces the drain, then
        walks the server's two-path drain: each warm page move is
        announced to its destination with a MIGRATE frame (reliable
        tunnel — chaos retransmits land in the delivery counters), and
        cold victims enter the requeue list the router already drains
        (PR-2 failover re-prefill), so nothing is shed."""
        srv = self._server
        if srv is None:
            raise RuntimeError("no server attached")
        ip = self._serve_ips[node]
        self.events.append(("serve-drain", f"{ip}:{node}"))
        try:
            self.driver.send_control(ip, "drain", node)
            self._drain_acks()
        except EtherONError:
            # unreachable drainee: the planned drain degenerates into
            # the unplanned-failure path (requeue via failover)
            self.mark_unreachable(ip)
        if node in srv._dead:
            return {"victims": [], "migrated_pages": 0, "cold": [],
                    "moved": {}}
        page_bytes = srv.store.page_bytes()

        def on_migrate(seq_id, page_idx, src, dst):
            dst_ip = self._serve_ips[dst]
            try:
                self.driver.send_migrate(dst_ip, seq_id, page_idx,
                                         page_bytes, src, dst)
            except EtherONError:
                self.mark_unreachable(dst_ip)
                raise

        rep = srv.drain_node(node, on_migrate=on_migrate)
        self._drain_acks()
        self._requeue.extend(rep["cold"])
        return rep
