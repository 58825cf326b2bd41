"""Ether-oN — Ethernet over NVMe.

Faithful control-plane model of the paper's transport: Ethernet frames
are tunneled through two vendor-specific NVMe commands

  * ``0xE0`` **transmit frame** — host -> SSD.  The driver copies the
    sk_buff (headers+payload+checksum) into 4 KiB-aligned kernel pages
    and points the command's PRP list at them.
  * ``0xE1`` **receive frame** — the *asynchronous upcall*: the driver
    pre-posts ``UPCALL_SLOTS`` (=4, the paper's tuned value) receive
    commands per SQ; the SSD completes one whenever an ISP-container
    sends a frame to the host, and the driver immediately re-posts a
    fresh one.  This is how a PCIe device that cannot issue NVMe
    commands nonetheless *initiates* communication.

The event loop is deterministic; per-operation cost accounting feeds
the Fig-3/Fig-11 models.  This layer is the pool's control plane; bulk
tensor traffic stays on the device.

Delivery is **reliable** (DESIGN.md §Fault model): every frame carries
a per-flow sequence number; receivers ACK/NACK synchronously (the NVMe
completion status — a reliable side channel, never a frame of its
own), dedup by seq, and stash out-of-order arrivals until the gap
fills; senders retransmit on timeout with exponential backoff, bounded
by ``max_retries``.  A checksum mismatch is a NACK -> retransmit, not
an exception.  On a fault-free fabric the reliable path is
byte-identical in cost accounting to the historical direct delivery —
retransmit/NACK/dedup counters stay exactly zero.  Faults come only
from an attached :class:`~repro_torch.core.faults.FaultInjector`
(``attach_faults``).

The port's copy of ``repro.core.ether_on``: frames, costs and counters
are the same, byte for byte.  ``fetch_extent`` decodes fp8 codes with
torch's ``float8_e4m3fn`` instead of ``ml_dtypes``.
"""
from __future__ import annotations

import dataclasses
import json
import zlib
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

PAGE = 4096
OPC_TRANSMIT = 0xE0
OPC_RECEIVE = 0xE1
UPCALL_SLOTS = 4      # pre-allocated receive commands per SQ (paper-tuned)
ETH_HEADER = 14
MTU = 1500


class EtherONError(Exception):
    pass


@dataclasses.dataclass
class EthernetFrame:
    src_ip: str
    dst_ip: str
    payload: bytes
    ethertype: int = 0x0800
    checksum: int = 0
    # per-flow delivery sequence number (-1 = unsequenced legacy frame);
    # a header field, so payload corruption never damages it
    seq: int = -1

    def seal(self) -> "EthernetFrame":
        self.checksum = zlib.crc32(self.payload)
        return self

    def verify(self) -> bool:
        return self.checksum == zlib.crc32(self.payload)

    @property
    def wire_bytes(self) -> int:
        return ETH_HEADER + len(self.payload) + 4


@dataclasses.dataclass
class NVMeCommand:
    opcode: int
    cid: int
    sq_id: int
    prp: List[int]                   # page ids of the kernel pages
    n_pages: int
    frame: Optional[EthernetFrame] = None   # contents of those pages
    reception_code: int = 0


@dataclasses.dataclass
class Costs:
    """Per-op latencies (us) — cost accounting for the perf models."""
    doorbell: float = 0.3
    dma_per_page: float = 0.9
    completion_msi: float = 1.2
    page_copy_per_kb: float = 0.08
    # base retransmit timeout; attempt k waits 2^k of these
    retransmit_timeout_us: float = 25.0


#: bounded retries per frame (attempts = max_retries + 1)
MAX_RETRIES = 8


class EtherONStats:
    def __init__(self):
        self.tx_commands = 0
        self.rx_completions = 0
        self.pages_allocated = 0
        self.bytes_tx = 0
        self.bytes_rx = 0
        self.reposts = 0
        self.lock_syncs = 0
        self.control_frames = 0
        self.job_frames = 0          # analytics JOB submissions
        self.result_bytes = 0        # reduced aggregates shipped back
        self.extent_reads = 0        # host-reads-everything fetches
        # reliable-delivery counters — exactly zero on a fault-free
        # fabric (the chaos suite pins both directions of that claim)
        self.retransmits = 0         # timed-out frames resent
        self.nacks = 0               # checksum-mismatch rejections
        self.dup_frames = 0          # receive-side dedup hits
        self.backoff_us = 0.0        # virtual time spent in backoff
        # elastic drain (warm path) — exactly zero on a static pool
        # (the elastic suite pins that): one MIGRATE announcement per
        # page moved device-to-device, plus the moved page bytes
        self.migrate_frames = 0
        self.migrate_bytes = 0
        self.time_us = 0.0


class EtherONDriver:
    """Host-side kernel driver + virtual network adapter."""

    def __init__(self, host_ip: str, costs: Costs = Costs(),
                 max_retries: int = MAX_RETRIES):
        self.host_ip = host_ip
        self.costs = costs
        self.max_retries = max_retries
        self.stats = EtherONStats()
        self._cid = 0
        self._devices: Dict[str, "DockerSSDEndpoint"] = {}
        self._outstanding_rx: Dict[str, Deque[NVMeCommand]] = {}
        self._rx_backlog: Dict[str, Deque[EthernetFrame]] = {}
        self._inbox: Deque[EthernetFrame] = deque()
        self._next_page = 0
        # reliable delivery state: per-destination tx seq, per-source
        # expected upcall seq + reorder stash
        self._tx_seq: Dict[str, int] = {}
        self._up_expected: Dict[str, int] = {}
        self._up_stash: Dict[str, Dict[int, EthernetFrame]] = {}
        #: attached chaos source (core.faults.FaultInjector) or None
        self.faults = None

    # -- device attach / init ------------------------------------------------

    def attach(self, dev: "DockerSSDEndpoint"):
        self._devices[dev.ip] = dev
        dev._driver = self
        self._outstanding_rx[dev.ip] = deque()
        self._rx_backlog[dev.ip] = deque()
        self._tx_seq[dev.ip] = 0
        self._up_expected[dev.ip] = 0
        self._up_stash[dev.ip] = {}
        # kernel init: pre-submit the upcall commands
        for _ in range(UPCALL_SLOTS):
            self._post_receive(dev.ip)

    def attach_faults(self, injector):
        """Wire a fault injector (``transit``/``latency_mult``) onto the
        fabric boundary (None detaches)."""
        self.faults = injector

    def _lat_mult(self, ip: str) -> float:
        """Straggler latency multiplier for fabric ops touching ``ip``."""
        return self.faults.latency_mult(ip) if self.faults is not None \
            else 1.0

    def _alloc_pages(self, nbytes: int) -> List[int]:
        n = max(1, -(-nbytes // PAGE))
        pages = list(range(self._next_page, self._next_page + n))
        self._next_page += n
        self.stats.pages_allocated += n
        return pages

    def _post_receive(self, ip: str):
        self._cid += 1
        cmd = NVMeCommand(OPC_RECEIVE, self._cid, sq_id=0,
                          prp=self._alloc_pages(PAGE), n_pages=1,
                          reception_code=self._cid)
        self._outstanding_rx[ip].append(cmd)
        self.stats.reposts += 1
        self.stats.time_us += self.costs.doorbell

    # -- host -> SSD ----------------------------------------------------------

    def transmit(self, frame: EthernetFrame):
        """Translate an Ethernet frame into a 0xE0 NVMe command and
        deliver it reliably: stop-and-wait per destination — each
        attempt pays the full command cost; an unacked attempt pays an
        exponentially-backed-off timeout and retransmits, bounded by
        ``max_retries``.  On a fault-free fabric attempt 0 acks and the
        accounting is byte-identical to unconditional delivery."""
        if frame.dst_ip not in self._devices:
            raise EtherONError(f"no route to {frame.dst_ip}")
        frame.seal()
        seq = self._tx_seq[frame.dst_ip]
        self._tx_seq[frame.dst_ip] = seq + 1
        frame.seq = seq
        dev = self._devices[frame.dst_ip]
        c = self.costs
        mult = self._lat_mult(frame.dst_ip)
        for attempt in range(self.max_retries + 1):
            pages = self._alloc_pages(frame.wire_bytes)
            self._cid += 1
            cmd = NVMeCommand(OPC_TRANSMIT, self._cid, sq_id=0, prp=pages,
                              n_pages=len(pages), frame=frame)
            self.stats.tx_commands += 1
            self.stats.bytes_tx += frame.wire_bytes
            self.stats.time_us += mult * (
                c.page_copy_per_kb * frame.wire_bytes / 1024 +
                c.doorbell + c.dma_per_page * len(pages) +
                c.completion_msi)
            if self._deliver_transmit(dev, cmd):
                return
            # timeout: exponential backoff before the retransmit
            self.stats.retransmits += 1
            wait = c.retransmit_timeout_us * (1 << attempt)
            self.stats.backoff_us += wait
            self.stats.time_us += wait
        raise EtherONError(
            f"delivery to {frame.dst_ip} failed after "
            f"{self.max_retries + 1} attempts (seq {seq}): node down "
            f"or fabric dropping every copy")

    def _deliver_transmit(self, dev: "DockerSSDEndpoint",
                          cmd: NVMeCommand) -> bool:
        """One delivery attempt through the (possibly faulty) fabric.
        Returns True when the destination acked OUR sequence number —
        released held frames and stale duplicates resolve to dup-acks
        that never complete the current command."""
        frame = cmd.frame
        if self.faults is not None:
            delivery = self.faults.transit(frame, "down", dev.ip)
        else:
            delivery = [frame]
        if not dev.alive:
            # a dead node consumes nothing and acks nothing; released
            # held frames die with it
            return False
        acked = False
        for f in delivery:
            fc = cmd if f is frame else NVMeCommand(
                OPC_TRANSMIT, cmd.cid, sq_id=0, prp=cmd.prp,
                n_pages=cmd.n_pages, frame=f)
            status = dev._receive_from_host(fc)
            if status == "nack":
                self.stats.nacks += 1
                continue
            if status == "dup":
                self.stats.dup_frames += 1
            if f.seq == frame.seq and status in ("ack", "dup"):
                acked = True
        return acked

    # -- serving control plane -------------------------------------------------

    def send_control(self, dst_ip: str, verb: str, seq_id: int,
                     extra: str = ""):
        """Pool-serving control message (``SERVE place|free|... <seq>``).

        Admission, placement and free notifications ride the same
        0xE0/0xE1 tunnel as every other frame — and pay the same
        per-operation costs — so the analytical model's traffic terms
        (``core.analytical.control_plane_terms``) see the serving
        control plane exactly as Fig 3 sees the docker-cli one.  Bulk
        tensor traffic never comes through here; it stays on the device
        (DESIGN.md §Pool serving)."""
        payload = f"SERVE {verb} {seq_id} {extra}".rstrip().encode()
        self.stats.control_frames += 1
        self.transmit(EthernetFrame(self.host_ip, dst_ip, payload))

    def send_migrate(self, dst_ip: str, seq_id: int, page_idx: int,
                     nbytes: int, src_node: int, dst_node: int):
        """Warm-path page-migration announcement (elastic drain).

        One ``SERVE migrate`` frame per moved page tells the receiving
        node a page of ``seq_id`` now lives in its window.  The frame
        rides the reliable tunnel (ack'd, CRC-checked, retried with
        backoff), so under chaos its retransmits land in the same
        delivery counters as every other frame.  The page payload
        itself never crosses the host fabric — it moves
        device-to-device (``PageStore.copy_page``) — but the moved
        bytes are accounted here (``migrate_bytes`` + the per-kb copy
        cost) so ``analytical.migration_terms`` can price a drain."""
        self.stats.migrate_frames += 1
        self.stats.migrate_bytes += int(nbytes)
        self.stats.time_us += self.costs.page_copy_per_kb * (nbytes / 1024.0)
        payload = (f"SERVE migrate {seq_id} "
                   f"{page_idx}:{src_node}>{dst_node}:{nbytes}").encode()
        self.transmit(EthernetFrame(self.host_ip, dst_ip, payload))

    # -- analytics data plane ---------------------------------------------------
    #
    # Job and result frames ride the same 0xE0/0xE1 tunnel as docker-cli
    # traffic and pay the same per-operation costs.  Responses larger
    # than one MTU are length-framed (``<TAG> <nbytes>\n<body>``) and
    # reassembled from consecutive upcall frames — the event loop is
    # synchronous, so a response's chunks arrive back to back.

    def submit_jobs(self, dst_ip: str, jobs: List[dict]) -> List[dict]:
        """Ship a batch of analytics programs to one node; return the
        decoded per-job results (tagged-hex ndarrays stay encoded — the
        caller decodes with ``container.from_jsonable``)."""
        payload = b"JOB " + json.dumps(jobs).encode()
        self.stats.job_frames += 1
        self.transmit(EthernetFrame(self.host_ip, dst_ip, payload))
        body = self._collect_response(b"RESULTS ")
        self.stats.result_bytes += len(body)
        out = json.loads(body)
        if isinstance(out, dict) and "error" in out:
            raise EtherONError(f"node {dst_ip} rejected jobs: "
                               f"{out['error']}")
        return out

    def fetch_extent(self, dst_ip: str, name: str):
        """The host baseline: read a whole extent back over the tunnel
        (every byte pays frame costs — the traffic ISP offload avoids).
        A quantized extent (``qscale`` in the header) arrives as codes
        followed by per-row f32 scales; the host dequantizes here with
        the kernel's elementwise f32 multiply (``codes.float() *
        scale``), so the wire carried only the quantized bytes.  fp8
        codes (header dtype ``float8_e4m3fn``) are read as bytes and
        viewed as ``torch.float8_e4m3fn``.  Returns [rows, cols]
        float32 numpy."""
        import numpy as np
        import torch
        self.stats.extent_reads += 1
        self.transmit(EthernetFrame(self.host_ip, dst_ip,
                                    b"READ " + name.encode()))
        body = self._collect_response(b"EXTENT ")
        header, _, raw = body.partition(b"\n")
        meta = json.loads(header)
        if "error" in meta:
            raise EtherONError(f"node {dst_ip}: {meta['error']}")
        rows, cols = meta["rows"], meta["cols"]
        fp8 = meta["dtype"] == "float8_e4m3fn"
        dt = np.dtype(np.uint8 if fp8 else meta["dtype"])
        nb = rows * cols * dt.itemsize
        codes = np.frombuffer(raw[:nb], dt).reshape(rows, cols)
        if not meta.get("qscale"):
            return codes.copy()
        codes = torch.from_numpy(codes.copy())
        if fp8:
            codes = codes.view(torch.float8_e4m3fn)
        scales = torch.from_numpy(
            np.frombuffer(raw[nb:nb + rows * 4], np.float32).copy())
        return (codes.float() * scales[:, None]).numpy()

    def _collect_response(self, tag: bytes) -> bytes:
        frame = self.poll()
        skipped = 0
        # stale chunks from abandoned responses (e.g. a logs read the
        # client polled only once) must not poison the next request
        while frame is not None and not frame.payload.startswith(tag):
            skipped += 1
            frame = self.poll()
        if frame is None:
            raise EtherONError(
                f"no {tag!r} response on the upcall inbox "
                f"(skipped {skipped} stale frames)")
        header, _, rest = frame.payload.partition(b"\n")
        n = int(header[len(tag):])
        buf = bytearray(rest)
        while len(buf) < n:
            frame = self.poll()
            if frame is None:
                raise EtherONError(f"truncated {tag!r} response: "
                                   f"{len(buf)}/{n} bytes")
            buf += frame.payload
        return bytes(buf[:n])

    # -- SSD -> host (upcall path) ---------------------------------------------

    def _deliver_upcall(self, ip: str, frame: EthernetFrame) -> str:
        """One SSD->host delivery attempt through the (possibly faulty)
        fabric.  Returns the receive status for ``frame``'s own seq —
        "ack" (consumed or stashed), "nack" (checksum mismatch), "dup"
        (already have it), or "lost" (dropped/held in flight) — the
        reliable completion-status side channel the device's retransmit
        loop keys on."""
        if self.faults is not None:
            delivery = self.faults.transit(frame, "up", ip)
        else:
            delivery = [frame]
        status = "lost"
        for f in delivery:
            st = self._upcall_rx(ip, f)
            if f.seq == frame.seq and status != "ack":
                status = st
        return status

    def _upcall_rx(self, ip: str, frame: EthernetFrame) -> str:
        """Receive-side delivery state machine: CRC check -> NACK,
        seq dedup, reorder stash, in-order release into the upcall
        consume path."""
        if not frame.verify():
            self.stats.nacks += 1
            return "nack"
        if frame.seq < 0:               # unsequenced legacy frame
            self._upcall(ip, frame)
            return "ack"
        exp = self._up_expected[ip]
        if frame.seq < exp:
            self.stats.dup_frames += 1
            return "dup"
        stash = self._up_stash[ip]
        if frame.seq > exp:
            if frame.seq in stash:
                self.stats.dup_frames += 1
                return "dup"
            # out of order: hold (acked — received, just early) until
            # the gap fills, so reassembly never sees a reordering
            stash[frame.seq] = frame
            return "ack"
        self._up_expected[ip] = exp + 1
        self._upcall(ip, frame)
        while self._up_expected[ip] in stash:
            nxt = stash.pop(self._up_expected[ip])
            self._up_expected[ip] += 1
            self._upcall(ip, nxt)
        return "ack"

    def _upcall(self, ip: str, frame: EthernetFrame):
        """Device completes an outstanding 0xE1 command."""
        q = self._outstanding_rx[ip]
        if not q:
            # all slots in flight: device-side backpressure queue
            self._rx_backlog[ip].append(frame)
            return
        cmd = q.popleft()
        assert cmd.opcode == OPC_RECEIVE
        if not frame.verify():
            raise EtherONError("checksum mismatch on upcall frame")
        c = self.costs
        self.stats.rx_completions += 1
        self.stats.bytes_rx += frame.wire_bytes
        self.stats.time_us += self._lat_mult(ip) * (
            c.dma_per_page * cmd.n_pages + c.completion_msi +
            c.page_copy_per_kb * frame.wire_bytes / 1024)
        self._inbox.append(frame)
        # immediately re-post to keep communication alive
        self._post_receive(ip)
        if self._rx_backlog[ip]:
            self._upcall(ip, self._rx_backlog[ip].popleft())

    def poll(self) -> Optional[EthernetFrame]:
        return self._inbox.popleft() if self._inbox else None

    def outstanding_slots(self, ip: str) -> int:
        return len(self._outstanding_rx[ip])

    # λFS inode-lock synchronization rides Ether-oN as a special packet
    def send_lock_sync(self, path: str, refcount: int, holder):
        self.stats.lock_syncs += 1
        self.stats.time_us += self.costs.doorbell + self.costs.completion_msi


class DockerSSDEndpoint:
    """Device-side Ether-oN terminus: owns an IP, hands frames to the
    Virtual-FW network handler, sends responses via the upcall path."""

    def __init__(self, ip: str):
        self.ip = ip
        self._driver: Optional[EtherONDriver] = None
        self._handler: Optional[Callable[[EthernetFrame], Optional[bytes]]] = None
        self.rx_frames = 0
        #: fabric-level liveness: a dead endpoint consumes nothing and
        #: acks nothing (DockerSSDNode.fail/recover toggles this)
        self.alive = True
        # reliable delivery state
        self._rx_expected = 0           # next host->SSD seq to process
        self._up_seq = 0                # next SSD->host seq to assign

    def set_handler(self, fn: Callable[[EthernetFrame], Optional[bytes]]):
        self._handler = fn

    def _receive_from_host(self, cmd: NVMeCommand) -> str:
        """Process one 0xE0 command; the return value is the NVMe
        completion status the driver's retransmit loop keys on: "ack"
        (processed), "nack" (checksum mismatch — retransmit), "dup"
        (already processed — acked without re-running side effects)."""
        assert cmd.opcode == OPC_TRANSMIT
        frame = cmd.frame
        if not frame.verify():
            return "nack"               # NACK -> driver retransmits
        if frame.seq >= 0:
            if frame.seq < self._rx_expected:
                return "dup"
            # stop-and-wait sender: a gap means the sender gave up on
            # that seq (and told its caller) — accept and advance
            self._rx_expected = frame.seq + 1
        self.rx_frames += 1
        if self._handler is not None:
            resp = self._handler(frame)
            if resp is not None:
                self.send_to_host(resp, dst_ip=frame.src_ip)
        return "ack"

    def send_to_host(self, payload: bytes, dst_ip: str):
        """ISP-container initiated traffic — possibly multiple MTU
        frames, delivered reliably: the whole burst goes out pipelined,
        then unacked frames retransmit in bounded exponential-backoff
        rounds (the receive side dedups and reorders by seq, so
        reassembly survives any loss/duplication/reordering mix)."""
        frames = []
        for off in range(0, max(len(payload), 1), MTU):
            chunk = payload[off:off + MTU]
            frame = EthernetFrame(self.ip, dst_ip, chunk).seal()
            frame.seq = self._up_seq
            self._up_seq += 1
            frames.append(frame)
        drv = self._driver
        pending = frames
        for round_no in range(drv.max_retries + 1):
            # "ack" covers consumed AND stashed-out-of-order frames;
            # "dup" means the receiver already holds it — both settle
            # the frame.  "nack"/"lost" leave it for the next round.
            pending = [f for f in pending
                       if drv._deliver_upcall(self.ip, f)
                       not in ("ack", "dup")]
            if not pending:
                return
            drv.stats.retransmits += len(pending)
            wait = drv.costs.retransmit_timeout_us * (1 << round_no)
            drv.stats.backoff_us += wait
            drv.stats.time_us += wait
        raise EtherONError(
            f"upcall delivery from {self.ip} lost {len(pending)} "
            f"frame(s) after {drv.max_retries + 1} rounds")
